"""The rank side of tests/test_torch_sharded.py: what every rank of a
spawned gloo world runs (``parallel/world.run_world``). JAX-free, so the
spawned processes import only torch and the port."""

import numpy as np
import torch

from blub_tpu_torch import convert
from blub_tpu_torch.core.config import SimSettings, SolverConfig, scenes_dir
from blub_tpu_torch.core.seeding import add_fluid_cube
from blub_tpu_torch.core.types import SimParams, SolidState
from blub_tpu_torch.ops import g2p, p2g, rebin
from blub_tpu_torch.parallel import sharded_sm as ss
from blub_tpu_torch.sim.quality import density_drift, physics_quality
from blub_tpu_torch.sim.step_dense import make_dense_state, stage_slack
from blub_tpu_torch.testing import random_table, x_window

GRID = (32, 8, 8)
K = 8
DT = np.float32(1.0 / 120.0)
# capped solves (tolerance 0) of an odd and an even iteration count: the
# slab solve's r and s pairs end on either parity
PCG_CONFIGS = (SolverConfig(error_tolerance=0.0, max_num_iterations=7),
               SolverConfig(error_tolerance=0.0, max_num_iterations=8))


def dam(k=K):
    """The JAX test's state: add_fluid_cube((1,1,1), (16,5,7)) at 32x8x8."""
    pos = add_fluid_cube(GRID, (1, 1, 1), (16, 5, 7), 10**9)
    params = SimParams(grid_dim=GRID, dt=float(DT), gravity_grid=(0.0, -981.0, 0.0), num_particles=pos.shape[0])
    return params, pos, make_dense_state(params, pos, k, device="cpu")


def seam_solid():
    """occ[14:18, 2:5, 2:6] moving at vx 30: it spans the seam at x = 16."""
    occ = torch.zeros(GRID)
    occ[14:18, 2:5, 2:6] = 1.0
    vel = torch.zeros((3,) + GRID)
    vel[0, 14:18, 2:5, 2:6] = 30.0
    return SolidState(occupancy=occ, velocity=vel)


def fields(seed):
    """Random face grids (x40), a sparse occupancy with solid velocity,
    change grids (x0.3) and a marker."""
    rng = np.random.default_rng(seed)
    vel = [torch.from_numpy((rng.standard_normal(GRID) * 40).astype(np.float32)) for _ in range(3)]
    occ = torch.from_numpy((rng.random(GRID) > 0.93).astype(np.float32))
    sv = torch.from_numpy((rng.standard_normal((3,) + GRID) * 5).astype(np.float32)) * occ
    change = [torch.from_numpy((rng.standard_normal(GRID) * 0.3).astype(np.float32)) for _ in range(3)]
    marker = torch.from_numpy(rng.integers(-1, 2, GRID).astype(np.int8))
    return vel, occ, sv, change, marker


def _slab(a, x0, xl, dim):
    return a.narrow(dim, x0, xl)


def wrapper_checks(ctx):
    """Each sharded wrapper against the unsharded phase on this rank's slab:
    name -> whether the bits are equal."""
    x0, xl = ctx.x_slab(GRID[0])
    t = random_table(GRID, K, seed=0, hi=(30, 6, 7))
    vel, occ, sv, change, marker = fields(1)
    k_mid = K + stage_slack(GRID, K)
    lost = torch.zeros((), dtype=torch.int32)
    n0 = t.num_particles()
    sl = [_slab(v, x0, xl, 0).contiguous() for v in vel]
    ch = [_slab(c, x0, xl, 0).contiguous() for c in change]
    occ_s, sv_s, mk_s = (_slab(occ, x0, xl, 0).contiguous(), _slab(sv, x0, xl, 1).contiguous(),
                         _slab(marker, x0, xl, 0).contiguous())
    pq, dy = _slab(t.posq, x0, xl, 2).contiguous(), _slab(t.dyn, x0, xl, 2).contiguous()
    out = {}

    def same(name, got, ref, dim):
        out[name] = bool(torch.equal(got, _slab(ref, x0, xl, dim)))

    same("p2g_raw", ss.p2g_raw_accumulators_sharded(ctx, pq, dy), p2g.p2g(t.posq, t.dyn), 1)
    same("p2g_density", ss.p2g_density_sharded(ctx, pq), p2g.p2g(t.posq, None, density=True), 1)
    for solid in (False, True):
        o, v = (occ, sv) if solid else (None, None)
        os_, vs = (occ_s, sv_s) if solid else (None, None)
        rp, rd, rms = g2p.advect(t.posq, vel, DT, o, v)
        gp, gd, gms = ss.advect_sharded(ctx, pq, sl, DT, os_, vs, GRID)
        tag = "_solids" if solid else ""
        same("advect_posq" + tag, gp, rp, 2)
        same("advect_dyn" + tag, gd, rd, 2)
        out["advect_max_speed" + tag] = bool(torch.equal(gms, rms))
        mp, md, mms = g2p.advect(t.posq, vel, DT, o, v)
        mp, md, _, _ = rebin.pack(mp, md, 0, g2p.ADVECT_SHIFT, k_mid)
        fp, fd, fms = ss.advect_pack_sharded(ctx, pq, sl, DT, os_, vs, k_mid, GRID)
        same("advect_pack_posq" + tag, fp, mp, 2)
        same("advect_pack_dyn" + tag, fd, md, 2)
        out["advect_pack_max_speed" + tag] = bool(torch.equal(fms, mms))
    rp, rd, _ = g2p.advect(t.posq, vel, DT)
    rebin_ref = rebin.rebin_slot_major(rp, rd, g2p.ADVECT_SHIFT, k_mid - K, lost)
    gp, gd, _ = ss.advect_sharded(ctx, pq, sl, DT, None, None, GRID)
    rebin_got = ss.rebin_sharded(ctx, gp, gd, g2p.ADVECT_SHIFT, k_mid, lost, n0, GRID)
    same("rebin_posq", rebin_got[0], rebin_ref[0], 2)
    same("rebin_dyn", rebin_got[1], rebin_ref[1], 2)
    out["rebin_lost"] = int(rebin_got[2]) == int(rebin_ref[2])
    mp, md, _, _ = rebin.pack(rp, rd, 0, g2p.ADVECT_SHIFT, k_mid)
    yz_ref = rebin.rebin_yz(mp, md, g2p.ADVECT_SHIFT, K, lost, n0)
    yz_got = ss.rebin_yz_sharded(ctx, _slab(mp, x0, xl, 2).contiguous(), _slab(md, x0, xl, 2).contiguous(),
                                 g2p.ADVECT_SHIFT, K, lost, n0)
    same("rebin_yz_posq", yz_got[0], yz_ref[0], 2)
    same("rebin_yz_dyn", yz_got[1], yz_ref[1], 2)
    out["rebin_yz_lost"] = int(yz_got[2]) == int(yz_ref[2])
    yp, yd = yz_ref[0], yz_ref[1]
    sp, sd = _slab(yp, x0, xl, 2).contiguous(), _slab(yd, x0, xl, 2).contiguous()
    same("correct", ss.correct_sharded(ctx, sp, ch, mk_s, GRID), g2p.correct(yp, change, marker), 2)
    cp = g2p.correct(yp, change, marker)
    cp, cd, _, _ = rebin.pack(cp, yd, 0, g2p.CORRECT_SHIFT, k_mid)
    gp, gd = ss.correct_pack_sharded(ctx, sp, sd, ch, mk_s, k_mid, GRID)
    same("correct_pack_posq", gp, cp, 2)
    same("correct_pack_dyn", gd, cd, 2)
    # a whole state to the slabs and back
    _, _, state = dam()
    back = ss.gather_sm_state(ctx, ss.shard_sm_state(ctx, state))
    out["gather_round_trip"] = all(torch.equal(a, b) for a, b in (
        (back.table.posq, state.table.posq), (back.table.dyn, state.table.dyn),
        (back.pressure_vel, state.pressure_vel))) and back.table.grid_dim == state.table.grid_dim
    return out


def pcg_problem(seed=11):
    """(marker, rhs, p0) in numpy: 85 % fluid at random inside a SOLID
    border, rhs x30 on fluid cells, a random warm start."""
    rng = np.random.default_rng(seed)
    marker = np.where(rng.random(GRID) < 0.85, 1, -1).astype(np.int8)
    marker[0], marker[-1], marker[:, 0], marker[:, -1], marker[:, :, 0], marker[:, :, -1] = 0, 0, 0, 0, 0, 0
    rhs = np.where(marker == 1, rng.standard_normal(GRID) * 30, 0).astype(np.float32)
    return marker, rhs, rng.standard_normal(GRID).astype(np.float32)


def pcg_solves(ctx):
    """solve_pressure_sharded of pcg_problem on this rank's slab, for each of
    PCG_CONFIGS: -> [(the gathered pressure, iterations)]."""
    x0, xl = ctx.x_slab(GRID[0])
    marker, rhs, p0 = (torch.from_numpy(a) for a in pcg_problem())
    mx = x_window(marker, 0, x0, xl, 1, False)
    out = []
    for cfg in PCG_CONFIGS:
        res = ss.solve_pressure_sharded(ctx, _slab(p0, x0, xl, 0).contiguous(), _slab(rhs, x0, xl, 0).contiguous(),
                                        mx, cfg, DT)
        out.append((torch.cat(ctx.all_gather(res.pressure.contiguous()), dim=0).numpy(), int(res.stats.iterations)))
    return out


def summary(ctx, state):
    """Gathered sorted positions, count, lost and max speed (a readback)."""
    pos, _ = ss.gather_particles(ctx, state.table)
    count = int(ctx.all_reduce(state.table.num_particles().reshape(1).clone()).item())
    return {"pos": np.sort(pos.numpy(), axis=0), "count": count, "lost": int(state.table.lost),
            "max_speed": float(state.max_speed)}


def _merge(acc, tally):
    for kind, e in tally.items():
        a = acc.setdefault(kind, {"calls": 0, "bytes": 0, "max_bytes": 0})
        a["calls"] += e["calls"]
        a["bytes"] += e["bytes"]
        a["max_bytes"] = max(a["max_bytes"], e["max_bytes"])


def steps(ctx, s, params, n, solids=None, tally=None):
    """n sharded steps from the slab state ``s``; -> the summary after each
    (the tally of the steps alone, gathers excluded, into ``tally``)."""
    out = []
    for _ in range(n):
        ctx.reset_tally()
        s = ss.step_dense_sharded(params, ctx, s, solids)
        if tally is not None:
            _merge(tally, ctx.tally)
        out.append(summary(ctx, s))
    return out


def scene_frames(ctx, n_frames):
    """Scene(mesh=n) on scenes/mini_dam.json: n0, and per frame the
    gathered positions, count and lost."""
    from blub_tpu_torch.runtime.scene import Scene

    scene = Scene(scenes_dir() / "mini_dam.json", SimSettings(), device="cpu", mesh=ctx.n)
    n0 = scene.num_particles()
    out = []
    for _ in range(n_frames):
        scene.step()
        out.append({"pos": np.sort(scene.particle_positions(), axis=0), "count": scene.num_particles(),
                    "lost": scene.solver_stats()["lost_particles"]})
    return n0, out


def frame(ctx, state, params):
    """One frame_dense_sharded frame from the slab state with its max speed
    set to 300 grid/s (n_sub 2 at CFL 1.9): the returned n_sub (its type,
    shape and value) beside substep_count_device of that speed, and the
    substeps the frame took."""
    from blub_tpu_torch.sim.step_dense import substep_count_device

    state.max_speed = torch.tensor(300.0)
    want = int(substep_count_device(params, state.max_speed, 1.9, 4))
    before = int(state.step_index)
    out, n_sub = ss.frame_dense_sharded(params, ctx, state, None, 1.9, 4)
    return {"dtype": str(n_sub.dtype), "dim": n_sub.dim(), "n_sub": int(n_sub), "expected": want,
            "substeps": int(out.step_index) - before}


def quality(ctx, params, leaves):
    """physics_quality and the unrounded density_drift of this rank's slab
    of a whole state (``leaves``: ``convert.state_leaves``), through
    ShardedPhases: every rank's numbers are the whole grid's."""
    slab = ss.shard_sm_state(ctx, convert.state_from_leaves(leaves, GRID, device="cpu"))
    phases = ss.ShardedPhases(params, ctx)
    d = density_drift(slab.table, phases)
    return {"quality": physics_quality(slab, params.solver_vel.error_tolerance, phases),
            "interior": int(d.interior), "mean": float(d.mean), "max": float(d.max)}


def run(rank, n, device, jax_k16, drift_steps, scene, quality_leaves):
    """Every check of one world: the wrappers, 3 steps at K=8 and, from
    ``jax_k16`` (the JAX package's initial state at K=16, numpy fields for
    ``convert.slab_state_from_jax``), at K=16, one frame's n_sub, one step
    with the seam-spanning solid, the steps' collective tally,
    ``drift_steps`` steps with the solid, (``scene``) 2 Scene frames, the
    slab PCG solves of ``pcg_solves`` and the physics quality of the state
    ``quality_leaves``.
    Rank 0 returns the results (every rank runs the same checks)."""
    ctx = ss.ShardCtx.from_group(device)
    res = {"wrappers": wrapper_checks(ctx), "tally": {}, "pcg": pcg_solves(ctx)}
    params, _, state = dam()
    res["quality"] = quality(ctx, params, quality_leaves)
    res["steps_k8"] = steps(ctx, ss.shard_sm_state(ctx, state), params, 3, tally=res["tally"])
    res["frame"] = frame(ctx, ss.shard_sm_state(ctx, state), params)
    params16, _, _ = dam(16)
    slab16 = convert.slab_state_from_jax(**jax_k16, rank=ctx.rank, n=ctx.n, device="cpu")
    res["steps_k16"] = steps(ctx, slab16, params16, 3)
    res["solid_step"] = steps(ctx, ss.shard_sm_state(ctx, state), params, 1, seam_solid())
    res["drift"] = steps(ctx, ss.shard_sm_state(ctx, state), params, drift_steps, seam_solid()) if drift_steps else []
    if scene:
        res["scene"] = scene_frames(ctx, 2)
    return res if rank == 0 else None
