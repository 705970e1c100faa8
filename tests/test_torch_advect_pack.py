"""The fused G2P + x pack (blub_tpu_torch/ops/advect_pack.py) on the CPU,
where it takes its plain version: G2P then the x pack.

1. Against the JAX package: its XLA oracles sm_phases.advect_slot_major and
   correct_slot_major, then the x stage of the pack spec
   (test_rebin_overflow_spec._pack_axis_spec), through convert.py. Valid
   bits, slot placement and the dropped and kept counts exact where nothing
   overflows; rel16 positions within one 2^-13 quantum (the oracles' order
   of operations differs in a few places, test_torch_g2p.py); the bf16
   velocity and affine pairs within one bf16 ulp, correct's payload exact.
   With and without solids, and on the mesh's x-windows (their cores
   against the whole grid's).
2. Bit for bit against g2p.*_plain then rebin.pack_plain, on the whole grid
   and on an x-window, 40 and 64 slots too.
3. A substep through the fused phases equals one through G2P and the x pack
   as two calls (LocalPhases and, at world size 1, ShardedPhases).

The kernel itself is held against these plain versions on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from blub_tpu.core.seeding import add_fluid_cube
from blub_tpu.sim import slot_major as jsm
from blub_tpu.sim import table as jtable
from blub_tpu.sim.sm_phases import advect_slot_major, correct_slot_major
from blub_tpu_torch import convert
from blub_tpu_torch.core.types import SimParams, SolverStats
from blub_tpu_torch.ops import advect_pack, g2p, rebin
from blub_tpu_torch.parallel import sharded_sm as ss
from blub_tpu_torch.parallel.world import one_rank_group
from blub_tpu_torch.sim import step_dense
from blub_tpu_torch.sim.slot_major import unpack_dyn, unpack_posq
from blub_tpu_torch.testing import crowded_table, moving_box, x_window
from test_rebin_overflow_spec import _decode, _encode, _pack_axis_spec

# small tensors: one intra-op thread avoids contending with XLA's CPU pool
torch.set_num_threads(1)

_from_table = jax.jit(jsm.from_table)  # one compile per shape (eager: hundreds of op dispatches)

DT = np.float32(1.0 / 120.0)
SMALL, MID = (16, 8, 8), (24, 16, 16)
CASES = {  # name: grid, K, k_out, solids (an XLA compile per case and phase)
    "16x8x8 K=8 solids": (SMALL, 8, 12, True),
    "24x16x16 K=16": (MID, 16, 20, False),
}


def _jax_table(grid, k, seed):
    """A fluid block jiggled off its lattice, random velocity and affine
    pairs: the JAX slot-major table."""
    rng = np.random.default_rng(seed)
    pos = add_fluid_cube(grid, (1, 1, 1), (grid[0] // 2 + 2, grid[1] - 2, grid[2] - 1), 10**9)
    pos = np.clip(pos + rng.uniform(-0.45, 0.45, pos.shape).astype(np.float32), 1.001, np.array(grid) - 1.001)
    tab = jtable.from_positions(pos, grid, k)
    valid = np.asarray(tab.valid)[..., None]
    tab = dataclasses.replace(
        tab,
        vel=jnp.asarray(rng.standard_normal(valid.shape[:-1] + (3,)).astype(np.float32) * 5 * valid),
        affine=jnp.asarray(rng.standard_normal(valid.shape[:-1] + (3, 3)).astype(np.float32) * valid[..., None]),
    )
    return _from_table(tab)


def _faces(rng, grid, scale):
    """Face grids with the border faces zero, as P2G and gridfix leave them."""
    out = []
    for c in range(3):
        g = (rng.standard_normal(grid) * scale).astype(np.float32)
        idx = [slice(None)] * 3
        idx[c] = -1
        g[tuple(idx)] = 0.0
        out.append(g)
    return out


def _marker(rng, grid):
    m = np.where(rng.random(grid) < 0.7, 1, -1).astype(np.int8)
    m[0], m[-1], m[:, 0], m[:, -1], m[:, :, 0], m[:, :, -1] = 0, 0, 0, 0, 0, 0
    return m


def _spec_x(ref, grid, s, k_out):
    """The spec's x pack of a JAX oracle's moved table: -> (posq int32,
    dyn int32, valid, dropped)."""
    z = grid[2]
    pos, valid = _decode(np.asarray(ref.posq)[..., :z])
    dyn = np.asarray(ref.dyn)[..., :z]
    pos, valid, dyn, dropped = _pack_axis_spec(pos, valid, dyn, 0, s, k_out, grid[0])
    return _encode(pos, valid).view(np.int32), np.ascontiguousarray(dyn).view(np.int32), valid, dropped


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """A case's inputs (numpy, from its seed) and the JAX table."""
    grid, k, k_out, solids = CASES[name]
    seed = sum(map(ord, name))
    rng = np.random.default_rng(seed)
    sm = _jax_table(grid, k, seed)
    vel, change, marker = _faces(rng, grid, 60.0), _faces(rng, grid, 0.3), _marker(rng, grid)
    sol = moving_box(grid, (3, 2, 2), (6, 5, 6), (-35.0, 4.0, 2.0)) if solids else None
    return {"sm": sm, "vel": vel, "change": change, "marker": marker, "solids": sol}


_advect = jax.jit(lambda t, v, a, b: advect_slot_major(t, v, a, b, DT))
_correct = jax.jit(correct_slot_major)


@functools.lru_cache(maxsize=None)
def _oracle(name, phase):
    """The JAX phase on the whole grid, then the spec's x pack: -> (the
    phase's table, (posq, dyn, valid, dropped))."""
    grid, k, k_out, solids = CASES[name]
    o = _inputs(name)
    if phase == "advect":
        if solids:
            js = convert.solids_to_jax(o["solids"])
            occ, sv = jnp.asarray(js["occupancy"]), jnp.asarray(js["velocity"])
        else:
            occ = sv = None
        ref = _advect(o["sm"], tuple(map(jnp.asarray, o["vel"])), occ, sv)
        return ref, _spec_x(ref, grid, g2p.ADVECT_SHIFT, k_out)
    ref = _correct(o["sm"], tuple(map(jnp.asarray, o["change"])), jnp.asarray(o["marker"]))
    return ref, _spec_x(ref, grid, g2p.CORRECT_SHIFT, k_out)


def _port_table(sm, grid):
    return convert.table_from_jax(sm.posq, sm.dyn, sm.lost, grid, device="cpu")


def _assert_like_oracle(got, ref, advect, faces=None):
    """got: (posq, dyn, counts) of the port; ref: (posq, dyn, valid,
    dropped) of the oracle. ``faces``: advect's face grids. Each velocity
    and affine term rounds to bf16 (one ulp: 2^-7 of it) after f32 sums in
    another order than the oracle's; an affine term is a difference of two
    interpolations of the faces, so its f32 error is a few ulps of the
    largest face value (4: 2^-22 of it), not of the term."""
    gp, gd, counts = got
    rp, rd, rvalid, dropped = ref
    g = unpack_posq(gp[:, 0], gp[:, 1])
    r = unpack_posq(torch.from_numpy(rp[:, 0]), torch.from_numpy(rp[:, 1]))
    np.testing.assert_array_equal(g[3].numpy() == 1, rvalid)  # valid bits: the placement
    for a in range(3):
        assert (g[a] - r[a]).abs().max().item() <= 1, f"axis {a} differs by more than one quantum"
    assert int(counts[0]) == dropped and int(counts[1]) == int(rvalid.sum())
    if not advect:  # the payload moves unchanged
        np.testing.assert_array_equal(gd.numpy(), rd)
        return
    gv, ga = unpack_dyn([gd[:, c] for c in range(6)])
    rv, ra = unpack_dyn([torch.from_numpy(rd[:, c]) for c in range(6)])
    f32_err = 2.0 ** -22 * max(float(np.abs(f).max()) for f in faces)
    for a, b in zip(gv + ga, rv + ra):
        assert torch.all((a - b).abs() <= 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + f32_err)


@pytest.mark.parametrize("name", list(CASES))
def test_advect_pack_matches_the_oracle(name):
    o = _inputs(name)
    grid, k, k_out, _ = CASES[name]
    t = _port_table(o["sm"], grid)
    sol = o["solids"]
    got = advect_pack.advect_pack(t.posq, [torch.from_numpy(v) for v in o["vel"]], DT,
                                  None if sol is None else sol.occupancy, None if sol is None else sol.velocity,
                                  k_out, with_counts=True)
    adv, spec = _oracle(name, "advect")
    _assert_like_oracle((got[0], got[1], got[3]), spec, advect=True, faces=o["vel"])
    assert got[2].item() == pytest.approx(float(adv.max_speed()), rel=2.0 ** -7)
    assert int(got[3][1]) > 0  # (the K=8 case overflows: placement and counts exact all the same)


@pytest.mark.parametrize("name", list(CASES))
def test_correct_pack_matches_the_oracle(name):
    o = _inputs(name)
    grid, k, k_out, _ = CASES[name]
    t = _port_table(o["sm"], grid)
    got = advect_pack.correct_pack(t.posq, t.dyn, [torch.from_numpy(c) for c in o["change"]],
                                   torch.from_numpy(o["marker"]), k_out, with_counts=True)
    _assert_like_oracle(got, _oracle(name, "correct")[1], advect=False)


@pytest.mark.parametrize("phase", ["advect", "correct"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_windows_match_the_oracle(name, n, phase):
    """The x_start form on each rank's window as the mesh cuts it (the
    table's inner s halo planes real, its outer hx planes zero, the grids
    wrapped by h = s + hx; advect with the case's solids): its core is the
    whole grid's oracle's."""
    o = _inputs(name)
    grid, k, k_out, solids = CASES[name]
    t = _port_table(o["sm"], grid)
    xl = grid[0] // n
    sol = o["solids"] if phase == "advect" else None
    s = g2p.ADVECT_SHIFT if phase == "advect" else g2p.CORRECT_SHIFT
    hx = 2 if sol is not None else 1
    h = s + hx
    rp, rd, rvalid, _ = _oracle(name, phase)[1]
    for x0 in range(0, grid[0], xl):
        def table(a):
            return torch.nn.functional.pad(x_window(a, 2, x0, xl, s, False), (0, 0, 0, 0, hx, hx))

        grids = [x_window(torch.from_numpy(g), 0, x0, xl, h, True)
                 for g in (o["vel"] if phase == "advect" else o["change"])]
        if phase == "advect":
            sw = ((x_window(sol.occupancy, 0, x0, xl, h, True), x_window(sol.velocity, 1, x0, xl, h, True))
                  if sol is not None else (None, None))
            gp, gd, _ = advect_pack.advect_pack(table(t.posq), grids, DT, *sw, k_out, x_start=x0 - h, domain=grid)
        else:
            gp, gd = advect_pack.correct_pack(table(t.posq), table(t.dyn), grids,
                                              x_window(torch.from_numpy(o["marker"]), 0, x0, xl, h, True), k_out,
                                              x_start=x0 - h, domain=grid)
        core = slice(x0, x0 + xl)
        kept = int((unpack_posq(gp[:, 0], gp[:, 1])[3][..., h:h + xl, :, :] == 1).sum())
        _assert_like_oracle((gp.narrow(2, h, xl), gd.narrow(2, h, xl), torch.tensor([0, kept])),
                            (rp[:, :, core], rd[:, :, core], rvalid[:, core], 0), advect=phase == "advect",
                            faces=o["vel"])


# 2. bit for bit against the plain composition (the kernel's oracle)


def _moved_table(grid, k, seed, fill=0.7):
    """A crowded table (every slot of a cell may be valid; with ``fill``
    1.0 every slot is) moved off its bins within the advect's reach."""
    return crowded_table(grid, k, seed, fill=fill, reach=0.5)


@pytest.mark.parametrize("grid,k,k_out,window,fill", [
    (SMALL, 8, 12, None, 0.7), (MID, 16, 17, None, 0.7), (SMALL, 40, 44, None, 0.7), ((8, 8, 8), 60, 64, None, 0.7),
    (SMALL, 16, 6, None, 0.7), (SMALL, 12, 13, (4, 8), 0.7), ((37, 9, 45), 12, 13, None, 0.7),
    ((20, 6, 36), 14, 15, None, 1.0), ((6, 5, 8), 64, 64, None, 1.0), ((24, 8, 8), 12, 13, (6, 12), 0.7)],
    ids=["16x8x8 K=8", "24x16x16 K=16", "K=40", "64 slots", "overflow", "window", "37x9x45", "crowded K=14",
         "crowded 64 slots", "18-plane window"])
def test_fused_is_g2p_then_the_x_pack(grid, k, k_out, window, fill):
    """The whole grid, or (``window``: core planes x0, xl) the x_start form
    on the core of the domain extended by the advect's s = 2 table planes,
    zero-padded by one more, the grids by 3: g2p's and the pack's x_start
    plain versions. The card's edge cases too: x tiles not a multiple of 16
    with Z over 32 and not a multiple of 4, every slot valid at 14 -> 15 and
    at 64 slots, an 18-plane window."""
    rng = np.random.default_rng(k + k_out)
    t = _moved_table(grid, k, k, fill)
    vel = [torch.from_numpy(v) for v in _faces(rng, grid, 150.0)]
    change = [torch.from_numpy(c) for c in _faces(rng, grid, 0.6)]
    marker = torch.from_numpy(_marker(rng, grid))
    sol = moving_box(grid, (3, 2, 2), (6, 5, 6), (-35.0, 4.0, 2.0))
    posq, dyn, xs, dom = t.posq, t.dyn, 0, None
    if window:
        x0, xl = window
        xs, dom = x0 - 3, grid
        posq, dyn = (torch.nn.functional.pad(x_window(a, 2, x0, xl, 2, False), (0, 0, 0, 0, 1, 1)) for a in (posq, dyn))
        vel, change = ([x_window(g, 0, x0, xl, 3, True) for g in grids] for grids in (vel, change))
        marker = x_window(marker, 0, x0, xl, 3, True)
        sol = dataclasses.replace(sol, occupancy=x_window(sol.occupancy, 0, x0, xl, 3, True),
                                  velocity=x_window(sol.velocity, 1, x0, xl, 3, True))
    win = {"x_start": xs, "domain": dom} if window else {}
    for occ, sv in ((None, None), (sol.occupancy, sol.velocity)):
        got = advect_pack.advect_pack(posq, vel, DT, occ, sv, k_out, with_counts=True, **win)
        p, d, ms = g2p.advect_plain(posq, vel, DT, occ, sv, xs, dom)
        ref = rebin.pack_plain(p, d, 0, g2p.ADVECT_SHIFT, k_out, xs, None if dom is None else dom[0])
        assert all(torch.equal(a, b) for a, b in zip(got, (ref[0], ref[1], g2p._sqrt_rn(ms), torch.stack(ref[2:]))))
    got = advect_pack.correct_pack(posq, dyn, change, marker, k_out, with_counts=True, **win)
    ref = rebin.pack_plain(g2p.correct_plain(posq, change, marker, xs, dom), dyn, 0, g2p.CORRECT_SHIFT, k_out, xs,
                           None if dom is None else dom[0])
    assert all(torch.equal(a, b) for a, b in zip(got, (ref[0], ref[1], torch.stack(ref[2:]))))
    if k_out == 6:
        assert int(ref[2]) > 0  # the overflow case drops
    if fill == 1.0:
        assert bool((t.posq[:, 1] & 1).all())  # every slot of every cell valid


# 3. a substep through the fused phases and through the two calls


def _state(grid, k):
    """A crowded table (velocities random) from rest, pressures zero."""
    t = _moved_table(grid, k, 7)
    params = SimParams(grid_dim=grid, dt=float(DT), gravity_grid=(0.0, -981.0, 0.0),
                       num_particles=int(t.num_particles()))
    zero = torch.zeros(grid, dtype=torch.float32)
    return params, step_dense.DenseFluidState(
        table=t, pressure_vel=zero, pressure_den=zero.clone(), step_index=torch.zeros((), dtype=torch.int32),
        stats_vel=SolverStats.zero("cpu"), stats_den=SolverStats.zero("cpu"),
        max_speed=torch.zeros((), dtype=torch.float32))


class _Unfused(step_dense.LocalPhases):
    """G2P, then the x pack, as two calls (the phases before the fusion)."""

    def advect_pack(self, posq, vel, dt, occupancy, solid_vel, k_mid):
        p, d, ms = g2p.advect(posq, vel, dt, occupancy, solid_vel)
        return rebin.pack(p, d, 0, g2p.ADVECT_SHIFT, k_mid)[:2] + (ms,)

    def correct_pack(self, posq, dyn, change, marker, k_mid):
        return rebin.pack(g2p.correct(posq, change, marker), dyn, 0, g2p.CORRECT_SHIFT, k_mid)[:2]


def _bits(state):
    return [state.table.posq, state.table.dyn, state.table.lost, state.pressure_vel, state.pressure_den,
            state.max_speed, state.stats_vel.iterations, state.stats_den.error]


@pytest.mark.parametrize("solids", [False, True])
def test_a_fused_substep_equals_an_unfused_one(solids):
    params, state = _state(SMALL, 16)
    sol = moving_box(SMALL, (3, 2, 2), (6, 5, 6), (-35.0, 4.0, 2.0)) if solids else None
    fused = step_dense.step_core(params, state, DT, sol)
    plain = step_dense.step_core(params, state, DT, sol, phases=_Unfused(params))
    assert all(torch.equal(a, b) for a, b in zip(_bits(fused), _bits(plain)))


class _UnfusedSharded(ss.ShardedPhases):
    """The mesh's G2P on the slab, then its x pack, as two calls."""

    def advect_pack(self, posq, vel, dt, occupancy, solid_vel, k_mid):
        p, d, ms = ss.advect_sharded(self.ctx, posq, vel, dt, occupancy, solid_vel, self.domain)
        return ss.pack_x_sharded(self.ctx, p, d, g2p.ADVECT_SHIFT, k_mid, self.domain) + (ms,)

    def correct_pack(self, posq, dyn, change, marker, k_mid):
        p = ss.correct_sharded(self.ctx, posq, change, marker, self.domain)
        return ss.pack_x_sharded(self.ctx, p, dyn, g2p.CORRECT_SHIFT, k_mid, self.domain)


def test_a_fused_mesh_substep_equals_an_unfused_one():
    """At world size 1 (gloo, this process): ShardedPhases with the fused
    x-window phases, with the two calls, and step_core on the whole grid."""
    params, state = _state(SMALL, 12)
    one_rank_group(torch.device("cpu"))
    try:
        ctx = ss.ShardCtx.from_group("cpu")
        slab = ss.shard_sm_state(ctx, state)
        fused = step_dense.step_core(params, slab, DT, phases=ss.ShardedPhases(params, ctx))
        plain = step_dense.step_core(params, slab, DT, phases=_UnfusedSharded(params, ctx))
    finally:
        dist.destroy_process_group()
    whole = step_dense.step_core(params, state, DT)
    for got in (fused, plain):
        assert all(torch.equal(a, b) for a, b in zip(_bits(got), _bits(whole)))
