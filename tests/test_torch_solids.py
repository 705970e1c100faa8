"""The port's solids path against the JAX package's XLA code, at 24x16x16
with the piston of tests/test_solids.py (a cube entering from +x).

- scene loading and seeding for every scenes/*.json: exact;
- the wavegenerator bake (build_solid_objects): sdf within 1e-5 voxel;
- voxelize_step, translated and rotated: occupancy exact apart from cells
  whose JAX field lies within 1e-6 of the 0.5 iso (f32 rounding of the
  blend), velocity f32-close;
- both markers exact; divergence RHS and gridfix remove with solid velocity
  f32-close;
- G2P advect with solids against sm_phases.advect_slot_major: valid bits
  exact, positions within one 2^-13 quantum, bf16 pairs within one ulp (a
  penetrating particle's velocity is a position difference over dt, so its
  near-zero components also get one f32 position ulp over dt); the escape,
  the occupancy penetration and the push each change the result;
- one substep of step_core against step_dense on the "pt" layout with the
  same SolidState: counts, lost and marker exact, sorted per-cell positions
  within one quantum, pressures close;
- the port's Scene on the CPU: conservation, no NaN, under 2 % of the
  particles inside the solid, reset;
- the velocity solve of each of 3 frames of the port's eager Scene against
  the JAX Scene's dense frame: iterations equal, exit error within 3 %.

- the Scene's table of every split's animation parameters against the JAX
  Scene's ``_solid_params_stacked`` on scenes/wavegenerator.json: equal.

The expensive oracles (XLA compiles, both bakes, every scene's seeding) start
together on a thread pool when the module's first test asks for them; numpy
and XLA's compiler release the interpreter lock, so they overlap. The port's
own Scene run comes last, when the pool is idle. G2P with solids on both z
walls is held against the oracle in tests/test_torch_g2p.py."""

import dataclasses
import pathlib
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blub_tpu.core import config as jconfig
from blub_tpu.core import models as jmodels
from blub_tpu.core import seeding as jseeding
from blub_tpu.core.types import SimParams as JaxSimParams
from blub_tpu.core.types import SolidState as JaxSolidState
from blub_tpu.sim import slot_major as jsm
from blub_tpu.sim import voxelize as jvox
from blub_tpu.sim.dense_transfer import marker_from_table
from blub_tpu.sim.divergence import compute_divergence_rhs as jax_div_rhs
from blub_tpu.sim.divergence import remove_divergence as jax_remove
from blub_tpu.sim.extrapolate import extrapolate_velocity as jax_extrapolate
from blub_tpu.sim.sm_phases import advect_slot_major
from blub_tpu.sim.sm_phases import marker_from_counts as jax_marker
from blub_tpu.sim.step_dense import make_dense_state as jax_make_state
from blub_tpu.sim.step_dense import step_dense
from blub_tpu_torch import convert
from blub_tpu_torch.core import config
from blub_tpu_torch.core.models import build_solid_objects
from blub_tpu_torch.core.seeding import seed_scene
from blub_tpu_torch.core.types import SimParams, SolidState
from blub_tpu_torch.ops import g2p, gridfix, p2g
from blub_tpu_torch.runtime.scene import Scene
from blub_tpu_torch.sim.divergence import compute_divergence_rhs
from blub_tpu_torch.sim.slot_major import unpack_dyn, unpack_posq
from blub_tpu_torch.sim.sm_phases import marker_from_counts
from blub_tpu_torch.sim.step_dense import step_core
from blub_tpu_torch.sim.voxelize import rotating_flags, solid_params_at, voxelize_step
from blub_tpu_torch.testing import moving_box, random_table

# small tensors: one intra-op thread avoids contending with XLA's CPU pool
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SCENES = sorted((REPO / "scenes").glob("*.json"))
G = (24, 16, 16)
K = 16
DT = 1.0 / 120.0
QUANTUM = 2.0 ** -13


def _v(x, y, z):
    return {"x": x, "y": y, "z": z}


def _scene_dict(objects, cubes, dim=G, max_particles=10**7):
    return {
        "gravity": _v(0.0, -9.81, 0.0),
        "fluid": {
            "world_position": _v(0.0, 0.0, 0.0), "grid_to_world_scale": 0.01, "grid_dimension": _v(*dim),
            "max_num_particles": max_particles,
            "fluid_cubes": [{"min": _v(*c[:3]), "max": _v(*c[3:])} for c in cubes],
        },
        "static_objects": objects,
    }


def _piston(duration=0.2, x0=0.24, x1=0.12, scale=0.08):
    """tests/test_solids.py::_piston: a cube entering from +x."""
    return {
        "model": "cube.obj", "world_position": _v(x0, 0.0, 0.0), "scale": scale,
        "rotation_angles": _v(0.0, 0.0, 0.0),
        "animation": {"translation": {"target": _v(x1, 0.0, 0.0), "curve": "Linear", "duration": duration}},
    }


# the piston over a pool that reaches the +x wall, so it enters the fluid;
# the pool keeps clear of the -x wall, where the port's push gradient (cyclic
# in x, as sm_phases') reads the piston across the domain and the "pt"
# oracle's zero-filled one does not (ROADMAP section 3), and of the top z
# cells
PISTON = _scene_dict([_piston()], [(0.04, 0.0, 0.0, 0.24, 0.06, 0.14)])
# tests/test_solids.py::test_runtime_rotation_voxelization: an elongated box
# off its origin, rotating about +y at 90 deg/s
ROTATING = _scene_dict(
    [{
        "model": "cube.obj", "world_position": _v(0.12, 0.06, 0.08), "scale": 0.07,
        "rotation_angles": _v(0.0, 0.0, 0.0),
        "animation": {"rotation": {"axis": _v(0.0, 1.0, 0.0), "deg_per_sec": 90.0}},
    }],
    [], dim=(32, 16, 16), max_particles=8,
)
# the piston on its way back, face at x = 18, moving +x at 60 cells/s: the
# particles it holds escape toward the wall, so no cell overflows K (overflow
# victims differ between the "pt" rebin and the pack)
STEP_T = 0.3


def _both(d):
    return config.load_scene_dict(d, "t"), jconfig.load_scene_dict(d, "t")


def _jax_solids(objs, t, dt, grid):
    sh, vt, om, ct, q, o0 = jvox.solid_params_at(objs, t, dt)
    s = jvox.voxelize_step(
        [jnp.asarray(o.sdf) for o in objs], tuple(o.pad_lo for o in objs), jnp.asarray(sh), jnp.asarray(vt),
        jnp.asarray(om), jnp.asarray(ct), grid, rot_q=jnp.asarray(q), origins0=jnp.asarray(o0),
        rotating=jvox.rotating_flags(objs),
    )
    field = None
    if objs[0].has_runtime_rotation:
        field = jvox.resample_sdf_rotated(
            jnp.asarray(objs[0].sdf), objs[0].pad_lo, jnp.asarray(q[0]), jnp.asarray(ct[0]), jnp.asarray(o0[0]), grid
        )
    else:
        field = jvox.resample_sdf(jnp.asarray(objs[0].sdf), objs[0].pad_lo, jnp.asarray(sh[0]), grid)
    return np.asarray(s.occupancy), np.asarray(s.velocity), np.asarray(field)


def _advect_inputs():
    """A jiggled pool with random velocities and affine rows, two moving
    boxes inside it (clear of the z walls; one escapes toward -x, the other
    toward +z), and random face grids."""
    rng = np.random.default_rng(300)
    table = random_table(G, 8, 0, hi=(20, 12, 14))
    a = moving_box(G, (4, 2, 2), (9, 9, 13), (-35.0, 4.0, 2.0))
    b = moving_box(G, (12, 2, 2), (17, 9, 13), (3.0, -2.0, 41.0))
    solids = SolidState(occupancy=torch.maximum(a.occupancy, b.occupancy),
                        velocity=torch.where(b.occupancy > 0, b.velocity, a.velocity))
    faces = []
    for c in range(3):
        f = (rng.standard_normal(G) * 60.0).astype(np.float32)
        idx = [slice(None)] * 3
        idx[c] = -1
        f[tuple(idx)] = 0.0
        faces.append(torch.from_numpy(f))
    return table, solids, faces


def _run_jax_advect(fn, table, solids, faces):
    t = convert.table_to_jax(table)
    sm = jsm.SlotMajorTable(
        posq=jnp.asarray(t["posq"]), dyn=jnp.asarray(t["dyn"]), lost=jnp.int32(t["lost"]), grid_dim=G
    )
    s = convert.solids_to_jax(solids)
    out = fn(sm, tuple(jnp.asarray(f.numpy()) for f in faces), jnp.asarray(s["occupancy"]),
             jnp.asarray(s["velocity"]), jnp.float32(DT))
    return convert.table_from_jax(out.posq, out.dyn, out.lost, G, device="cpu")


def _step_inputs():
    """The piston scene seeded, its SolidState at STEP_T (voxelized by the
    port, in the JAX layout) and the JAX initial "pt" state; -> (params,
    positions, state, (occupancy, velocity))."""
    jcfg = jconfig.load_scene_dict(PISTON, "t")
    pos = jseeding.seed_scene(jcfg)
    params = JaxSimParams.from_scene(jcfg, jconfig.SimSettings(), num_particles=pos.shape[0])
    objs = build_solid_objects(config.load_scene_dict(PISTON, "t"), device="cpu")
    sh, vt, om, ct, q, o0 = solid_params_at(objs, STEP_T, DT)
    solids = convert.solids_to_jax(voxelize_step([torch.from_numpy(o.sdf) for o in objs], [o.pad_lo for o in objs],
                                                 sh, vt, om, ct, G))
    state = jax_make_state(params, pos, capacity=K, layout="pt")
    return params, pos, state, (solids["occupancy"], solids["velocity"])


def _step_oracle(inputs):
    """JAX: one step_dense on the "pt" layout from rest with the piston."""
    params, _, state, (occ, vel) = inputs.result()
    solids = JaxSolidState(occupancy=jnp.asarray(occ), velocity=jnp.asarray(vel))
    return jax.block_until_ready(jax.jit(partial(step_dense, params))(state, solids))


def _grid_oracles():
    """JAX marker, divergence RHS and remove + extrapolate on seeded grids."""
    rng = np.random.default_rng(7)
    solids = moving_box(G, (11, 0, 0), (24, 9, 16), (-35.0, 3.0, -1.0))
    occ = solids.occupancy.numpy()
    sv = convert.solids_to_jax(solids)["velocity"]
    counts = (rng.random(G) < 0.6).astype(np.float32) * rng.integers(1, 9, G).astype(np.float32)
    vel = [rng.standard_normal(G).astype(np.float32) * 10 for _ in range(3)]
    p = rng.standard_normal(G).astype(np.float32) * 3

    @jax.jit
    def oracle(counts, occ, vel, p, sv):
        marker = jax_marker(counts, G, occ)
        rhs = jax_div_rhs(vel, marker, sv)
        return marker, rhs, jax_extrapolate(jax_remove(vel, p, marker, sv), marker)

    marker, rhs, fixed = oracle(*(jnp.asarray(a) for a in (counts, occ)), tuple(jnp.asarray(v) for v in vel),
                                jnp.asarray(p), jnp.asarray(sv))
    inputs = dict(solids=solids, counts=counts, vel=vel, p=p)
    return inputs, np.asarray(marker), np.asarray(rhs), [np.asarray(f) for f in fixed]


SOLVE_FRAMES = 3


def _frame_solves(scene):
    """SOLVE_FRAMES frames of a Scene: each frame's velocity solve (the last
    substep's), as (iterations, error)."""
    out = []
    for _ in range(SOLVE_FRAMES):
        scene.step()
        v = scene.solver_stats()["velocity"]
        out.append((int(v["iterations"]), float(v["error"])))
    return out


def _jax_frame_solves():
    """JAX's Scene on the piston (its jitted dense frame, the "pt" layout's
    XLA code on the CPU, solids voxelized per substep)."""
    from blub_tpu.runtime.scene import Scene as JaxScene

    return _frame_solves(JaxScene(jconfig.load_scene_dict(PISTON, "t"), capacity=K))


def _seed_key(path):
    """Scenes whose seeding inputs agree seed the same particles."""
    cfg = jconfig.load_scene(path)
    return cfg.fluid.grid_dimension, cfg.fluid_cubes_grid(), cfg.fluid.max_num_particles


VOXELIZE_CASES = [(PISTON, G, t) for t in (0.05, 0.1, 0.3)] + [(ROTATING, (32, 16, 16), t) for t in (0.37, 1.0)]


@pytest.fixture(scope="module")
def prep():
    """Every expensive oracle, started together on a thread pool."""
    pool = ThreadPoolExecutor(max_workers=6)

    def advect():
        return _run_jax_advect(jax.jit(advect_slot_major), *_advect_inputs())

    def voxelize(d, grid, t):
        return _jax_solids(jmodels.build_solid_objects(jconfig.load_scene_dict(d, "t")), t, DT, grid)

    # the XLA compiles and the largest seedings (GIL-free numpy) first
    step_inputs = pool.submit(_step_inputs)
    futures = {"step_inputs": step_inputs, "step": pool.submit(_step_oracle, step_inputs),
               "advect": pool.submit(advect)}
    seeds = {}
    for f in sorted(SCENES, key=lambda f: -np.prod(jconfig.load_scene(f).fluid.grid_dimension)):
        key = _seed_key(f)
        if key not in seeds:
            seeds[key] = (pool.submit(lambda f=f: seed_scene(config.load_scene(f))),
                          pool.submit(lambda f=f: jseeding.seed_scene(jconfig.load_scene(f))))
        futures[f.name] = seeds[key]
    futures.update(
        grid=pool.submit(_grid_oracles),
        bake=pool.submit(lambda: jmodels.build_solid_objects(jconfig.load_scene(REPO / "scenes/wavegenerator.json"))),
        port_bake=pool.submit(lambda: build_solid_objects(config.load_scene(REPO / "scenes/wavegenerator.json"),
                                                         device="cpu")),
        voxelize={(id(d), t): pool.submit(voxelize, d, grid, t) for d, grid, t in VOXELIZE_CASES},
        frames=pool.submit(_jax_frame_solves),
    )
    yield futures
    pool.shutdown(wait=True)


def _sorted_cells(pos, valid):
    out = {}
    for cell in np.ndindex(G):
        r = pos[cell][valid[cell]]
        out[cell] = r[np.lexsort(r.T[::-1])]
    return out


def test_one_substep_with_solids_matches_jax(prep):
    _, pos, init, (occ, vel) = prep["step_inputs"].result()
    start, solids = convert.dense_state_from_jax(
        dataclasses.replace(init, table=jsm.from_table(init.table)),
        JaxSolidState(occupancy=occ, velocity=vel), device="cpu",
    )
    params = SimParams.from_scene(config.load_scene_dict(PISTON, "t"), num_particles=pos.shape[0])
    assert params.has_solids and occ[18:, :8, :8].all()
    state = step_core(params, start, np.float32(DT), solids)
    ref = prep["step"].result()
    assert state.table.num_particles().item() == int(ref.table.num_particles())
    assert state.table.lost.item() == int(ref.table.lost) == 0
    out = convert.table_to_jax(state.table)
    got = jsm.to_table(jsm.SlotMajorTable(
        posq=jnp.asarray(out["posq"]), dyn=jnp.asarray(out["dyn"]), lost=jnp.int32(out["lost"]), grid_dim=G
    ))
    a = _sorted_cells(np.asarray(got.pos), np.asarray(got.valid))
    b = _sorted_cells(np.asarray(ref.table.pos), np.asarray(ref.table.valid))
    for cell in a:
        assert a[cell].shape == b[cell].shape, cell
        if len(a[cell]):
            assert np.abs(a[cell] - b[cell]).max() <= QUANTUM + 1e-6, cell
    marker = marker_from_counts(p2g.p2g(state.table.posq, state.table.dyn)[6], G, solids.occupancy)
    np.testing.assert_array_equal(marker.numpy(), np.asarray(marker_from_table(ref.table, jnp.asarray(occ))))
    for got_p, ref_p in ((state.pressure_vel, ref.pressure_vel), (state.pressure_den, ref.pressure_den)):
        ref_p = np.asarray(ref_p)
        np.testing.assert_allclose(got_p.numpy(), ref_p, rtol=1e-3, atol=1e-3 * np.abs(ref_p).max())
    for got_s, ref_s in ((state.stats_vel, ref.stats_vel), (state.stats_den, ref.stats_den)):
        assert got_s.iterations.dtype == torch.int32 and got_s.iterations.dim() == 0
        assert int(got_s.iterations) == int(ref_s.iterations)
    # the piston holds part of the pool
    cells = np.floor(pos).astype(int)
    assert (occ[cells[:, 0], cells[:, 1], cells[:, 2]] > 0).sum() > 1000


@pytest.mark.parametrize("path", SCENES, ids=[p.name for p in SCENES])
def test_load_and_seed_scene(prep, path):
    assert dataclasses.asdict(config.load_scene(path)) == dataclasses.asdict(jconfig.load_scene(path))
    mine, ref = (f.result() for f in prep[path.name])
    assert mine.dtype == np.float32 and mine.shape == ref.shape
    np.testing.assert_array_equal(mine, ref)


def test_wavegenerator_bake(prep):
    (mine,), (ref,) = prep["port_bake"].result(), prep["bake"].result()
    assert mine.sdf.shape == ref.sdf.shape == (159, 67, 67)
    assert mine.pad_lo == ref.pad_lo == (1, 1, 1)
    np.testing.assert_allclose(mine.sdf, ref.sdf, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(mine.mesh_verts, ref.mesh_verts)
    np.testing.assert_array_equal(mine.mesh_faces, ref.mesh_faces)
    assert mine.standin is None and ref.standin is None


@pytest.mark.parametrize("t0", [0.3, 0.79, 1.6])
def test_splits_table_matches_jax(prep, t0):
    """The Scene's table of every split's animation parameters (what the
    frame graph reads its substeps' solids from) against the JAX package's
    Scene._solid_params_stacked on scenes/wavegenerator.json: every [n-1, s]
    row equal in f32. Both methods read only the scene's solid objects and
    time, so they run on stand-ins for the Scenes (whole scenes seed 1.2M
    particles)."""
    from types import SimpleNamespace

    from blub_tpu.runtime.scene import Scene as JaxScene
    from blub_tpu_torch.runtime.scene import _PARAM_SLICES, _PARAM_WIDTH

    maxn = 4
    port_objs, jax_objs = prep["port_bake"].result(), prep["bake"].result()
    host = np.zeros((maxn, maxn, len(port_objs), _PARAM_WIDTH), np.float32)
    Scene._fill_params(SimpleNamespace(solid_objects=port_objs), host, t0, DT)
    ref = JaxScene._solid_params_stacked(SimpleNamespace(solid_objects=jax_objs, total_simulated_time=t0), DT, maxn)
    assert len(ref) == len(_PARAM_SLICES)
    for (a, b), r in zip(_PARAM_SLICES.values(), ref):
        r = np.asarray(r, np.float32).reshape(maxn, maxn, len(jax_objs), b - a)
        for n in range(1, maxn + 1):
            np.testing.assert_array_equal(host[n - 1, :n, :, a:b], r[n - 1, :n])
    assert np.abs(host[..., 3:6]).max() > 1.0  # the piston moves at these times


def _assert_voxelized(prep, scene, port_objs, t, grid):
    occ_ref, vel_ref, field_ref = prep["voxelize"][(id(scene), t)].result()
    sh, vt, om, ct, q, o0 = solid_params_at(port_objs, t, DT)
    sdfs = [torch.from_numpy(o.sdf) for o in port_objs]
    got = voxelize_step(sdfs, [o.pad_lo for o in port_objs], sh, vt, om, ct, grid, rot_q=q, origins0=o0,
                        rotating=rotating_flags(port_objs))
    near_iso = np.abs(field_ref - 0.5) <= 1e-6
    occ = got.occupancy.numpy()
    assert occ.sum() > 50  # the solid is in the domain
    np.testing.assert_array_equal(occ[~near_iso], occ_ref[~near_iso])
    vel = np.moveaxis(got.velocity.numpy(), 0, -1)
    both = (occ > 0) & (occ_ref > 0)
    np.testing.assert_allclose(vel[both], vel_ref[both], rtol=1e-6, atol=1e-5)
    assert np.all(vel[occ == 0] == 0) and np.all(vel_ref[occ_ref == 0] == 0)
    return occ, vel


@pytest.mark.parametrize("t", [0.05, 0.1, 0.3])
def test_voxelize_translated(prep, t):
    port_objs = build_solid_objects(config.load_scene_dict(PISTON, "t"), device="cpu")
    occ, vel = _assert_voxelized(prep, PISTON, port_objs, t, G)
    # 0.12 m over 0.2 s, ping-pong: -60 voxels/s out, +60 back
    np.testing.assert_allclose(vel[occ > 0][:, 0], -60.0 if t < 0.2 else 60.0, rtol=1e-3)


@pytest.mark.parametrize("t", [0.37, 1.0])
def test_voxelize_rotated(prep, t):
    port_objs = build_solid_objects(config.load_scene_dict(ROTATING, "t"), device="cpu")
    assert rotating_flags(port_objs) == (True,)
    _assert_voxelized(prep, ROTATING, port_objs, t, (32, 16, 16))


def test_markers_and_divergence_with_solids(prep):
    inputs, marker_ref, rhs_ref, fixed_ref = prep["grid"].result()
    solids = inputs["solids"]
    marker = marker_from_counts(torch.from_numpy(inputs["counts"]), G, solids.occupancy)
    np.testing.assert_array_equal(marker.numpy(), marker_ref)
    assert (marker_ref == 0).sum() > (marker_from_counts(torch.from_numpy(inputs["counts"]), G) == 0).sum()
    vel = [torch.from_numpy(v) for v in inputs["vel"]]
    rhs = compute_divergence_rhs(vel, marker, solids.velocity)
    np.testing.assert_allclose(rhs.numpy(), rhs_ref, rtol=1e-6, atol=1e-5)
    fixed = gridfix.gridfix_remove(vel, torch.from_numpy(inputs["p"]), marker, solids.velocity)
    for c in range(3):
        np.testing.assert_allclose(fixed[c].numpy(), fixed_ref[c], rtol=1e-6, atol=1e-6)
    # faces into the moving solid carry its velocity
    assert np.isclose(fixed_ref[0], -35.0).sum() > 0


def test_advect_with_solids_matches_oracle(prep, monkeypatch):
    table, solids, faces = _advect_inputs()
    ref = prep["advect"].result()
    args = (table.posq, faces, np.float32(DT), solids.occupancy, solids.velocity)
    posq, dyn, _ = g2p.advect_plain(*args)
    g, r = unpack_posq(posq[:, 0], posq[:, 1]), unpack_posq(ref.posq[:, 0], ref.posq[:, 1])
    np.testing.assert_array_equal(g[3].numpy(), r[3].numpy())
    for a in range(3):
        assert (g[a] - r[a]).abs().max().item() <= 1, f"axis {a} differs by more than one quantum"
    gv, ga = unpack_dyn([dyn[:, c] for c in range(6)])
    rv, ra = unpack_dyn([ref.dyn[:, c] for c in range(6)])
    # one bf16 ulp, plus, for the velocity a penetrating particle takes (a
    # position difference over dt), one f32 ulp of a position (< 32) over dt
    vel_atol = 2.0 ** -19 / DT
    for i, (x, y) in enumerate(zip(gv + ga, rv + ra)):
        atol = vel_atol if i < 3 else 1e-6
        assert torch.all((x - y).abs() <= 2.0 ** -7 * torch.maximum(x.abs(), y.abs()) + atol)
    # each solid mechanism changes the outcome on these inputs
    zeros = [torch.zeros_like(faces[0])] * 3
    for name, stub in (
        ("_escape", lambda pos, *a: pos),
        ("_occupied_target", lambda occ, new_pos, gi: torch.zeros_like(new_pos[0], dtype=torch.bool)),
        ("_push", lambda *a: zeros),
    ):
        with monkeypatch.context() as m:
            m.setattr(g2p, name, stub)
            assert not torch.equal(g2p.advect_plain(*args)[0], posq), f"{name} never fired"


def test_scene_runs_on_the_cpu(prep):
    """Runs last: the oracles on the pool are done by then."""
    cfg = config.load_scene_dict(PISTON, "piston")
    scene = Scene(cfg, capacity=K, device="cpu")
    n0 = scene.num_particles()
    p0 = scene.particle_positions()
    assert n0 == scene.params.num_particles == p0.shape[0]
    for _ in range(3):
        scene.step()
    p = scene.particle_positions()
    stats = scene.solver_stats()
    assert np.isfinite(p).all() and np.isfinite(scene.particle_velocities()).all()
    assert p.shape[0] + stats["lost_particles"] == n0
    # the solids of the last substep: the piston the particles were just
    # advected against, 1.5 cells into the pool
    occ = scene.solids.occupancy.numpy()
    cells = np.floor(p).astype(int)
    before = np.floor(p0).astype(int)
    # the seeded pool would break the 2 % budget; the run keeps it
    assert (occ[before[:, 0], before[:, 1], before[:, 2]] > 0).mean() > 0.02
    assert (occ[cells[:, 0], cells[:, 1], cells[:, 2]] > 0).mean() < 0.02
    assert scene.current_solids().occupancy.sum() > occ.sum()  # still moving in
    assert scene.total_simulated_time == pytest.approx(3 * DT)
    scene.reset()
    np.testing.assert_array_equal(scene.particle_positions(), p0)
    assert scene.total_simulated_time == 0.0


def test_velocity_solves_per_frame_match_jax(prep):
    """The port's eager frames on the piston against the JAX package's dense
    frame from the same seeding, frame by frame: each velocity solve's
    iterations equal, and its exit error within 3 % (the layouts drop
    different particles where a cell overflows: 7 lost against 5 after the
    second frame), both under the tolerance unless the solve ran to its
    cap."""
    scene = Scene(config.load_scene_dict(PISTON, "piston"), capacity=K, device="cpu")
    got, want = _frame_solves(scene), prep["frames"].result()
    cfg = scene.params.solver_vel
    assert [n for n, _ in got] == [n for n, _ in want], (got, want)
    for (n, e), (_, w) in zip(got, want):
        assert abs(e - w) <= 0.03 * w, (got, want)
        assert e < cfg.error_tolerance or n == cfg.max_num_iterations, (got, want)
        assert (e < cfg.error_tolerance) == (w < cfg.error_tolerance), (got, want)


def test_scene_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Scene(config.load_scene_dict(PISTON, "piston"))


def test_solids_convert_round_trip():
    solids = moving_box(G, (3, 2, 1), (9, 7, 5), (-35.0, 2.0, 1.0))
    back = convert.solids_to_jax(solids)
    assert back["velocity"].shape == G + (3,)
    again = convert.solids_from_jax(back["occupancy"], back["velocity"], device="cpu")
    assert torch.equal(again.occupancy, solids.occupancy) and torch.equal(again.velocity, solids.velocity)
