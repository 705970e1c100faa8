"""The port's runtime against the JAX package's, on the CPU: the profiler's
PhaseTimer, phase names and trace parsing, the controller, checkpoints
across the two packages, the Scene's non-blocking stats and debug fields,
and the voxelizer fed device-tensor parameters. The scene is the 24x16x16
piston of tests/test_torch_solids.py (a cube entering from +x).

- PhaseTimer: the same samples and the same chrome-trace events as JAX's;
- profile_step: JAX's phase names (read by running JAX's profile_step with
  its jitted phases stubbed out: only the names are compared), every time
  finite and non-negative;
- parse_phase_trace: a hand-written chrome trace, per-phase ms to 1e-12;
- the controller's step counts against JAX's, on a stub scene, in the modes
  that do not read the wall clock: recording, pause, fast-forward, stop time;
- checkpoints: port -> JAX and JAX -> port bit for bit, every leaf; the
  raise for another scene, for the JAX "pt" layout and for permuted axes;
- solver_stats(block=False) as tests/test_runtime.py holds JAX's;
- debug_fields against JAX's Scene.debug_fields on the same particles:
  marker and pressures exact, velocity and divergence within 1e-4;
- voxelize_step fed f32 tensors: occupancy and velocity bit for bit against
  JAX's jitted voxelize_step, translated and rotated; the translated field
  bit for bit, the rotated one within 1e-5 (JAX forms its coordinates with
  an einsum).

The JAX oracles compile once per module (each jitted function is built at
module level and called with the same shapes).
"""

import dataclasses
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blub_tpu.core import config as jconfig
from blub_tpu.core import models as jmodels
from blub_tpu.core import seeding as jseeding
from blub_tpu.core.types import SimParams as JaxSimParams
from blub_tpu.core.types import SolverStats as JaxSolverStats
from blub_tpu.runtime import checkpoint as jcheckpoint
from blub_tpu.runtime import controller as jcontroller
from blub_tpu.runtime import profiler as jprofiler
from blub_tpu.runtime.scene import Scene as JaxScene
from blub_tpu.sim import dense_transfer as jdense_transfer
from blub_tpu.sim import divergence as jdivergence
from blub_tpu.sim import slot_major as jsm
from blub_tpu.sim import step_dense as jstep
from blub_tpu.sim import voxelize as jvox
from blub_tpu_torch import convert
from blub_tpu_torch.core import config
from blub_tpu_torch.core.models import build_solid_objects
from blub_tpu_torch.ops import cuda
from blub_tpu_torch.runtime import checkpoint, controller, profiler
from blub_tpu_torch.runtime.scene import Scene
from blub_tpu_torch.sim import voxelize
from blub_tpu_torch.sim.step_dense import (
    DenseFluidState,
    decode_scalars,
    eager_frame,
    frame_dense,
    frame_dense_fn,
    make_dense_state,
    scalar_words,
)

torch.set_num_threads(1)

G = (24, 16, 16)
K = 16
DT = 1.0 / 120.0


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


# tests/test_torch_solids.py's piston over its pool, and its rotating box
PISTON = _scene_dict(
    [{
        "model": "cube.obj", "world_position": _v(0.24, 0.0, 0.0), "scale": 0.08,
        "rotation_angles": _v(0.0, 0.0, 0.0),
        "animation": {"translation": {"target": _v(0.12, 0.0, 0.0), "curve": "Linear", "duration": 0.2}},
    }],
    [(0.04, 0.0, 0.0, 0.24, 0.06, 0.14)],
)
ROTATING = _scene_dict(
    [{
        "model": "cube.obj", "world_position": _v(0.12, 0.06, 0.08), "scale": 0.07,
        "rotation_angles": _v(0.0, 0.0, 0.0),
        "animation": {"rotation": {"axis": _v(0.0, 1.0, 0.0), "deg_per_sec": 90.0}},
    }],
    [], dim=(32, 16, 16), max_particles=8,
)


def _port_scene(name="piston"):
    return Scene(config.load_scene_dict(PISTON, name), capacity=K, device="cpu")


@pytest.fixture(scope="module")
def stepped():
    """A port Scene on the CPU after three frames (the piston moving in)."""
    scene = _port_scene()
    for _ in range(3):
        scene.step()
    return scene


# -- profiler ----------------------------------------------------------------


def test_phase_timer_matches_jax(tmp_path):
    ours, theirs = profiler.PhaseTimer(), jprofiler.PhaseTimer()
    for t in (ours, theirs):
        for name in ("a", "b", "a"):
            with t.phase(name):
                pass
    assert {k: len(v) for k, v in ours.samples.items()} == {k: len(v) for k, v in theirs.samples.items()}
    a = json.loads(ours.write_chrometrace(tmp_path / "ours.json").read_text())["traceEvents"]
    b = json.loads(theirs.write_chrometrace(tmp_path / "theirs.json").read_text())["traceEvents"]
    assert [(e["name"], e["ph"], e["pid"], e["tid"], sorted(e)) for e in a] == \
        [(e["name"], e["ph"], e["pid"], e["tid"], sorted(e)) for e in b]
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in a)
    assert ours.report().splitlines()[0] == theirs.report().splitlines()[0] and "total" in ours.report()


def _jax_phase_names(monkeypatch):
    """JAX's profile_step phase names, in its order: its jitted phases are
    stubbed (each returns zeros), so nothing compiles."""
    zero = jnp.zeros(1)
    stub = types.SimpleNamespace(jit=lambda f, **kw: (lambda *a, **k: zero), tree_util=jax.tree_util,
                                 device_get=jax.device_get)
    monkeypatch.setattr(jprofiler, "jax", stub)
    params = JaxSimParams(grid_dim=G, dt=DT, gravity_grid=(0.0, -981.0, 0.0), num_particles=1)
    state = types.SimpleNamespace(table=zero, pressure_vel=zero, pressure_den=zero)
    means, _ = jprofiler.profile_step(params, state, repeats=1)
    return list(means)


def test_profile_step_phase_names_match_jax(monkeypatch, stepped):
    names = _jax_phase_names(monkeypatch)
    means, timer = profiler.profile_step(stepped.params, stepped.state, stepped.solids, repeats=1)
    assert list(means) == names == list(profiler.PHASES)
    assert all(math.isfinite(v) and v >= 0 for v in means.values())
    assert means["extrapolate"] == 0.0  # inside the gridfix kernel of "divergence remove"
    assert means["p2g velocity"] > 0 and means["pcg velocity"] > 0
    assert "total" in timer.report()


def _write_trace(path, events):
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_parse_phase_trace(tmp_path):
    """Device events inside each ph_* span on the GPU timeline, the rest as
    "other"; host-side events and non-ph annotations are not device time."""
    events = [
        {"ph": "X", "cat": "gpu_user_annotation", "name": "ph_p2g", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "ph_pcg_vel", "ts": 150.0, "dur": 150.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "ph_pcg_vel", "ts": 500.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "frame", "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "ph_p2g", "ts": 0.0, "dur": 900.0},
        {"ph": "X", "cat": "kernel", "name": "p2g_kernel", "ts": 10.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "straddles", "ts": 90.0, "dur": 30.0},  # 10 in ph_p2g
        {"ph": "X", "cat": "kernel", "name": "pcg_solve_kernel", "ts": 160.0, "dur": 40.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 250.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 520.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "replayed", "ts": 700.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 20.0, "dur": 500.0},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python"}},
    ]
    want = {"ph_p2g": 0.040, "ph_pcg_vel": 0.055, "other": 0.070}
    got = profiler.parse_phase_trace(_write_trace(tmp_path / "a.trace.json", events))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12)
    # a directory: its newest trace; a list of events without the wrapper
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.trace.json").write_text(json.dumps(events[:2] + events[5:8]))
    got = profiler.parse_phase_trace(tmp_path / "sub")
    assert got == pytest.approx({"ph_p2g": 0.040, "ph_pcg_vel": 0.040, "other": 0.020}, abs=1e-12)


def test_profile_trace_on_the_cpu(tmp_path, stepped):
    """profile_trace runs the function under torch.profiler and parses the
    trace it wrote; the CPU has no device events, so every phase reads 0."""
    calls = []
    phases = profiler.profile_trace(lambda: calls.append(stepped.num_particles()), log_dir=tmp_path, runs=2)
    assert len(calls) == 2 and (tmp_path / "blub.trace.json").exists()
    assert phases == {"other": 0.0}


# -- controller --------------------------------------------------------------


class _StubScene:
    """What the controller touches of a Scene, stepping instantly."""

    def __init__(self):
        self.settings = types.SimpleNamespace(dt=DT)
        self.total_simulated_time = 0.0
        self.steps = self.resets = self.stats_reads = 0

    def step(self):
        self.steps += 1
        self.total_simulated_time += DT

    def reset(self):
        self.resets += 1
        self.total_simulated_time = 0.0

    def solver_stats(self, block=True):
        self.stats_reads += 1
        return {}


def _drive(mod):
    scene = _StubScene()
    ctl = mod.SimulationController(scene, recording_frame_length=1.0 / 50.0)
    log = []
    ctl.status = mod.SimulationControllerStatus.RECORDING
    log.append([ctl.frame_steps().sim_steps for _ in range(7)])
    ctl.pause_or_resume()
    log.append([ctl.frame_steps().sim_steps for _ in range(3)] + [ctl.status.value])
    ctl.pause_or_resume()
    ff = ctl.fast_forward(0.25, batch=7)
    log.append([ff.sim_steps, ctl.status.value, scene.stats_reads])
    ctl.simulation_stop_time = 0.4
    ff = ctl.fast_forward(1.0, batch=16)
    log.append([ff.sim_steps, round(scene.total_simulated_time / DT)])
    ctl.status = mod.SimulationControllerStatus.RECORDING
    log.append([ctl.frame_steps().sim_steps for _ in range(2)])
    ctl.restart()
    log.append([ctl.total_steps, scene.resets, scene.steps, len(ctl.frame_history)])
    return log


def test_controller_step_counts_match_jax():
    ours, theirs = _drive(controller), _drive(jcontroller)
    assert ours == theirs
    assert sum(ours[0]) == 7 * 120 // 50 and ours[1][:3] == [0, 0, 0] and ours[3][0] < 120


# -- checkpoints -------------------------------------------------------------


def _jax_state(leaves, grid_dim):
    """A JAX slot-major DenseFluidState holding ``leaves`` (numpy, in the
    checkpoint's order)."""
    a = [jnp.asarray(x) for x in leaves]
    return jstep.DenseFluidState(
        table=jsm.SlotMajorTable(posq=a[0], dyn=a[1], lost=a[2], grid_dim=tuple(grid_dim)),
        pressure_vel=a[3], pressure_den=a[4], step_index=a[5],
        stats_vel=JaxSolverStats(error=a[6], iterations=a[7]), stats_den=JaxSolverStats(error=a[8], iterations=a[9]),
        max_speed=a[10],
    )


def _assert_leaves_equal(got, want):
    assert len(got) == len(want) == len(convert.STATE_LEAVES)
    for name, a, b in zip(convert.STATE_LEAVES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), name


def test_checkpoint_port_to_jax(tmp_path, stepped):
    path = checkpoint.save_scene(stepped, tmp_path / "port.npz")
    want = convert.state_leaves(stepped.state)
    like = _jax_state([np.zeros_like(a) for a in want], G)
    state, meta = jcheckpoint.load_checkpoint(path, like)
    assert meta["scene_name"] == "piston" and meta["total_simulated_time"] == stepped.total_simulated_time
    _assert_leaves_equal(jax.tree_util.tree_leaves(state), want)
    # the leaves land in JAX's named fields
    s = stepped.state
    assert int(state.table.lost) == int(s.table.lost) and int(state.step_index) == s.step_index == 3
    assert int(state.stats_den.iterations) == int(s.stats_den.iterations)
    assert float(state.max_speed) == float(s.max_speed) > 0


def test_checkpoint_jax_to_port(tmp_path):
    """A JAX slot-major state (its own table build, perturbed pressures and
    stats) loads into the port's Scene bit for bit, and the scene runs on."""
    jcfg = jconfig.load_scene_dict(PISTON, "piston")
    pos = jseeding.seed_scene(jcfg)
    params = JaxSimParams.from_scene(jcfg, jconfig.SimSettings(), num_particles=pos.shape[0])
    table = jax.jit(jsm.from_table)(jstep.from_positions(pos, params.grid_dim, K))
    rng = np.random.default_rng(3)
    jstate = jstep.DenseFluidState(
        table=table,
        pressure_vel=jnp.asarray(rng.standard_normal(G).astype(np.float32)),
        pressure_den=jnp.asarray(rng.standard_normal(G).astype(np.float32)),
        step_index=jnp.int32(42), stats_vel=JaxSolverStats(error=jnp.float32(0.0625), iterations=jnp.int32(9)),
        stats_den=JaxSolverStats(error=jnp.float32(0.03125), iterations=jnp.int32(4)),
        max_speed=jnp.float32(61.5),
    )
    path = jcheckpoint.save_checkpoint(tmp_path / "jax.npz", jstate, scene_name="piston", total_simulated_time=0.35)
    scene = _port_scene()
    checkpoint.load_scene_checkpoint(scene, path)
    _assert_leaves_equal(convert.state_leaves(scene.state), jax.tree_util.tree_leaves(jstate))
    assert scene.total_simulated_time == 0.35 and scene.state.step_index == 42
    assert scene.solver_stats()["density"] == {"error": 0.03125, "iterations": 4}
    scene.step()
    assert scene.num_particles() + scene.solver_stats()["lost_particles"] == scene.params.num_particles
    assert np.isfinite(scene.particle_positions()).all()


def test_checkpoint_raises_for_another_scene_or_layout(tmp_path, stepped):
    path = checkpoint.save_scene(stepped, tmp_path / "p.npz")
    with pytest.raises(ValueError, match="scene"):
        checkpoint.load_scene_checkpoint(_port_scene("other"), path)
    # the JAX package's CPU Scene runs its "pt" particle-table layout
    jscene = JaxScene(jconfig.load_scene_dict(PISTON, "piston"), jconfig.SimSettings(), capacity=K)
    assert jscene.layout == "pt"
    pt = jcheckpoint.save_scene(jscene, tmp_path / "pt.npz")
    with pytest.raises(ValueError, match='"pt" particle-table layout'):
        checkpoint.load_scene_checkpoint(_port_scene(), pt)
    # a slot-major state in the axis order JAX's axis_layout="auto" picks
    assert jscene.perm != (0, 1, 2)
    perm = tuple(G[i] for i in jscene.perm)
    leaves = [np.zeros((K, 2) + perm[:2] + (128,), np.float32), np.zeros((K, 6) + perm[:2] + (128,), np.float32),
              np.int32(0), np.zeros(perm, np.float32), np.zeros(perm, np.float32), np.int32(0), np.float32(0),
              np.int32(0), np.float32(0), np.int32(0), np.float32(0)]
    permuted = jcheckpoint.save_checkpoint(tmp_path / "perm.npz", _jax_state(leaves, perm), scene_name="piston")
    with pytest.raises(ValueError, match="axis-permuted"):
        checkpoint.load_scene_checkpoint(_port_scene(), permuted)


# -- Scene -------------------------------------------------------------------


def test_solver_stats_nonblocking():
    """As tests/test_runtime.py::test_solver_stats_nonblocking holds JAX's:
    block=False never raises and agrees with the blocking read."""
    scene = _port_scene()
    first = scene.solver_stats(block=False)
    assert set(first) == {"velocity", "density", "lost_particles"}
    scene.step()
    scene.solver_stats(block=False)
    scene.step()
    scene.solver_stats(block=False)
    for _ in range(3):
        got = scene.solver_stats(block=False)
    want = scene.solver_stats(block=True)
    assert got == want and got["velocity"]["iterations"] > 0
    assert scene.layout == "sm"


def test_scalar_words_round_trip(stepped):
    words = scalar_words(stepped.state)
    got = decode_scalars(words.numpy())
    s = stepped.state
    assert got == {"error_vel": s.stats_vel.error.item(), "iterations_vel": int(s.stats_vel.iterations),
                   "error_den": s.stats_den.error.item(), "iterations_den": int(s.stats_den.iterations),
                   "lost": int(s.table.lost), "max_speed": s.max_speed.item(), "n_sub": 0}  # an eager state's


def test_debug_fields_match_jax(monkeypatch, stepped):
    """Both packages' debug_fields on the port's particles and pressures
    (the JAX scene in the identity axis layout, its table converted from the
    port's); JAX's dense phases are jitted so they compile once."""
    jscene = JaxScene(jconfig.load_scene_dict(PISTON, "piston"), jconfig.SimSettings(axis_layout="identity"),
                      capacity=K)
    jscene.total_simulated_time = stepped.total_simulated_time
    t = convert.table_to_jax(stepped.state.table)
    sm = jsm.SlotMajorTable(posq=jnp.asarray(t["posq"]), dyn=jnp.asarray(t["dyn"]), lost=jnp.asarray(t["lost"]),
                            grid_dim=G)
    jscene.state = dataclasses.replace(
        jscene.state, table=jax.jit(jsm.to_table)(sm),
        pressure_vel=jnp.asarray(stepped.state.pressure_vel.numpy()),
        pressure_den=jnp.asarray(stepped.state.pressure_den.numpy()),
    )
    monkeypatch.setattr(jdense_transfer, "marker_from_table", jax.jit(jdense_transfer.marker_from_table))
    monkeypatch.setattr(jdense_transfer, "p2g_velocity_dense",
                        jax.jit(jdense_transfer.p2g_velocity_dense, static_argnums=(2, 3)))
    monkeypatch.setattr(jdivergence, "compute_divergence_rhs", jax.jit(jdivergence.compute_divergence_rhs))
    want = jscene.debug_fields()
    got = stepped.debug_fields()
    assert got.keys() == want.keys()
    for k in ("marker", "pressure_from_velocity", "pressure_from_density"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("velocity", "divergence_error"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4, err_msg=k)
    assert np.abs(got["divergence_error"]).max() > 0.1


# -- voxelizer ---------------------------------------------------------------


def _jax_voxelize(objs, grid):
    rot = tuple(o.has_runtime_rotation for o in objs)
    pads = [o.pad_lo for o in objs]

    @jax.jit
    def fn(sdfs, shifts, vts, oms, cts, qs, o0s):
        solids = jvox.voxelize_step(sdfs, pads, shifts, vts, oms, cts, grid, rot_q=qs, origins0=o0s, rotating=rot)
        if rot[0]:
            field = jvox.resample_sdf_rotated(sdfs[0], pads[0], qs[0], cts[0], o0s[0], grid)
        else:
            field = jvox.resample_sdf(sdfs[0], pads[0], shifts[0], grid)
        return solids, field

    return fn


@pytest.mark.parametrize("scene_dict, grid, times", [
    (PISTON, G, (0.05, 0.1, 0.3)),
    (ROTATING, (32, 16, 16), (0.37, 1.0)),
], ids=["translated", "rotated"])
def test_voxelize_device_parameters_match_jax(scene_dict, grid, times):
    objs = build_solid_objects(config.load_scene_dict(scene_dict, "t"), device="cpu")
    jobjs = jmodels.build_solid_objects(jconfig.load_scene_dict(scene_dict, "t"))
    fn = _jax_voxelize(jobjs, grid)
    sdfs = [torch.from_numpy(o.sdf) for o in objs]
    rotating = voxelize.rotating_flags(objs)
    for t in times:
        params = [torch.from_numpy(a) for a in voxelize.solid_params_at(objs, t, DT)]
        (jsol, jfield) = fn([jnp.asarray(o.sdf) for o in jobjs],
                            *[jnp.asarray(a) for a in jvox.solid_params_at(jobjs, t, DT)])
        got = voxelize.voxelize_step(sdfs, [o.pad_lo for o in objs], *params[:4], grid, rot_q=params[4],
                                     origins0=params[5], rotating=rotating)
        if rotating[0]:
            field = voxelize.resample_sdf_rotated(sdfs[0], objs[0].pad_lo, params[4][0], params[3][0],
                                                  params[5][0], grid)
        else:
            field = voxelize.resample_sdf(sdfs[0], objs[0].pad_lo, params[0][0], grid)
        assert got.occupancy.sum() > 20
        if rotating[0]:  # JAX forms the rotated coordinates with an einsum (an XLA dot)
            np.testing.assert_allclose(field.numpy(), np.asarray(jfield), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(field.numpy(), np.asarray(jfield))
        np.testing.assert_array_equal(got.occupancy.numpy(), np.asarray(jsol.occupancy))
        np.testing.assert_array_equal(np.moveaxis(got.velocity.numpy(), 0, -1), np.asarray(jsol.velocity))


def test_scene_voxelizes_from_its_parameter_buffer():
    """The Scene's path (every split's parameters filled into its buffer,
    read back as tensor views) gives the host-parameter voxelization's
    bits."""
    scene = _port_scene()
    scene._fill_params(scene._anim.numpy(), 0.1, DT)
    for n_sub in range(1, scene.settings.max_substeps + 1):
        for i in range(n_sub):
            t = 0.1 + (i + 1) * DT / n_sub
            want = scene._solids_at(t, DT / n_sub)
            got = scene._solids_fn(i, n_sub)
            assert torch.equal(got.occupancy, want.occupancy) and torch.equal(got.velocity, want.velocity)


# -- the frame on the CPU ----------------------------------------------------


def test_frame_runs_eagerly_on_the_cpu():
    """On CPU tensors frame_dense_fn is eager_frame: no graphs, no runner."""
    from blub_tpu_torch.core.seeding import add_fluid_cube
    from blub_tpu_torch.core.types import SimParams

    g = (16, 8, 8)
    pos = add_fluid_cube(g, (1, 1, 1), (8, 6, 7), 10**9)
    params = SimParams(grid_dim=g, dt=DT, gravity_grid=(0.0, -981.0, 0.0), num_particles=pos.shape[0])
    a = make_dense_state(params, pos, 8, device="cpu")
    b, n = frame_dense(params, a, None, cfl_target=1e-6, max_substeps=3)
    c = eager_frame(params, a, lambda i, n: None, n)
    assert b.runner is None and n == 1 and b.step_index == 1
    assert torch.equal(b.table.posq, c.table.posq) and torch.equal(b.table.dyn, c.table.dyn)
    d, n2 = frame_dense_fn(params, b, lambda i, n: None, cfl_target=1e-6, max_substeps=3)
    assert n2 == 3 and d.step_index == 4 and isinstance(d, DenseFluidState)


def test_loop_bodies_count_once_per_run():
    """A frame graph's branch holds loops (the mesh's PCG as CUDA WHILE
    nodes): each body's tallies, of launches and of a ShardCtx's
    collectives, are kept apart from its branch's (nested capture tallies)
    and count once per run of the body, from the device count of its runs,
    read when the counts are read; the branch's once per frame."""
    from blub_tpu_torch.parallel.sharded_sm import ShardCtx

    cuda.reset_launch_counts()
    ctx = ShardCtx(group=None, rank=0, n=1, device=torch.device("cpu"))
    part = torch.zeros(4)
    ctx._record("all_reduce", torch.zeros(2))  # an eager collective: counted at once
    with cuda.capture_tally() as branch, ctx.capture_tally() as branch_ctx:
        cuda.count_launch("p2g")
        ctx._record("all_reduce", torch.zeros(1))
        with cuda.capture_tally() as body, ctx.capture_tally() as body_ctx:
            cuda.count_launch("pcg_slab")
            cuda.count_launch("pcg_slab")
            ctx._record("all_reduce", part)
            ctx._record("all_reduce", part)
        cuda.count_launch("gridfix")
    assert branch == {"p2g": 1, "gridfix": 1} and body == {"pcg_slab": 2}
    assert branch_ctx == {"all_reduce": {"calls": 1, "bytes": 4, "max_bytes": 4}}
    assert body_ctx == {"all_reduce": {"calls": 2, "bytes": 32, "max_bytes": 16}}
    assert ctx.tally == {"all_reduce": {"calls": 1, "bytes": 8, "max_bytes": 8}}
    assert cuda.launch_counts()["pcg_slab"] == 0

    class Owner:
        pass

    owner = Owner()
    frames, runs = torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    for counter, b, l in ((cuda, branch, body), (ctx, branch_ctx, body_ctx)):
        counter.count_branches(owner, frames, [b])
        counter.count_branches(owner, runs, [l])
    frames += 2  # two frames, whose loops ran 21 and 5 times
    runs += 26
    counts = cuda.launch_counts()
    assert (counts["p2g"], counts["gridfix"], counts["pcg_slab"]) == (2, 2, 52)
    assert ctx.tally == {"all_reduce": {"calls": 1 + 2 + 52, "bytes": 8 + 8 + 26 * 32, "max_bytes": 16}}
    runs += 3
    assert cuda.launch_counts()["pcg_slab"] == 58  # only the runs since the last read
    ctx.reset_tally()
    assert ctx.tally == {}
    del owner
    runs += 1
    assert cuda.launch_counts()["pcg_slab"] == 60 and ctx.tally["all_reduce"]["calls"] == 2
    runs += 1  # a dropped graph's last runs count once more, and then it is gone
    assert cuda.launch_counts()["pcg_slab"] == 60 and ctx.tally["all_reduce"]["calls"] == 2
    cuda.reset_launch_counts()


def test_capture_tally_moves_counts_into_the_graph():
    cuda.reset_launch_counts()
    cuda.count_launch("p2g")
    with cuda.capture_tally() as tally:
        cuda.count_launch("p2g")
        cuda.count_launch("pcg")
        cuda.count_launch("pcg")
    assert tally == {"p2g": 1, "pcg": 2}
    assert cuda.launch_counts()["p2g"] == 1 and cuda.launch_counts()["pcg"] == 0
    # a graph whose branch 1 runs that tally and branch 2 only pcg, with its
    # count of the frames each branch ran (on the device on the card)

    class Owner:
        pass

    owner = Owner()
    frames = torch.zeros(2, dtype=torch.int32)
    cuda.count_branches(owner, frames, [tally, {"pcg": 1}])
    frames += torch.tensor([3, 1], dtype=torch.int32)
    counts = cuda.launch_counts()
    assert counts["p2g"] == 4 and counts["pcg"] == 7
    frames[1] += 2
    assert cuda.launch_counts()["pcg"] == 9  # only the frames run since the last read
    del owner
    frames[0] += 1
    assert cuda.launch_counts()["p2g"] == 5  # a dropped graph's last frames count once more
    frames[0] += 1
    assert cuda.launch_counts()["p2g"] == 5  # and then it is gone
    cuda.reset_launch_counts()
