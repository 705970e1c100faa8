"""The physics-quality numbers, the fixed-dt step entry points and the byte
model of the port (blub_tpu_torch/sim/quality.py, sim/dense_transfer.py,
sim/step_dense.py, probes/bandwidth_model.py) on the CPU.

On three states (a seeded cube and a crowded table at 16x8x8, and a
24x16x16 dam after 3 frames): physics_quality against bench.py's
physics_quality on the same state converted through ``convert`` (the
booleans and max_divergence equal, the drift percentages within one
rounding unit); the unrounded density_drift against the JAX expression of
bench.py:70-79 (interior count exact, rtol 1e-5, atol 1e-6: the density sums
run in another order than XLA's); marker_from_table and p2g_density_dense
against the JAX package's (the marker exact, the density at rtol 1e-5,
atol 1e-5, as tests/test_torch_p2g.py holds it). step_dense against
step_core and multi_step_dense(n) against n step_dense calls, bit for bit.
The byte model's counts against closed forms written out here."""

import contextlib
import io
import pathlib
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))  # bench.py, at the repository root

import bench  # noqa: E402
from blub_tpu.core.types import CELL_FLUID  # noqa: E402
from blub_tpu.sim import slot_major as jsm  # noqa: E402
from blub_tpu.sim.dense_transfer import marker_from_table as jax_marker, p2g_density_dense as jax_density  # noqa: E402
from blub_tpu.sim.density import DENSITY0  # noqa: E402
from blub_tpu.sim.gridops import shift as jax_shift  # noqa: E402
from blub_tpu_torch import convert  # noqa: E402
from blub_tpu_torch.core.seeding import add_fluid_cube  # noqa: E402
from blub_tpu_torch.core.types import SimParams, SolverStats  # noqa: E402
from blub_tpu_torch.probes import bandwidth_model as bwm  # noqa: E402
from blub_tpu_torch.sim import step_dense as sd  # noqa: E402
from blub_tpu_torch.sim.dense_transfer import marker_from_table, p2g_density_dense  # noqa: E402
from blub_tpu_torch.sim.quality import density_drift, physics_quality  # noqa: E402
from blub_tpu_torch.testing import crowded_table, moving_box, random_table  # noqa: E402

torch.set_num_threads(1)

G = (16, 8, 8)
DAM = (24, 16, 16)
K = 16
TOL = 0.1  # SolverConfig's error tolerance
GRAV = (0.0, -981.0, 0.0)


def _state(table, error):
    """A port state around ``table`` whose velocity solve ended at ``error``."""
    dev = table.posq.device
    zeros = torch.zeros(table.grid_dim, dtype=torch.float32)
    return sd.DenseFluidState(
        table=table, pressure_vel=zeros, pressure_den=zeros.clone(), step_index=torch.zeros((), dtype=torch.int32),
        stats_vel=SolverStats(error=torch.tensor(error, dtype=torch.float32),
                              iterations=torch.tensor(7, dtype=torch.int32)),
        stats_den=SolverStats.zero(dev), max_speed=torch.zeros(()))


def _dam_params():
    pos = add_fluid_cube(DAM, (1, 1, 1), (DAM[0] // 2, DAM[1] // 2, DAM[2] - 1), 10**9)
    return SimParams(grid_dim=DAM, dt=1.0 / 120.0, gravity_grid=GRAV, num_particles=pos.shape[0]), pos


@pytest.fixture(scope="module")
def states():
    """The three states: a jiggled cube whose solve converged, a crowded
    table (up to 16 particles a cell) whose solve did not, and the dam after
    3 CPU frames, with its own solver stats."""
    params, pos = _dam_params()
    dam, _ = sd.multi_frame_dense(params, sd.make_dense_state(params, pos, K, device="cpu"), 3)
    return {"cube": _state(random_table(G, K, seed=0), 0.0437),
            "crowded": _state(crowded_table(G, K, seed=1, fill=0.7), 0.25),
            "dam": dam}


def _jax_table(table):
    d = convert.table_to_jax(table)
    return jsm.SlotMajorTable(posq=jnp.asarray(d["posq"]), dyn=jnp.asarray(d["dyn"]), lost=jnp.int32(d["lost"]),
                              grid_dim=d["grid_dim"])


@jax.jit
def _jax_drift(sm):
    """bench.py:70-79 on a slot-major table, with the interior count."""
    table = jsm.to_table(sm)
    marker = jax_marker(table, None)
    rho = jax_density(table)
    interior = marker == CELL_FLUID
    for ax in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        for off in (ax, tuple(-a for a in ax)):
            interior = interior & (jax_shift(marker, off) == CELL_FLUID)
    err = jnp.where(interior, rho / DENSITY0 - 1.0, 0.0)
    count = jnp.sum(interior.astype(jnp.int32))
    return jnp.sum(err) / jnp.maximum(count, 1).astype(jnp.float32), jnp.max(jnp.abs(err)), count


@jax.jit
def _jax_marker_density(sm, occupancy):
    table = jsm.to_table(sm)
    return jax_marker(table, occupancy), jax_density(table)


STATES = ("cube", "crowded", "dam")


@pytest.mark.parametrize("name", STATES)
def test_physics_quality_matches_bench(states, name):
    state = states[name]
    got = physics_quality(state, TOL)
    jstate = types.SimpleNamespace(table=_jax_table(state.table),
                                   stats_vel=types.SimpleNamespace(error=jnp.float32(state.stats_vel.error.item())))
    want = bench.physics_quality(jstate, TOL)
    assert set(got) == set(want)
    assert got["max_divergence"] == want["max_divergence"]
    assert got["solver_converged"] == want["solver_converged"]
    assert abs(got["density_drift_pct"] - want["density_drift_pct"]) <= 0.001 + 1e-9, (got, want)
    assert abs(got["density_err_max_pct"] - want["density_err_max_pct"]) <= 0.01 + 1e-9, (got, want)


def test_the_states_cover_both_verdicts_and_signs(states):
    """The cases are not degenerate: converged and not, compressed fluid in
    the crowded table, interior cells in every state."""
    q = {name: physics_quality(states[name], TOL) for name in STATES}
    assert q["cube"]["solver_converged"] and not q["crowded"]["solver_converged"]
    assert q["crowded"]["density_drift_pct"] > 0
    assert all(int(density_drift(states[name].table).interior) > 0 for name in STATES)


@pytest.mark.parametrize("name", STATES)
def test_density_drift_matches_the_jax_expression(states, name):
    table = states[name].table
    got = density_drift(table)
    mean, worst, count = _jax_drift(_jax_table(table))
    assert int(got.interior) == int(count)
    assert got.mean.dtype == got.max.dtype == torch.float32 and got.mean.dim() == 0
    np.testing.assert_allclose(float(got.mean), float(mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got.max), float(worst), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", STATES + ("cube_with_solid",))
def test_marker_and_density_match_jax(states, name):
    table = states[name.split("_")[0]].table
    occ = moving_box(table.grid_dim, (3, 2, 2), (7, 5, 6), (10.0, 0.0, 0.0)).occupancy \
        if name == "cube_with_solid" else None
    marker, rho = _jax_marker_density(_jax_table(table), None if occ is None else jnp.asarray(occ.numpy()))
    got = marker_from_table(table, occ)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(marker))
    np.testing.assert_allclose(p2g_density_dense(table).numpy(), np.asarray(rho), rtol=1e-5, atol=1e-5)


def _bits(s):
    return [s.table.posq, s.table.dyn, s.table.lost, s.pressure_vel, s.pressure_den, s.step_index,
            s.stats_vel.error, s.stats_vel.iterations, s.stats_den.error, s.stats_den.iterations, s.max_speed]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(_bits(a), _bits(b)))


def _cube_params(state):
    return SimParams(grid_dim=G, dt=1.0 / 120.0, gravity_grid=GRAV, num_particles=int(state.table.num_particles()))


def test_step_dense_is_step_core_at_params_dt(states):
    state = states["cube"]
    params = _cube_params(state)
    assert _same(sd.step_dense(params, state), sd.step_core(params, state, params.dt))
    half = np.float32(params.dt) / np.float32(2)
    assert _same(sd.step_dense(params, state, dt=half), sd.step_core(params, state, half))
    solids = moving_box(G, (9, 2, 3), (12, 6, 7), (-30.0, 0.0, 0.0))
    assert _same(sd.step_dense(params, state, solids), sd.step_core(params, state, params.dt, solids))


def test_multi_step_dense_is_n_step_dense(states):
    start = states["cube"]
    params = _cube_params(start)
    before = [t.clone() for t in _bits(start)]
    ref = start
    for _ in range(3):
        ref = sd.step_dense(params, ref)
    got = sd.multi_step_dense(params, start, 3)
    assert _same(got, ref)
    assert int(got.step_index) == int(start.step_index) + 3
    assert all(torch.equal(a, b) for a, b in zip(before, _bits(start)))  # the input is left as it was


# --------------------------------------------------------------------------
# the byte model: grid 4x3x2 (24 cells), K=3 (stage slack 4: k_mid 7), 10
# valid slots


N, KS, KM, V = 24, 3, 7, 10


def test_table_and_kernel_counts():
    assert KS + sd.stage_slack((4, 3, 2), KS) == KM
    assert bwm.table_in(KS, V, 8, N) == 4 * 3 * 24 + 4 * 7 * 10 == 568
    assert bwm.table_out(KS, N) == 3 * 32 * 24
    assert bwm.p2g_velocity(KS, N, V) == (568 + 7 * 4 * 24, 10 * 280)
    assert bwm.p2g_density(KS, N, V) == (4 * 3 * 24 + 4 * 10 + 2 * 4 * 24, 10 * 30)
    assert bwm.p2g(KS, N, V, 6) == (1240 + 4 * 3 * 24 + 4 * 6 + 2 * 4 * 24, 2800 + 180)
    assert bwm.pcg_solve(N, 5, 9) == (24 * (4 + 4 + 1 + 4), 5 * 9 * 30)
    assert bwm.pcg(N, [5, 2], [9, 8]) == (2 * 312, (45 + 16) * 30)
    assert bwm.pcg_iteration(N) == (56 * 24, 45 * 24)
    assert bwm.gridfix_remove(N) == (29 * 24, 36 * 24)
    assert bwm.gridfix_remove(N, solids=True) == (41 * 24, 36 * 24)
    assert bwm.gridfix_change(N) == (17 * 24, 36 * 24)
    assert bwm.gridfix(N) == (46 * 24, 72 * 24)
    assert bwm.g2p_advect(KS, N, V) == (328 + 12 * 24 + 3 * 32 * 24, 6000)
    assert bwm.g2p_advect(KS, N, V, solids=True) == (328 + 28 * 24 + 3 * 32 * 24, 7300)
    assert bwm.g2p_correct(KS, N, V) == (328 + 13 * 24 + 3 * 8 * 24, 2000)
    assert bwm.advect_pack(KS, KM, N, V) == (328 + 12 * 24 + 7 * 32 * 24, 6000) == (5992, 6000)
    assert bwm.advect_pack(KS, KM, N, V, solids=True) == (6376, 7300)
    assert bwm.correct_pack(KS, KM, N, V) == (568 + 13 * 24 + 7 * 32 * 24, 2000) == (6256, 2000)
    assert bwm.pack(KM, KS, N, V) == (4 * 7 * 24 + 4 * 7 * 10 + 3 * 32 * 24, 0) == (3256, 0)


@pytest.mark.parametrize("solids", [False, True])
def test_phase_bytes(solids):
    got = bwm.phase_bytes((4, 3, 2), KS, V, solids)
    want = {"ph_p2g": 1240, "ph_marker": 41 * 24 + (4 * 24 if solids else 0),
            "ph_div_rhs": 17 * 24 + (12 * 24 if solids else 0), "ph_pcg_vel": 312,
            "ph_gridfix_vel": (41 if solids else 29) * 24, "ph_advect": 6376 if solids else 5992, "ph_rebin2": 3256,
            "ph_p2g_density": 520, "ph_den_rhs": 13 * 24 + (4 * 24 if solids else 0), "ph_pcg_den": 312,
            "ph_gridfix_den": 408, "ph_correct": 6256, "ph_rebin1": 3256}
    assert got == want
    assert bwm.floor_ms(sum(got.values())) == sum(got.values()) / 3.35e12 * 1e3


def test_phases_are_step_cores_ranges():
    """The model's keys are step_core's record_function names, in its order."""
    src = pathlib.Path(sd.__file__).read_text()
    body = src[src.index("def step_core("):src.index("def step_dense(")]
    assert tuple(re.findall(r'record_function\("(ph_\w+)"\)', body)) == bwm.PHASES


def test_seeding_and_cli():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bwm.main(["128", "64", "64", "16"]) == 0
    assert "valid slots 968688 " in out.getvalue()  # bench.py's cube: 63 x 31 x 62 cells at 8 a cell
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bwm.main(["4", "3", "2", "3", "10"]) == 0
    text = out.getvalue()
    for name in bwm.PHASES:
        assert re.search(rf"{name} +\d+ B", text), name
    assert re.search(rf"substep +{sum(bwm.phase_bytes((4, 3, 2), KS, V).values())} B", text)
    with contextlib.redirect_stderr(io.StringIO()):
        assert bwm.main(["4", "3"]) == 2

