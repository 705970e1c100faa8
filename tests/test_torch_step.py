"""The port's substep and CFL frames (blub_tpu_torch/sim/step_dense.py)
against the JAX package's step_dense on the "pt" layout (the XLA path).

From rest both layouts start with exact zero velocities, so one substep
compares closely: counts and lost exact, marker exact, positions sorted per
cell within one 2^-13 quantum, pressures close. Three CFL frames (n_sub = 1
at this size: max speed about 37 cells/s at dt = 1/120) conserve
count + lost == n0 and keep the centre of mass close to JAX's."""

import ast
import pathlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blub_tpu.core.types import SimParams as JaxSimParams
from blub_tpu.sim import slot_major as jsm
from blub_tpu.sim.dense_transfer import marker_from_table
from blub_tpu.sim.step_dense import make_dense_state as jax_make_state, step_dense
from blub_tpu_torch import convert
from blub_tpu_torch.core.seeding import add_fluid_cube
from blub_tpu_torch.core.types import SimParams, SolidState
from blub_tpu_torch.ops import p2g
from blub_tpu_torch.sim.sm_phases import marker_from_counts
from blub_tpu_torch.sim.step_dense import (
    frame_dense, make_dense_state, multi_frame_dense, step_core, substep_count, substep_count_device,
)

# small tensors: one intra-op thread avoids contending with XLA's CPU pool
torch.set_num_threads(1)

G = (16, 8, 8)
K = 16
DT = 1.0 / 120.0
REPO = pathlib.Path(__file__).resolve().parents[1]


def _pos():
    return add_fluid_cube(G, (1, 1, 1), (8, 6, 7), 10**9)


@pytest.fixture(scope="module")
def runs():
    """JAX: the initial state and 3 steps of one jitted step_dense."""
    pos = _pos()
    params = JaxSimParams(grid_dim=G, dt=DT, gravity_grid=(0.0, -981.0, 0.0), num_particles=pos.shape[0])
    state = jax_make_state(params, pos, capacity=K, layout="pt")
    step = jax.jit(partial(step_dense, params))
    states = [state]
    for _ in range(3):
        state = step(state)
        states.append(jax.block_until_ready(state))
    return pos, states


def _port_params(n):
    return SimParams(grid_dim=G, dt=DT, gravity_grid=(0.0, -981.0, 0.0), num_particles=n)


def _port_table(state):
    """Port table -> positions [X,Y,Z,K,3] and valid via the JAX decode."""
    out = convert.table_to_jax(state.table)
    sm = jsm.SlotMajorTable(
        posq=jnp.asarray(out["posq"]), dyn=jnp.asarray(out["dyn"]), lost=jnp.int32(out["lost"]), grid_dim=G
    )
    return jsm.to_table(sm)


def _sorted_cells(pos, valid):
    out = {}
    for cell in np.ndindex(G):
        r = pos[cell][valid[cell]]
        out[cell] = r[np.lexsort(r.T[::-1])]
    return out


def test_one_substep_matches_jax(runs):
    """From the JAX initial state carried across by convert.state_from_jax."""
    pos, jax_states = runs
    init, ref = jax_states[0], jax_states[1]
    sm = jsm.from_table(init.table)
    start = convert.state_from_jax(
        sm.posq, sm.dyn, sm.lost, G, init.pressure_vel, init.pressure_den, init.max_speed, device="cpu"
    )
    own = make_dense_state(_port_params(pos.shape[0]), pos, K, device="cpu")
    assert torch.equal(start.table.posq, own.table.posq) and torch.equal(start.table.dyn, own.table.dyn)
    params = _port_params(pos.shape[0])
    state = step_core(params, start, np.float32(DT))
    got = _port_table(state)
    assert state.table.num_particles().item() == int(ref.table.num_particles())
    assert state.table.lost.item() == int(ref.table.lost) == 0
    gv, rv = np.asarray(got.valid), np.asarray(ref.table.valid)
    a = _sorted_cells(np.asarray(got.pos), gv)
    b = _sorted_cells(np.asarray(ref.table.pos), rv)
    for cell in a:
        assert a[cell].shape == b[cell].shape, cell
        if len(a[cell]):
            assert np.abs(a[cell] - b[cell]).max() <= 2.0 ** -13 + 1e-6, cell
    marker = marker_from_counts(p2g.p2g(state.table.posq, state.table.dyn)[6], G)
    np.testing.assert_array_equal(marker.numpy(), np.asarray(marker_from_table(ref.table, None)))
    for got_p, ref_p in ((state.pressure_vel, ref.pressure_vel), (state.pressure_den, ref.pressure_den)):
        ref_p = np.asarray(ref_p)
        np.testing.assert_allclose(got_p.numpy(), ref_p, rtol=1e-3, atol=1e-3 * np.abs(ref_p).max())
    for got_s, ref_s in ((state.stats_vel, ref.stats_vel), (state.stats_den, ref.stats_den)):
        assert got_s.iterations.dtype == torch.int32 and got_s.iterations.dim() == 0
        assert int(got_s.iterations) == int(ref_s.iterations)
    assert state.max_speed.item() == pytest.approx(float(ref.max_speed), rel=1e-4)


def test_three_frames_conserve_and_track_jax(runs):
    pos, jax_states = runs
    n0 = pos.shape[0]
    params = _port_params(n0)
    state, n_subs = multi_frame_dense(params, make_dense_state(params, pos, K, device="cpu"), 3)
    back = convert.state_to_jax(state)
    assert back["posq"].shape == (K, 2) + G[:2] + (128,) and back["lost"] == state.table.lost.item()
    assert n_subs.dtype == torch.int32 and n_subs.tolist() == [1, 1, 1]
    count, lost = state.table.num_particles().item(), state.table.lost.item()
    assert count + lost == n0
    assert lost == int(jax_states[-1].table.lost) == 0
    got = _port_table(state)
    com = np.asarray(got.pos)[np.asarray(got.valid)].mean(axis=0)
    ref = jax_states[-1].table
    ref_com = np.asarray(ref.pos)[np.asarray(ref.valid)].mean(axis=0)
    np.testing.assert_allclose(com, ref_com, atol=1e-3)
    assert np.isfinite(state.pressure_vel.numpy()).all()
    assert state.stats_vel.error.item() <= params.solver_vel.error_tolerance
    assert state.max_speed.item() == pytest.approx(float(jax_states[-1].max_speed), rel=1e-2)


@pytest.mark.parametrize("dt,cfl,maxn", [(DT, 1.9, 4), (1.0 / 60.0, 1.5, 8), (DT, 0.25, 3)])
def test_substep_count_device_matches_jax(dt, cfl, maxn):
    """The device count against the JAX frame's formula (frame_dense_fn's
    expression, op by op: the product and the quotient round apart) on
    speeds at and around every split boundary (exact multiples of cfl/dt and
    one ulp either side), and on 0, 1e-30, 1e30, inf and NaN: the same
    integers. (Under jit, XLA on the CPU folds the two constants into one
    multiplier, which moves the count at a few speeds within one ulp of a
    boundary: ROADMAP section 3.)"""
    bounds = [np.float32(k) * np.float32(cfl) / np.float32(dt) for k in range(1, maxn + 2)]
    speeds = [np.float32(0.0), np.float32(1e-30), np.float32(1e30), np.float32(np.inf), np.float32(np.nan)]
    for b in bounds:
        speeds += [np.nextafter(b, np.float32(0)), b, np.nextafter(b, np.float32(np.inf))]
    speeds = np.array(speeds, np.float32)
    ref = jnp.clip(jnp.ceil(jnp.asarray(speeds) * dt / cfl).astype(jnp.int32), 1, maxn)
    params = SimParams(grid_dim=G, dt=dt, gravity_grid=(0.0, -981.0, 0.0), num_particles=1)
    got = [substep_count_device(params, torch.tensor(v), cfl, maxn) for v in speeds]
    assert all(g.dtype == torch.int32 and g.dim() == 0 for g in got)
    np.testing.assert_array_equal(np.array([int(g) for g in got]), np.asarray(ref))
    assert len(set(np.asarray(ref).tolist())) == maxn  # every split is reached
    # the host read gives the same count
    state = make_dense_state(params, np.zeros((0, 3), np.float32), 4, device="cpu")
    for v, r in zip(speeds, np.asarray(ref)):
        state.max_speed = torch.tensor(v)
        assert substep_count(params, state, cfl, maxn) == r


def test_frames_pick_their_substeps_on_the_device():
    """tests/test_dense.py's check of the JAX frame: a calm frame runs one
    substep, a fast one (max speed 400 at CFL 1.5) three of dt/3 and
    conserves; multi_frame_dense returns the n_sub of every frame as an
    int32 tensor, and the state's device step_index counts their sum."""
    pos = add_fluid_cube(G, (1, 1, 1), (6, 6, 7), 10**9)
    params = _port_params(pos.shape[0])
    state = make_dense_state(params, pos, K, device="cpu")
    n0 = pos.shape[0]
    calm, n_calm = frame_dense(params, state, cfl_target=1.5, max_substeps=4)
    assert n_calm.dtype == torch.int32 and int(n_calm) == 1 and int(calm.step_index) == 1
    fast = make_dense_state(params, pos, K, device="cpu")
    fast.max_speed = torch.tensor(400.0)
    out, n_fast = frame_dense(params, fast, cfl_target=1.5, max_substeps=4)
    assert int(n_fast) == 3 and int(out.step_index) == 3
    assert int(out.table.num_particles()) + int(out.table.lost) == n0
    batched, n_subs = multi_frame_dense(params, make_dense_state(params, pos, K, device="cpu"), 4, cfl_target=0.1,
                                        max_substeps=4)
    assert n_subs.dtype == torch.int32 and n_subs.shape == (4,) and n_subs.max() > 1
    assert batched.step_index.dtype == torch.int32 and int(batched.step_index) == int(n_subs.sum())
    assert int(batched.table.num_particles()) + int(batched.table.lost) == n0


def test_solids_raise():
    """Solids that do not fit the grid raise (solids of the right shape run:
    tests/test_torch_solids.py)."""
    params = _port_params(_pos().shape[0])
    state = make_dense_state(params, _pos(), K, device="cpu")
    with pytest.raises(ValueError, match="do not fit the grid"):
        step_core(params, state, np.float32(DT), solids=SolidState.empty((8, 8, 8), "cpu"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "blub_tpu_torch").rglob("*.py"))
    smoke = REPO / "chip_smoke.py"
    if smoke.exists():
        files.append(smoke)
    assert files
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "blub_tpu"), f"{f} imports {name}"
