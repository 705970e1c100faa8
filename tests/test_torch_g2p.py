"""The port's G2P (blub_tpu_torch/ops/g2p.py) against the slot-major XLA
oracles sm_phases.advect_slot_major and correct_slot_major, through
convert.py.

Valid bits exact; rel16 positions within one 2^-13 quantum (the oracle's
operation order differs in a few places, e.g. its step-length norm);
bf16 velocity/affine pairs within one bf16 ulp; max speed close."""


import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blub_tpu.core.seeding import add_fluid_cube
from blub_tpu.sim import slot_major as jsm
from blub_tpu.sim import table as jtable
from blub_tpu.sim.sm_phases import advect_slot_major, correct_slot_major
from blub_tpu_torch import convert
from blub_tpu_torch.core.types import SolidState
from blub_tpu_torch.ops import g2p
from blub_tpu_torch.sim.slot_major import unpack_dyn, unpack_posq
from blub_tpu_torch.testing import z_wall_inputs

# small tensors: one intra-op thread avoids contending with XLA's CPU pool
torch.set_num_threads(1)

G = (16, 8, 8)
K = 16
DT = np.float32(1.0 / 120.0)


def _jax_table(seed):
    rng = np.random.default_rng(seed)
    pos = add_fluid_cube(G, (1, 1, 1), (8, 6, 7), 10**9)
    pos = np.clip(pos + rng.uniform(-0.45, 0.45, pos.shape).astype(np.float32), 1.001, np.array(G) - 1.001)
    tab = jtable.from_positions(pos, G, K)
    valid = np.asarray(tab.valid)[..., None]
    tab = dataclasses.replace(
        tab,
        vel=jnp.asarray(rng.standard_normal(valid.shape[:-1] + (3,)).astype(np.float32) * 5 * valid),
        affine=jnp.asarray(rng.standard_normal(valid.shape[:-1] + (3, 3)).astype(np.float32) * valid[..., None]),
    )
    return jsm.from_table(tab)


def _faces(rng, scale):
    """Face grids with the border faces (index dim-1 along the face axis)
    zero, as every P2G/gridfix output has them."""
    out = []
    for c in range(3):
        g = (rng.standard_normal(G) * scale).astype(np.float32)
        idx = [slice(None)] * 3
        idx[c] = -1
        g[tuple(idx)] = 0.0
        out.append(g)
    return out


def _marker(rng):
    m = np.where(rng.random(G) < 0.7, 1, -1).astype(np.int8)
    m[0], m[-1], m[:, 0], m[:, -1], m[:, :, 0], m[:, :, -1] = 0, 0, 0, 0, 0, 0
    return m


def _assert_positions_close(got_posq, ref):
    ref_posq = convert.table_from_jax(ref.posq, ref.dyn, ref.lost, G, device="cpu").posq
    g = unpack_posq(got_posq[:, 0], got_posq[:, 1])
    r = unpack_posq(ref_posq[:, 0], ref_posq[:, 1])
    np.testing.assert_array_equal(g[3].numpy(), r[3].numpy())  # valid bits
    for a in range(3):
        assert (g[a] - r[a]).abs().max().item() <= 1, f"axis {a} differs by more than one quantum"
    assert torch.all(got_posq.permute(0, 2, 3, 4, 1)[r[3] == 0] == 0)  # empty slots all-zero
    return ref_posq


@pytest.fixture(scope="module")
def jitted():
    adv = jax.jit(lambda sm, v, dt: advect_slot_major(sm, v, None, None, dt))
    cor = jax.jit(correct_slot_major)
    return adv, cor


@pytest.mark.parametrize("seed", [0, 1])
def test_advect_matches_oracle(jitted, seed):
    rng = np.random.default_rng(100 + seed)
    sm = _jax_table(seed)
    vel = _faces(rng, 60.0)
    ref = jitted[0](sm, tuple(jnp.asarray(v) for v in vel), jnp.float32(DT))
    port = convert.table_from_jax(sm.posq, sm.dyn, sm.lost, G, device="cpu")
    posq, dyn, max_speed = g2p.advect(port.posq, [torch.from_numpy(v) for v in vel], DT)
    _assert_positions_close(posq, ref)
    ref_dyn = convert.table_from_jax(ref.posq, ref.dyn, ref.lost, G, device="cpu").dyn
    gv, ga = unpack_dyn([dyn[:, c] for c in range(6)])
    rv, ra = unpack_dyn([ref_dyn[:, c] for c in range(6)])
    for g, r in zip(gv + ga, rv + ra):
        tol = 2.0 ** -7 * torch.maximum(g.abs(), r.abs()) + 1e-6
        assert torch.all((g - r).abs() <= tol)
    # the oracle table stores bf16 velocities; the port's max speed is taken
    # before the bf16 store
    assert max_speed.item() == pytest.approx(float(ref.max_speed()), rel=2.0 ** -7)
    assert max_speed.item() > 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_correct_matches_oracle(jitted, seed):
    rng = np.random.default_rng(200 + seed)
    sm = _jax_table(seed + 10)
    change = _faces(rng, 0.3)
    marker = _marker(rng)
    ref = jitted[1](sm, tuple(jnp.asarray(c) for c in change), jnp.asarray(marker))
    port = convert.table_from_jax(sm.posq, sm.dyn, sm.lost, G, device="cpu")
    posq = g2p.correct(port.posq, [torch.from_numpy(c) for c in change], torch.from_numpy(marker))
    _assert_positions_close(posq, ref)



# -- reads past the z walls ------------------------------------------------
#
# The JAX oracle reads z over its table's lane-padded extent zpad(Z): past
# Z it reads zeros, unless Z is a multiple of 128 (then z is cyclic). Here
# solids touch both z walls, the face and change grids are random up to
# their borders, the marker is not SOLID on the z walls, and the pool fills
# the z bins 0 and Z-1 (positions from 0.5 to Z + 0.5 along z, beyond the
# wall clamps), so every kind of z read of the port meets the rule: at
# Z = 16 (zero reads) and at 8x8x128 (cyclic reads).

WALL_CASES = [((24, 16, 16), 8), ((8, 8, 128), 4)]


def _wall_inputs(grid, k, seed):
    d = z_wall_inputs(grid, k, seed)
    return d["table"], d["occupancy"], d["solid_velocity"], d["faces"], d["change"], d["marker"]


def _jax_sm(table):
    t = convert.table_to_jax(table)
    return jsm.SlotMajorTable(posq=jnp.asarray(t["posq"]), dyn=jnp.asarray(t["dyn"]), lost=jnp.int32(t["lost"]),
                              grid_dim=tuple(table.grid_dim))


def _assert_wall_close(got_posq, ref, grid):
    ref_posq = convert.table_from_jax(ref.posq, ref.dyn, ref.lost, grid, device="cpu").posq
    g = unpack_posq(got_posq[:, 0], got_posq[:, 1])
    r = unpack_posq(ref_posq[:, 0], ref_posq[:, 1])
    np.testing.assert_array_equal(g[3].numpy(), r[3].numpy())  # valid bits
    for a in range(3):
        assert (g[a] - r[a]).abs().max().item() <= 1, f"axis {a} differs by more than one quantum"
    return ref_posq


@pytest.mark.parametrize("grid,k", WALL_CASES, ids=["Z16", "Z128"])
def test_advect_with_solids_on_the_z_walls(grid, k, monkeypatch):
    table, occ, vel, faces, _, _ = _wall_inputs(grid, k, 40)
    s = convert.solids_to_jax(SolidState(occupancy=occ, velocity=vel))
    ref = jax.jit(advect_slot_major)(_jax_sm(table), tuple(jnp.asarray(f.numpy()) for f in faces),
                                     jnp.asarray(s["occupancy"]), jnp.asarray(s["velocity"]), jnp.float32(DT))
    args = (table.posq, faces, DT, occ, vel)
    posq, dyn, _ = g2p.advect_plain(*args)
    _assert_wall_close(posq, ref, grid)
    ref_dyn = convert.table_from_jax(ref.posq, ref.dyn, ref.lost, grid, device="cpu").dyn
    gv, ga = unpack_dyn([dyn[:, c] for c in range(6)])
    rv, ra = unpack_dyn([ref_dyn[:, c] for c in range(6)])
    vel_atol = 2.0 ** -19 / DT  # tests/test_torch_solids.py: a penetrating particle's velocity
    for i, (x, y) in enumerate(zip(gv + ga, rv + ra)):
        atol = vel_atol if i < 3 else 1e-6
        assert torch.all((x - y).abs() <= 2.0 ** -7 * torch.maximum(x.abs(), y.abs()) + atol)
    # the inputs reach the walls: reading z cyclically changes the result at
    # Z = 16 and nothing at Z = 128
    monkeypatch.setattr(g2p, "zpad", lambda z: z)
    cyclic = g2p.advect_plain(*args)[0]
    assert torch.equal(cyclic, posq) == (grid[2] % 128 == 0)


@pytest.mark.parametrize("grid,k", WALL_CASES, ids=["Z16", "Z128"])
def test_correct_on_the_z_walls(grid, k, monkeypatch):
    table, _, _, _, change, marker = _wall_inputs(grid, k, 41)
    ref = jax.jit(correct_slot_major)(_jax_sm(table), tuple(jnp.asarray(c.numpy()) for c in change),
                                      jnp.asarray(marker.numpy()))
    posq = g2p.correct(table.posq, change, marker)
    _assert_wall_close(posq, ref, grid)
    # as for advect: the z rule shows at Z = 16 only
    monkeypatch.setattr(g2p, "zpad", lambda z: z)
    assert torch.equal(g2p.correct(table.posq, change, marker), posq) == (grid[2] % 128 == 0)
