"""The port's rebin pack (blub_tpu_torch/ops/rebin.py) against the
independent per-cell placement simulator of tests/test_rebin_overflow_spec.py
(bit for bit, overflow included) and against sim/table.py::rebin (per-cell
particle multisets, when nothing overflows)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blub_tpu.core.seeding import add_fluid_cube
from blub_tpu.sim import slot_major as jsm
from blub_tpu.sim import table as jtable
from blub_tpu_torch import convert
from blub_tpu_torch.ops import rebin
from blub_tpu_torch.sim.slot_major import CH_ZV
from test_rebin_overflow_spec import _decode, _encode, _pack_axis_spec, _rebin_spec

# small tensors: one intra-op thread avoids contending with XLA's CPU pool
torch.set_num_threads(1)

G = (12, 8, 8)


def _jax_table(k, seed, amp, per_cell=8, pull=True, crowd=None):
    """Seeded cube moved by up to ``amp`` cells, toward one point (``pull``:
    genuinely overflows small capacities) or at random. ``crowd``: that many
    particles per cell of the cube on average, at random, instead of its
    8-per-cell lattice."""
    rng = np.random.default_rng(seed)
    if crowd is None:
        pos = add_fluid_cube(G, (1, 1, 1), (9, 7, 7), 10**9)
    else:
        lo, hi = np.float32([1.5, 1.5, 1.5]), np.float32([9.5, 7.5, 7.5])
        pos = rng.uniform(lo, hi, (int(crowd * np.prod(hi - lo)), 3)).astype(np.float32)
    tab = jtable.from_positions(pos, G, k)
    valid = np.asarray(tab.valid).copy()
    valid[..., per_cell:] = False
    vel = rng.standard_normal(valid.shape + (3,)).astype(np.float32) * 10 * valid[..., None]
    aff = rng.standard_normal(valid.shape + (3, 3)).astype(np.float32) * valid[..., None, None]
    p = np.asarray(tab.pos)
    if pull:
        d = np.clip(np.float32([4.3, 3.7, 4.1]) - p, -amp, amp)
    else:
        d = rng.uniform(-amp, amp, p.shape).astype(np.float32)
    newpos = np.clip(p + d * valid[..., None], 1.001, np.array(G, np.float32) - 1.001)
    newpos = (np.round(newpos * np.float32(8192.0)) * np.float32(2.0 ** -13)).astype(np.float32)
    tab = dataclasses.replace(
        tab, pos=jnp.asarray(newpos * valid[..., None]), vel=jnp.asarray(vel), affine=jnp.asarray(aff),
        valid=jnp.asarray(valid),
    )
    return jsm.from_table(tab)


def _port(sm):
    return convert.table_from_jax(sm.posq, sm.dyn, sm.lost, G, device="cpu")


@pytest.mark.parametrize("axis,s,k_in,k_out", [(0, 2, 4, 8), (1, 2, 8, 8), (2, 1, 8, 4), (2, 2, 6, 4)])
def test_stage_matches_spec(axis, s, k_in, k_out):
    sm = _jax_table(k_in, seed=axis, amp=1.9 if s == 2 else 0.9)
    t = _port(sm)
    posq_f = t.posq.numpy().view(np.float32)
    pos, valid = _decode(posq_f)
    dyn = t.dyn.numpy()
    exp_pos, exp_valid, exp_dyn, exp_drop = _pack_axis_spec(pos, valid, dyn, axis, s, k_out, G[axis])
    got_p, got_d, dropped, kept = rebin.pack(t.posq, t.dyn, axis, s, k_out)
    np.testing.assert_array_equal(got_p.numpy(), _encode(exp_pos, exp_valid).view(np.int32))
    np.testing.assert_array_equal(got_d.numpy(), exp_dyn)
    assert dropped.item() == exp_drop
    assert kept.item() == int(exp_valid.sum())


@pytest.mark.parametrize("s,slack,amp,seed", [(2, 4, 1.9, 5), (1, 2, 0.9, 7)])
def test_rebin_matches_spec_with_overflow(s, slack, amp, seed):
    k = 4
    sm = _jax_table(k, seed=seed, amp=amp)
    exp_p, exp_d, exp_drop = _rebin_spec(sm, s, slack)
    t = _port(sm)
    n0 = t.num_particles()
    posq, dyn, _, _ = rebin.pack(t.posq, t.dyn, 0, s, k + slack)
    posq, dyn, lost = rebin.rebin_yz(posq, dyn, s, k, t.lost, n0)
    np.testing.assert_array_equal(posq.numpy(), exp_p.view(np.int32))
    np.testing.assert_array_equal(dyn.numpy(), exp_d.view(np.int32))
    assert lost.item() - t.lost.item() == exp_drop > 0


# beyond 32 slots (the card's packs then keep 64-bit masks): crowded cells,
# pulled together so that every stage overflows
@pytest.mark.parametrize("axis,s,k_in,k_out", [(0, 2, 40, 44), (1, 2, 44, 44), (2, 1, 44, 40)])
def test_stage_at_40_slots_matches_spec(axis, s, k_in, k_out):
    sm = _jax_table(k_in, seed=30 + axis, amp=1.9 if s == 2 else 0.9, per_cell=k_in, crowd=36)
    t = _port(sm)
    assert (t.posq[:, CH_ZV] & 1).sum(0).max().item() > 32
    pos, valid = _decode(t.posq.numpy().view(np.float32))
    dyn = t.dyn.numpy()
    exp_pos, exp_valid, exp_dyn, exp_drop = _pack_axis_spec(pos, valid, dyn, axis, s, k_out, G[axis])
    got_p, got_d, dropped, kept = rebin.pack(t.posq, t.dyn, axis, s, k_out)
    np.testing.assert_array_equal(got_p.numpy(), _encode(exp_pos, exp_valid).view(np.int32))
    np.testing.assert_array_equal(got_d.numpy(), exp_dyn)
    assert dropped.item() == exp_drop > 0
    assert kept.item() == int(exp_valid.sum())


def test_rebin_at_40_slots_matches_spec_with_overflow():
    """x (40 -> 44 slots), then y + z in one pack_yz (-> 40)."""
    k, s, slack = 40, 2, 4
    sm = _jax_table(k, seed=33, amp=1.9, per_cell=k, crowd=36)
    exp_p, exp_d, exp_drop = _rebin_spec(sm, s, slack)
    t = _port(sm)
    posq, dyn, _, _ = rebin.pack(t.posq, t.dyn, 0, s, k + slack)
    posq, dyn, counts = rebin.pack_yz(posq, dyn, s, k)
    np.testing.assert_array_equal(posq.numpy(), exp_p.view(np.int32))
    np.testing.assert_array_equal(dyn.numpy(), exp_d.view(np.int32))
    assert t.num_particles().item() - counts[3].item() == exp_drop > 0


def _cells(pos, vel, aff, valid):
    """{cell: rows sorted} of a [X,Y,Z,K,...] table."""
    out = {}
    rows = np.concatenate([pos, vel, aff.reshape(aff.shape[:4] + (9,))], axis=-1)
    for cell in np.ndindex(valid.shape[:3]):
        r = rows[cell][valid[cell]]
        out[cell] = r[np.lexsort(r.T[::-1])] if len(r) else r
    return out


@pytest.mark.parametrize("s,amp", [(2, 1.9), (1, 0.9)])
def test_rebin_multisets_match_table_rebin(s, amp):
    k, slack = 12, 4
    sm = _jax_table(k, seed=11 + s, amp=amp, per_cell=3, pull=False)
    ref = jax.jit(lambda t: jtable.rebin(t, s, slack))(jsm.to_table(sm))
    t = _port(sm)
    posq, dyn, _, _ = rebin.pack(t.posq, t.dyn, 0, s, k + slack)
    posq, dyn, lost = rebin.rebin_yz(posq, dyn, s, k, t.lost, t.num_particles())
    assert lost.item() == int(ref.lost) == 0
    out = convert.table_to_jax(dataclasses.replace(t, posq=posq, dyn=dyn, lost=lost))
    got = jsm.to_table(jsm.SlotMajorTable(
        posq=jnp.asarray(out["posq"]), dyn=jnp.asarray(out["dyn"]), lost=jnp.int32(out["lost"]), grid_dim=G
    ))
    a = _cells(*(np.asarray(x) for x in (got.pos, got.vel, got.affine, got.valid)))
    b = _cells(*(np.asarray(x) for x in (ref.pos, ref.vel, ref.affine, ref.valid)))
    moved = 0
    for cell in a:
        np.testing.assert_array_equal(a[cell], b[cell])
        moved += len(a[cell])
    assert moved == t.num_particles().item()



def test_rebin_at_40_slots_multisets_match_table_rebin():
    """Crowded cells at K=40 that nothing overflows: the per-cell particle
    multisets of the port's rebin equal the XLA oracle's."""
    k, s, slack = 40, 1, 4
    sm = _jax_table(k, seed=34, amp=0.9, per_cell=k, pull=False, crowd=24)
    ref = jax.jit(lambda t: jtable.rebin(t, s, slack))(jsm.to_table(sm))
    t = _port(sm)
    assert (t.posq[:, CH_ZV] & 1).sum(0).max().item() > 32
    posq, dyn, _, _ = rebin.pack(t.posq, t.dyn, 0, s, k + slack)
    posq, dyn, lost = rebin.rebin_yz(posq, dyn, s, k, t.lost, t.num_particles())
    assert lost.item() == int(ref.lost) == 0
    out = convert.table_to_jax(dataclasses.replace(t, posq=posq, dyn=dyn, lost=lost))
    got = jsm.to_table(jsm.SlotMajorTable(
        posq=jnp.asarray(out["posq"]), dyn=jnp.asarray(out["dyn"]), lost=jnp.int32(out["lost"]), grid_dim=G
    ))
    a = _cells(*(np.asarray(x) for x in (got.pos, got.vel, got.affine, got.valid)))
    b = _cells(*(np.asarray(x) for x in (ref.pos, ref.vel, ref.affine, ref.valid)))
    for cell in a:
        np.testing.assert_array_equal(a[cell], b[cell])


@pytest.mark.parametrize("grid,k,slack", [((16, 8, 8), 16, 4), ((128, 64, 64), 14, 1)])
def test_default_slack_matches_jax(grid, k, slack):
    """Slack 4 at test scale, 1 at the dam cell, in both packages (the JAX
    caller counts z padded to 128 lanes, the port the unpadded table)."""
    from blub_tpu.ops.pallas_rebin import default_slack as jax_default_slack
    from blub_tpu.sim.slot_major import zpad
    from blub_tpu_torch.sim.slot_major import BYTES_PER_SLOT

    x, y, z = grid
    assert rebin.default_slack(k * BYTES_PER_SLOT * x * y * z, k) == slack
    assert jax_default_slack(k * 8 * x * y * zpad(z) * 4, k) == slack
