"""The port's P2G (blub_tpu_torch/ops/p2g.py) and the dense grid math around
it against the JAX package's XLA oracles: dense_transfer.p2g_velocity_dense,
p2g_density_dense and marker_from_table on to_table(sm).

Grids are f32-close (rtol 1e-5, atol 1e-5: the sums run in another order
than XLA's), counts and the marker exact."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blub_tpu.core.seeding import add_fluid_cube
from blub_tpu.sim import slot_major as jsm
from blub_tpu.sim import table as jtable
from blub_tpu.sim.dense_transfer import (
    density_rhs_from_raw as jax_density_rhs,
    marker_from_table,
    p2g_density_dense,
    p2g_velocity_dense,
)
from blub_tpu.sim.divergence import compute_divergence_rhs as jax_div_rhs
from blub_tpu_torch import convert
from blub_tpu_torch.ops import p2g
from blub_tpu_torch.sim.dense_transfer import density_rhs_from_raw
from blub_tpu_torch.sim.divergence import compute_divergence_rhs
from blub_tpu_torch.sim.sm_phases import marker_from_counts

# small tensors: one intra-op thread avoids contending with XLA's CPU pool
torch.set_num_threads(1)

G = (16, 8, 8)
K = 16
GRAV = (0.0, -981.0, 0.0)
DT = np.float32(1.0 / 120.0)


def _jax_table(seed, k=K, crowd=None):
    """Seeded cube jiggled off its cells (or, with ``crowd``, that many
    particles per cell of it on average at random), random velocities/affine
    rows, stored through the slot-major bf16 encoding."""
    rng = np.random.default_rng(seed)
    if crowd is None:
        pos = add_fluid_cube(G, (1, 1, 1), (8, 6, 7), 10**9)
    else:
        lo, hi = np.float32([1.5, 1.5, 1.5]), np.float32([8.5, 6.5, 7.5])
        pos = rng.uniform(lo, hi, (int(crowd * np.prod(hi - lo)), 3)).astype(np.float32)
    pos = np.clip(pos + rng.uniform(-0.45, 0.45, pos.shape).astype(np.float32), 1.001, np.array(G) - 1.001)
    tab = jtable.from_positions(pos, G, k)
    valid = np.asarray(tab.valid)[..., None]
    tab = dataclasses.replace(
        tab,
        vel=jnp.asarray(rng.standard_normal(valid.shape[:-1] + (3,)).astype(np.float32) * 5 * valid),
        affine=jnp.asarray(rng.standard_normal(valid.shape[:-1] + (3, 3)).astype(np.float32) * valid[..., None]),
    )
    return jsm.from_table(tab)


@pytest.fixture(scope="module")
def case():
    sm = _jax_table(0)
    oracle = jsm.to_table(sm)
    marker = marker_from_table(oracle, None)
    vel = jax.jit(partial(p2g_velocity_dense, gravity_grid=GRAV, dt=float(DT)))(oracle, marker)
    dens = jax.jit(p2g_density_dense)(oracle)
    port = convert.table_from_jax(sm.posq, sm.dyn, sm.lost, G, device="cpu")
    return dict(sm=sm, marker=np.asarray(marker), vel=[np.asarray(v) for v in vel],
                dens=np.asarray(dens), port=port)


def test_velocity_and_marker_match_oracle(case):
    t = case["port"]
    acc = p2g.p2g(t.posq, t.dyn)
    assert acc.shape == (7,) + G
    marker = marker_from_counts(acc[6], G)
    np.testing.assert_array_equal(marker.numpy(), case["marker"])
    vel = p2g.normalize_velocity(acc, marker, GRAV, DT)
    for c in range(3):
        np.testing.assert_allclose(vel[c].numpy(), case["vel"][c], rtol=1e-5, atol=1e-5)


def test_density_matches_oracle(case):
    t = case["port"]
    dacc = p2g.p2g(t.posq, None, density=True)
    np.testing.assert_allclose(dacc[0].numpy(), case["dens"], rtol=1e-5, atol=1e-5)
    vacc = p2g.p2g(t.posq, t.dyn)
    np.testing.assert_array_equal(dacc[1].numpy(), vacc[6].numpy())
    assert dacc[1].sum().item() == t.num_particles().item()


def test_rhs_phases_match_oracle(case):
    """Divergence and density right-hand sides on the same grids."""
    marker = torch.from_numpy(case["marker"].copy())
    vel = [torch.from_numpy(v) for v in case["vel"]]
    ref = jax_div_rhs(tuple(jnp.asarray(v) for v in case["vel"]), jnp.asarray(case["marker"]), None)
    np.testing.assert_allclose(compute_divergence_rhs(vel, marker).numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)
    ref = jax_density_rhs(jnp.asarray(case["dens"]), jnp.asarray(case["marker"]), float(DT))
    got = density_rhs_from_raw(torch.from_numpy(case["dens"]), marker, DT)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-4)



def test_p2g_at_40_slots_matches_oracle():
    """Cells holding more than 32 particles (the card's kernel keeps them in
    64-bit masks): the plain P2G at K=40 against the XLA oracle."""
    sm = _jax_table(3, k=40, crowd=36)
    oracle = jsm.to_table(sm)
    t = convert.table_from_jax(sm.posq, sm.dyn, sm.lost, G, device="cpu")
    assert t.capacity == 40 and t.posq.shape[0] == 40
    assert (t.posq[:, 1] & 1).sum(0).max().item() > 32
    marker = marker_from_table(oracle, None)
    acc = p2g.p2g(t.posq, t.dyn)
    got_marker = marker_from_counts(acc[6], G)
    np.testing.assert_array_equal(got_marker.numpy(), np.asarray(marker))
    vel = jax.jit(partial(p2g_velocity_dense, gravity_grid=GRAV, dt=float(DT)))(oracle, marker)
    got = p2g.normalize_velocity(acc, got_marker, GRAV, DT)
    for c in range(3):
        np.testing.assert_allclose(got[c].numpy(), np.asarray(vel[c]), rtol=1e-5, atol=1e-5)
    dacc = p2g.p2g(t.posq, None, density=True)
    np.testing.assert_allclose(dacc[0].numpy(), np.asarray(jax.jit(p2g_density_dense)(oracle)), rtol=1e-5, atol=1e-5)
    assert dacc[1].sum().item() == t.num_particles().item()
