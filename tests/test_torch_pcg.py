"""The port's PCG solve (blub_tpu_torch/sim/pressure.py, ops/pcg.py) against
the JAX XLA oracle sim/pressure.solve_pressure on a marker and right-hand
side made from a seed.

The iteration count is a 0-d int32 tensor, as in the JAX package, and
equals the oracle's on every case here (f32 dot products summed in another
order could flip a check at the boundary on other inputs; the card's kernel
is held to one check window in tests/test_torch_kernels.py). The pressures
agree to 1e-4 of their scale."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blub_tpu.core.config import SolverConfig as JaxSolverConfig
from blub_tpu.sim import pressure as jp
from blub_tpu_torch.core.config import SolverConfig
from blub_tpu_torch.ops import pcg
from blub_tpu_torch.sim import pressure as tp

# small tensors: one intra-op thread avoids contending with XLA's CPU pool
torch.set_num_threads(1)

G = (16, 8, 8)
DT = np.float32(1.0 / 120.0)


def _problem(seed):
    rng = np.random.default_rng(seed)
    marker = np.where(rng.random(G) < 0.85, 1, -1).astype(np.int8)
    marker[0], marker[-1], marker[:, 0], marker[:, -1], marker[:, :, 0], marker[:, :, -1] = 0, 0, 0, 0, 0, 0
    rhs = np.where(marker == 1, rng.standard_normal(G) * 30, 0).astype(np.float32)
    p0 = rng.standard_normal(G).astype(np.float32)
    return marker, rhs, p0


CONFIGS = [SolverConfig(), SolverConfig(error_tolerance=0.01, max_num_iterations=20, error_check_frequency=3)]


@pytest.fixture(scope="module")
def jax_solve():
    fns = {}

    def solve(cfg, marker, rhs, p0):
        if cfg not in fns:
            jcfg = JaxSolverConfig(**vars(cfg))

            def run(p, r, m, jcfg=jcfg):
                res = jp.solve_pressure(p, r, m, jcfg, float(DT))
                return res.pressure, res.stats.iterations, res.stats.error

            fns[cfg] = jax.jit(run)
        p, it, err = fns[cfg](jnp.asarray(p0), jnp.asarray(rhs), jnp.asarray(marker))
        return np.asarray(p), int(it), float(err)

    return solve


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg", CONFIGS, ids=["default", "tight"])
def test_solve_matches_oracle(jax_solve, seed, cfg):
    marker, rhs, p0 = _problem(seed)
    ref_p, ref_it, ref_err = jax_solve(cfg, marker, rhs, p0)
    res = pcg.solve_pressure(torch.from_numpy(p0), torch.from_numpy(rhs), torch.from_numpy(marker), cfg, DT)
    its = res.stats.iterations
    assert isinstance(its, torch.Tensor) and its.dtype == torch.int32 and its.dim() == 0
    assert int(its) == ref_it
    assert 1 <= int(its) <= cfg.max_num_iterations
    scale = np.abs(ref_p).max()
    np.testing.assert_allclose(res.pressure.numpy(), ref_p, rtol=1e-4, atol=1e-4 * scale)
    assert res.stats.error.item() == pytest.approx(ref_err, rel=1e-3, abs=1e-6)
    if int(its) < cfg.max_num_iterations:
        assert res.stats.error.item() < cfg.error_tolerance
    assert np.all(res.pressure.numpy()[marker != 1] == 0)


def test_operator_pieces_match_oracle():
    marker, rhs, p0 = _problem(5)
    jm = jnp.asarray(marker)
    tm = torch.from_numpy(marker)
    np.testing.assert_array_equal(tp.diag_coefficients(tm).numpy(), np.asarray(jp.diag_coefficients(jm)))
    fluid_j, diag_j = jp.fluid_mask(jm), jp.diag_coefficients(jm)
    pos_j, neg_j = jp.neighbor_fluid_masks(jm)
    fluid_t, diag_t = tm == 1, tp.diag_coefficients(tm)
    pos_t, neg_t = tp.neighbor_fluid_masks(tm)
    x = np.where(marker == 1, rhs, 0).astype(np.float32)
    np.testing.assert_allclose(
        tp.apply_A(torch.from_numpy(x), fluid_t, diag_t, pos_t, neg_t).numpy(),
        np.asarray(jp.apply_A(jnp.asarray(x), fluid_j, diag_j, pos_j, neg_j)), rtol=1e-6, atol=1e-4,
    )
    np.testing.assert_allclose(
        tp.precondition(torch.from_numpy(x), fluid_t, diag_t, pos_t, neg_t).numpy(),
        np.asarray(jp.precondition(jnp.asarray(x), fluid_j, diag_j, pos_j, neg_j)), rtol=1e-6, atol=1e-4,
    )


def test_check_rule():
    cfg = SolverConfig()
    assert [i for i in range(32) if tp.is_check_iteration(i, cfg)] == [0, 4, 8, 12, 16, 20, 24, 28, 31]



HISTORY_CONFIGS = [SolverConfig(error_tolerance=0.01, max_num_iterations=24, error_check_frequency=1),
                   SolverConfig(error_tolerance=0.01, max_num_iterations=24, error_check_frequency=3)]


@pytest.fixture(scope="module")
def jax_history():
    fns = {}

    def solve(cfg, marker, rhs, p0):
        if cfg not in fns:
            jcfg = JaxSolverConfig(**vars(cfg))

            def run(p, r, m, jcfg=jcfg):
                res = jp.solve_pressure(p, r, m, jcfg, float(DT), with_history=True)
                return res.history, res.stats.iterations, res.stats.error

            fns[cfg] = jax.jit(run)
        h, it, err = fns[cfg](jnp.asarray(p0), jnp.asarray(rhs), jnp.asarray(marker))
        return np.asarray(h), int(it), float(err)

    return solve


def _check_history(hist, its, err, cfg):
    """+inf exactly past the exit, finite before it, and the last finite
    entry is the stats error."""
    assert hist.shape == (cfg.max_num_iterations,) and hist.dtype == np.float32
    assert np.all(np.isfinite(hist[:its])) and np.all(np.isposinf(hist[its:]))
    assert hist[its - 1] == np.float32(err)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("cfg", HISTORY_CONFIGS, ids=["freq1", "freq3"])
def test_solve_history_matches_oracle(jax_history, seed, cfg):
    """solve_pressure(with_history=True) on CPU tensors (the plain version)
    against JAX's XLA solver with_history: the same iterations, +inf past
    the exit at the same slots, finite entries within rtol 1e-4; the
    production solve's pressure and iterations are unchanged by the flag."""
    marker, rhs, p0 = _problem(seed)
    ref_h, ref_it, ref_err = jax_history(cfg, marker, rhs, p0)
    args = (torch.from_numpy(p0), torch.from_numpy(rhs), torch.from_numpy(marker), cfg, DT)
    res = pcg.solve_pressure(*args, with_history=True)
    its = int(res.stats.iterations)
    assert its == ref_it
    hist = res.history.numpy()
    _check_history(hist, its, res.stats.error.item(), cfg)
    np.testing.assert_array_equal(np.isposinf(hist), np.isposinf(ref_h))
    np.testing.assert_allclose(hist[:its], ref_h[:its], rtol=1e-4)
    assert ref_h[ref_it - 1] == np.float32(ref_err)
    plain = pcg.solve_pressure(*args)
    assert plain.history is None and int(plain.stats.iterations) == its
    assert torch.equal(plain.pressure, res.pressure) and torch.equal(plain.stats.error, res.stats.error)

