"""Matrix-free PCG pressure solve with the Incomplete-Poisson preconditioner:
the plain PyTorch version (port of ``blub_tpu/sim/pressure.py``, line for
line). The persistent CUDA kernel of ``ops/pcg.py`` computes the same solve.

- A is applied only at FLUID cells; diag = number of non-solid neighbours;
  off-diagonal -1 toward FLUID neighbours (pressure.glsl:35-77).
- Preconditioner M^-1 = K K^T, K = I - L D^-1, as two opposite-triangle
  sweeps (pressure_apply_preconditioner.comp, symmetric variant).
- alpha/beta guards +-1e-10 (pressure_reduce.comp:26,76-81).
- Convergence: max |r| < tolerance/dt, checked at iterations with
  ``i % freq == 0 or i == max_iter - 1``.
- Warm start: previous pressure, zeroed outside fluid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.config import SolverConfig
from ..core.types import CELL_FLUID, SolverStats
from .gridops import AXES, neg, shift

_EPS = 1e-10


@dataclasses.dataclass
class PressureSolveResult:
    pressure: torch.Tensor
    stats: SolverStats
    # with_history: f32[max_num_iterations] of max|r| x dt at every iteration,
    # +inf past the exit iteration; None in production solves
    history: Optional[torch.Tensor] = None


def solve_tolerance(config: SolverConfig, dt) -> float:
    """The residual bound max|r| < tolerance / dt, in f32."""
    return float(np.float32(config.error_tolerance) / np.float32(dt))


def is_check_iteration(i: int, config: SolverConfig) -> bool:
    freq = max(config.error_check_frequency, 1)
    return i % freq == 0 or i == config.max_num_iterations - 1


def diag_coefficients(marker: torch.Tensor) -> torch.Tensor:
    """Count of non-solid cells among the 6 neighbours (out of domain reads
    SOLID)."""
    markerf = marker.to(torch.float32)
    d = torch.zeros_like(markerf)
    for ax in AXES:
        d = d + torch.abs(shift(markerf, ax)) + torch.abs(shift(markerf, neg(ax)))
    return d


def neighbor_fluid_masks(marker: torch.Tensor):
    return neighbor_masks(marker == CELL_FLUID)


def neighbor_masks(fluid: torch.Tensor):
    """(pos, neg): per axis, whether the +1 / -1 neighbour is fluid (out of
    domain: not)."""
    return [shift(fluid, ax) for ax in AXES], [shift(fluid, neg(ax)) for ax in AXES]


def apply_A(x, fluid, diag, nbr_pos, nbr_neg):
    acc = diag * x
    for c, ax in enumerate(AXES):
        acc = acc - torch.where(nbr_pos[c], shift(x, ax), 0.0)
        acc = acc - torch.where(nbr_neg[c], shift(x, neg(ax)), 0.0)
    return torch.where(fluid, acc, 0.0)


def precondition(r, fluid, diag, nbr_pos, nbr_neg):
    """t = K^T r: t_i = r_i + (sum of upper fluid nbr r_j) / d_i;
    z = K t: z_i = t_i + sum of lower fluid nbr t_j / d_j."""
    dsafe = torch.where(diag > 0.0, diag, 1.0)
    up = torch.zeros_like(r)
    for c, ax in enumerate(AXES):
        up = up + torch.where(nbr_pos[c], shift(r, ax), 0.0)
    t = torch.where(fluid, r + up / dsafe, 0.0)
    td = t / dsafe
    lo = torch.zeros_like(r)
    for c, ax in enumerate(AXES):
        lo = lo + torch.where(nbr_neg[c], shift(td, neg(ax)), 0.0)
    return torch.where(fluid, t + lo, 0.0)


def guarded_div(num, den):
    """num / (den +- 1e-10), sign-matched like the reference reduce shader."""
    return num / (den + torch.where(den < 0.0, -_EPS, _EPS))


def k1_step(z, s_old, beta, fluid, diag, nbr_pos, nbr_neg):
    """The first half of an iteration (the k1 pass of ``ops/csrc/pcg.cu``):
    s = z + beta s_old, As = A s and s.As (alpha = sigma / s.As is the k2
    pass's). -> (s, As, s.As)."""
    s = z + beta * s_old
    As = apply_A(s, fluid, diag, nbr_pos, nbr_neg)
    return s, As, torch.sum(s * As)


def k2_step(p, r, s, As, alpha, fluid, diag, nbr_pos, nbr_neg):
    """The second half (the k2 pass): p + alpha s, r - alpha As, z = K K^T r
    and sigma = z.r. -> (p, r, z, sigma)."""
    p = p + alpha * s
    r = r - alpha * As
    z = precondition(r, fluid, diag, nbr_pos, nbr_neg)
    return p, r, z, torch.sum(z * r)


def solve_pressure_plain(
    initial_pressure, rhs, marker, config: SolverConfig, dt, with_history: bool = False
) -> PressureSolveResult:
    """PCG solve of A p = rhs on fluid cells; the host reads max|r| only at
    the check iterations. ``with_history=True`` takes max|r| at every
    iteration, records it and uses that value for the check (as the JAX XLA
    solver does), and returns it x dt in ``history``, +inf past the exit."""
    fluid = marker == CELL_FLUID
    diag = diag_coefficients(marker)
    ops = (fluid, diag) + neighbor_fluid_masks(marker)
    tol = solve_tolerance(config, dt)
    max_iter = config.max_num_iterations

    p = torch.where(fluid, initial_pressure, 0.0)
    r = torch.where(fluid, rhs - apply_A(p, *ops), 0.0)
    z = precondition(r, *ops)
    s = torch.zeros_like(z)  # beta = 0: the first direction is z
    beta = torch.zeros((), dtype=torch.float32, device=rhs.device)
    sigma = torch.sum(z * r)
    err = torch.tensor(float("inf"), dtype=torch.float32, device=rhs.device)
    hist = torch.full((max_iter,), float("inf"), device=rhs.device) if with_history else None
    i = 0
    while i < max_iter:
        s, As, sAs = k1_step(z, s, beta, *ops)
        alpha = guarded_div(sigma, sAs)
        p, r, z, sigma_new = k2_step(p, r, s, As, alpha, *ops)
        check = is_check_iteration(i, config)
        if with_history:
            hist[i] = torch.max(torch.abs(r))
            if check:
                err = hist[i]
        elif check:
            err = torch.max(torch.abs(r))
        beta = guarded_div(sigma_new, sigma)
        sigma = sigma_new
        i += 1
        if check and err.item() < tol:
            break
    stats = SolverStats(error=(err * float(dt)).to(torch.float32),
                        iterations=torch.tensor(i, dtype=torch.int32, device=rhs.device))
    return PressureSolveResult(pressure=p, stats=stats, history=hist * float(dt) if with_history else None)
