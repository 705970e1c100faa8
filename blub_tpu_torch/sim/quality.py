"""Physics-quality numbers of a state (port of ``bench.py::physics_quality``):
the velocity solve's exit residual and the density drift of the interior
fluid.

``density_drift`` computes what the JAX bench computes: ``interior`` is a
FLUID cell whose six neighbours are FLUID (out-of-domain reads are SOLID,
``gridops.shift``'s fill), ``err = rho / DENSITY0 - 1`` there and 0
elsewhere, and it returns the mean of ``err`` over max(interior count, 1),
max |err| and the count, on the table's device. The density and the marker
come from one density-mode P2G launch (``dense_transfer.density_and_marker``;
the plain version on the CPU). On the mesh (``phases`` a
``parallel/sharded_sm.ShardedPhases``) each rank works on its slab: the
density and marker from the provider's phases, the x neighbours of the
slab's edge planes from ``halo1``, and the sum and count all-reduced (SUM),
the max (MAX), so every rank returns the whole grid's numbers.
``physics_quality`` reads them and the velocity solve's error on the host
once, at the end, and rounds them as the bench does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..core.types import CELL_FLUID
from .dense_transfer import density_and_marker
from .density import DENSITY0
from .gridops import AXES, neg, shift


class Drift(NamedTuple):
    """0-d tensors on the table's device: the mean and max |rho / rho0 - 1|
    over the interior fluid cells (f32), and their count (int32)."""

    mean: torch.Tensor
    max: torch.Tensor
    interior: torch.Tensor


def interior_cells(marker: torch.Tensor, ext: torch.Tensor | None = None) -> torch.Tensor:
    """bool: FLUID cells of ``marker`` whose six neighbours are FLUID.
    ``ext``: the marker with one x plane each side (a mesh slab's halo),
    which supplies the x neighbours of the edge planes; else they are read
    as SOLID past the grid."""
    src, lo = (marker, 0) if ext is None else (ext, 1)
    xl = marker.shape[0]
    interior = marker == CELL_FLUID
    for ax in AXES:
        for off in (ax, neg(ax)):
            interior = interior & (shift(src, off).narrow(0, lo, xl) == CELL_FLUID)
    return interior


def density_drift(table, phases=None) -> Drift:
    """Signed mean and max |rho / rho0 - 1| over the interior fluid cells of
    ``table`` (bench.py:70-79), with their count. ``phases``: None for the
    whole grid, or the mesh's ``ShardedPhases`` with ``table`` this rank's
    slab (every rank must call)."""
    if phases is None:
        return drift_of(*density_and_marker(table))
    acc = phases.p2g_density(table.posq)
    marker = phases.marker(acc[1], None)
    return drift_of(acc[0], marker, phases.halo1(marker), phases.ctx)


def drift_of(rho: torch.Tensor, marker: torch.Tensor, ext: torch.Tensor | None = None, ctx=None) -> Drift:
    """``density_drift`` from the raw density and the marker (``ext``: the
    marker with a halo plane each side; ``ctx``: the mesh's ``ShardCtx``,
    whose ranks' sums, counts and maxima are all-reduced)."""
    interior = interior_cells(marker, ext)
    err = torch.where(interior, rho / DENSITY0 - 1.0, 0.0)
    total, count, worst = err.sum(), interior.sum(dtype=torch.int32), err.abs().max()
    if ctx is not None:
        total, count, worst = (t.reshape(1) for t in (total, count, worst))
        ctx.all_reduce(total)
        ctx.all_reduce(count)
        ctx.all_reduce(worst, dist.ReduceOp.MAX)
        total, count, worst = (t.reshape(()) for t in (total, count, worst))
    mean = total / torch.clamp(count, min=1).to(torch.float32)
    return Drift(mean=mean, max=worst, interior=count)


def physics_quality(state, solver_tolerance: float, phases=None) -> dict:
    """``bench.py::physics_quality`` of a ``DenseFluidState``: max_divergence
    (the velocity solve's exit error), solver_converged (that error within
    ``solver_tolerance``), density_drift_pct and density_err_max_pct, rounded
    as the bench rounds them. One host read, at the end."""
    drift = density_drift(state.table, phases)
    mean, worst, max_div = torch.stack([drift.mean, drift.max, state.stats_vel.error]).tolist()
    return {
        "max_divergence": round(max_div, 5),
        "solver_converged": bool(max_div <= solver_tolerance),
        "density_drift_pct": round(100.0 * mean, 3),
        "density_err_max_pct": round(100.0 * worst, 2),
    }
