"""The density-mode P2G as the JAX package's dense transfer gives it, and the
density-error right-hand side (port of ``blub_tpu/sim/dense_transfer.py``:
``marker_from_table``, ``p2g_density_dense``, ``density_rhs_from_raw``;
density_projection_gather_error.comp).

``marker_from_table`` and ``p2g_density_dense`` both come from one launch of
``ops/p2g.p2g(posq, None, density=True)``: channel 0 is the raw density at
the cell centres, channel 1 the count of particles whose primal cell is the
cell, which ``sm_phases.marker_from_counts`` turns into the marker.
``density_and_marker`` returns both from that one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import CELL_AIR, CELL_FLUID, CELL_SOLID
from ..ops import p2g
from .density import DENSITY0, SOLID_NEIGHBOR_CONTRIBUTION
from .gridops import AXES, neg, shift
from .sm_phases import marker_from_counts


def density_and_marker(table, solid_occupancy=None):
    """-> (raw density f32[X,Y,Z], marker int8[X,Y,Z]) of ``table`` (a
    ``SlotMajorTable``) from one density-mode P2G launch (the plain version
    on the CPU)."""
    acc = p2g.p2g(table.posq, None, density=True)
    return acc[0], marker_from_counts(acc[1], table.grid_dim, solid_occupancy)


def marker_from_table(table, solid_occupancy=None):
    """Marker grid: FLUID where a particle's primal cell is the cell, SOLID on
    the border ring and where ``solid_occupancy`` is non-zero, AIR
    elsewhere."""
    return density_and_marker(table, solid_occupancy)[1]


def p2g_density_dense(table):
    """Raw particle density at the cell centres (dual bins in the 8-offset
    window {-1,0}^3)."""
    return density_and_marker(table)[0]


def density_rhs_from_raw(density, marker, dt):
    """Solid-neighbour contributions, free-surface clamp, +-0.5 clamp, /dt,
    at fluid cells."""
    any_air = torch.zeros(marker.shape, dtype=torch.bool, device=marker.device)
    out = density
    for ax in AXES:
        for off in (ax, neg(ax)):
            nbr = shift(marker, off)
            out = out + torch.where(nbr == CELL_SOLID, SOLID_NEIGHBOR_CONTRIBUTION, 0.0)
            any_air = any_air | (nbr == CELL_AIR)
    out = torch.where(any_air, torch.clamp(out, min=DENSITY0), out)
    rhs = torch.clamp(1.0 - out / DENSITY0, -0.5, 0.5)
    # a true division, as JAX's: PyTorch divides a CUDA tensor by a host
    # scalar through its reciprocal, which can differ by one ulp
    rhs = rhs / torch.full_like(rhs, float(np.float32(dt)))
    return torch.where(marker == CELL_FLUID, rhs, 0.0)
