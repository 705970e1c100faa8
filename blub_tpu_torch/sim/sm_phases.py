"""Marker from the P2G fluid counts (port of
``blub_tpu/sim/sm_phases.py::marker_from_counts``)."""

from __future__ import annotations

import torch

from ..core.types import CELL_AIR, CELL_FLUID, CELL_SOLID
from .gridops import border_mask


def marker_from_counts(fluid_count: torch.Tensor, grid_dim, solid_occupancy=None, x_start: int = 0) -> torch.Tensor:
    """int8[X,Y,Z] marker: FLUID where a particle's primal cell is the cell,
    SOLID on the border ring and where ``solid_occupancy`` is non-zero, AIR
    elsewhere. On a mesh shard ``fluid_count`` is the x-slab of the
    ``grid_dim`` domain starting at ``x_start``, and the ring is the
    domain's."""
    fluid = fluid_count > 0.5
    dev = fluid.device
    # filled from host scalars: a constant tensor made on the host would be
    # copied to the card and wait for it
    marker = torch.full(fluid.shape, CELL_AIR, dtype=torch.int8, device=dev).masked_fill_(fluid, CELL_FLUID)
    solid = border_mask(grid_dim, dev, x_start, fluid.shape[0])
    if solid_occupancy is not None:
        solid = solid | (solid_occupancy != 0.0)
    return marker.masked_fill_(solid, CELL_SOLID)
