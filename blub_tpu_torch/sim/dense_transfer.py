"""Density-error right-hand side from the raw P2G density (port of
``blub_tpu/sim/dense_transfer.py::density_rhs_from_raw``;
density_projection_gather_error.comp)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import CELL_AIR, CELL_FLUID, CELL_SOLID
from .density import DENSITY0, SOLID_NEIGHBOR_CONTRIBUTION
from .gridops import AXES, neg, shift


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
