"""Divergence right-hand side and pressure-gradient velocity correction
(port of ``blub_tpu/sim/divergence.py``). Velocity component c lives on the
face between cell g and g+e_c, stored at g. ``solid_velocity`` is the
voxelized solid velocity f32[3,X,Y,Z] (``SolidState.velocity``), or None for
static walls (solid velocity 0)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.types import CELL_FLUID, CELL_SOLID
from .gridops import AXES, neg, shift


def compute_divergence_rhs(vel, marker: torch.Tensor, solid_velocity=None) -> torch.Tensor:
    """Staggered divergence at fluid cells plus the solid-wall corrections
    (divergence_compute.comp:28-87): a solid neighbour on the negative side
    adds v_neg - sv_neg, one on the positive side subtracts v_pos - sv_pos."""
    fluid = marker == CELL_FLUID
    div = torch.zeros_like(vel[0])
    for c, ax in enumerate(AXES):
        v_pos = vel[c]
        v_neg = shift(vel[c], neg(ax))
        div = div + v_pos - v_neg
        if solid_velocity is not None:
            wall_neg = v_neg - shift(solid_velocity[c], neg(ax))
            wall_pos = v_pos - shift(solid_velocity[c], ax)
        else:
            wall_neg, wall_pos = v_neg, v_pos
        div = div + torch.where(shift(marker, neg(ax)) == CELL_SOLID, wall_neg, 0.0)
        div = div - torch.where(shift(marker, ax) == CELL_SOLID, wall_pos, 0.0)
    return torch.where(fluid, div, 0.0)


def remove_divergence(vel, pressure, marker, solid_velocity=None) -> Tuple[torch.Tensor, ...]:
    """Subtract the pressure gradient across every fluid-adjacent face
    (divergence_remove.comp); a face whose own cell is SOLID takes the solid
    velocity there, one whose +axis neighbour is SOLID takes the neighbour's,
    faces not adjacent to fluid are zeroed."""
    fluid = marker == CELL_FLUID
    p_fluid = torch.where(fluid, pressure, 0.0)
    out = []
    for c, ax in enumerate(AXES):
        nbr_marker = shift(marker, ax)
        nbr_fluid = nbr_marker == CELL_FLUID
        any_fluid = fluid | nbr_fluid
        corrected = vel[c] - (p_fluid - torch.where(nbr_fluid, shift(p_fluid, ax), 0.0))
        if solid_velocity is not None:
            sv, nbr_sv = solid_velocity[c], shift(solid_velocity[c], ax)
        else:
            sv = nbr_sv = torch.zeros_like(corrected)
        v = torch.where(marker == CELL_SOLID, sv, torch.where(nbr_marker == CELL_SOLID, nbr_sv, corrected))
        out.append(torch.where(any_fluid, v, 0.0))
    return tuple(out)
