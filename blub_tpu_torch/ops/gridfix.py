"""Grid fix: the face-velocity correction followed by extrapolation, one pass
(port of ``blub_tpu/ops/pallas_gridfix.py::_kernel``).

  mode remove: face velocity minus the pressure gradient
      (``sim/divergence.remove_divergence``); faces into solids take the
      solid velocity, 0 without solids;
  mode change: the position-change field dt * (p_nbr - p)
      (``sim/density.position_change_field``);

then both extrapolate non-fluid faces from their 8 in-plane neighbours
(``sim/extrapolate.extrapolate_velocity``). Out-of-domain reads are zero
(marker 0 = SOLID). ``gridfix_remove``/``gridfix_change`` take the plain
version for CPU tensors and launch ``csrc/gridfix.cu`` for CUDA tensors; a
block of the kernel computes the corrected faces of its tile and their
in-plane halo once, in shared memory, and extrapolates from there. Remove
with a solid velocity launches the kernel's solids specialisation (counted
as ``gridfix_solids``).
"""

from __future__ import annotations

import torch

from ..sim.density import position_change_field
from ..sim.divergence import remove_divergence
from ..sim.extrapolate import extrapolate_velocity
from . import cuda

_P, _I = cuda.P, cuda.I
_SIG = {"gridfix_launch": [_P] * 11 + [cuda.F, _I, _I, _I, _I, _P]}


def _launch(mode: int, vel, pressure, marker, dt, solid_velocity=None):
    shape = tuple(pressure.shape)
    cuda.require(pressure, torch.float32, shape, "gridfix pressure")
    cuda.require(marker, torch.int8, shape, "gridfix marker")
    if vel is not None:
        for c in range(3):
            cuda.require(vel[c], torch.float32, shape, f"gridfix velocity {c}")
    if solid_velocity is not None:
        cuda.require(solid_velocity, torch.float32, (3,) + shape, "gridfix solid velocity")
        sv = [cuda.ptr(solid_velocity[c]) for c in range(3)]
    else:
        sv = [None] * 3  # null: the specialisation without solids
    out = [torch.empty(shape, dtype=torch.float32, device=pressure.device) for _ in range(3)]
    vin = vel if vel is not None else (pressure, pressure, pressure)  # unread in mode change
    lib = cuda.library("gridfix", _SIG)
    P = cuda.ptr
    err = lib.gridfix_launch(
        P(vin[0]), P(vin[1]), P(vin[2]), *sv, P(pressure), P(marker), P(out[0]), P(out[1]), P(out[2]),
        float(dt), mode, *shape, cuda.stream(),
    )
    cuda.count_launch("gridfix" if solid_velocity is None else "gridfix_solids")
    cuda.check(lib, err, "gridfix")
    return tuple(out)


def gridfix_remove(vel, pressure, marker, solid_velocity=None):
    """Pressure-gradient removal + extrapolation of the three face grids;
    ``solid_velocity`` is ``SolidState.velocity`` f32[3,X,Y,Z] or None."""
    if not pressure.is_cuda:
        return extrapolate_velocity(remove_divergence(vel, pressure, marker, solid_velocity), marker)
    return _launch(0, vel, pressure, marker, 0.0, solid_velocity)


def gridfix_change(pressure, marker, dt):
    """Position-change field + extrapolation."""
    if not pressure.is_cuda:
        return extrapolate_velocity(position_change_field(pressure, marker, dt), marker)
    return _launch(1, None, pressure, marker, dt)
