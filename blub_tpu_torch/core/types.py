"""Marker constants, static parameters, solver statistics and the voxelized
solids.

Copies of the JAX package's ``core/types.py`` definitions that the dense step
needs. The marker keeps the reference's encoding SOLID=0 / FLUID=1 / AIR=-1
(hybrid_fluid.glsl:21-24), so ``|marker|`` counts non-solid cells and a
zero-filled out-of-domain read is SOLID.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .config import SceneConfig, SimSettings, SolverConfig

CELL_SOLID = 0
CELL_FLUID = 1
CELL_AIR = -1


@dataclasses.dataclass
class SolverStats:
    """Per-solve statistics on the solve's device, as in the JAX package:
    ``error`` is an f32 scalar (max |residual| at exit, times dt) and
    ``iterations`` a 0-d int32 tensor (the iterations run). Reading either
    on the host waits for the solve."""

    error: torch.Tensor
    iterations: torch.Tensor

    @staticmethod
    def zero(device) -> "SolverStats":
        return SolverStats(error=torch.zeros((), dtype=torch.float32, device=device),
                           iterations=torch.zeros((), dtype=torch.int32, device=device))


@dataclasses.dataclass
class SolidState:
    """Voxelized solid boundary (``blub_tpu/core/types.py::SolidState``):
    ``occupancy`` f32[X,Y,Z], > 0 where solid, and the solid ``velocity`` in
    grid units per second as f32[3,X,Y,Z], one contiguous plane per component
    like the face grids (the JAX package keeps it as [X,Y,Z,3];
    ``convert.py`` maps between the two)."""

    occupancy: torch.Tensor
    velocity: torch.Tensor

    @staticmethod
    def empty(grid_dim, device) -> "SolidState":
        return SolidState(
            occupancy=torch.zeros(tuple(grid_dim), dtype=torch.float32, device=device),
            velocity=torch.zeros((3,) + tuple(grid_dim), dtype=torch.float32, device=device),
        )


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static simulation parameters (``blub_tpu/core/types.py::SimParams``)."""

    grid_dim: Tuple[int, int, int]
    dt: float
    gravity_grid: Tuple[float, float, float]
    num_particles: int
    solver_vel: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    solver_den: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    has_solids: bool = False

    @staticmethod
    def from_scene(
        scene: SceneConfig, settings: SimSettings | None = None, num_particles: int | None = None
    ) -> "SimParams":
        settings = settings or SimSettings()
        return SimParams(
            grid_dim=scene.fluid.grid_dimension,
            dt=settings.dt,
            gravity_grid=scene.gravity_grid,
            num_particles=int(num_particles if num_particles is not None else 0),
            solver_vel=settings.solver_velocity,
            solver_den=settings.solver_density,
            has_solids=len(scene.static_objects) > 0,
        )
