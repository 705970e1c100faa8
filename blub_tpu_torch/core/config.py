"""Scene and solver configuration (copy of ``blub_tpu/core/config.py``).

Blub's JSON scene format, unchanged (reference src/scene/mod.rs:19-43 and
src/scene/models.rs:11-46): ``SceneConfig { gravity, fluid, static_objects }``
with ``FluidConfig { world_position, grid_to_world_scale, grid_dimension,
max_num_particles, fluid_cubes }`` and rigid-animation descriptions for solid
objects. Every ``scenes/*.json`` parses without modification.

``SimSettings`` has no ``axis_layout``: that knob picks the JAX package's
TPU-only axis permutation, which does not change the physics; the port always
runs the scene's own axis order.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional, Sequence, Tuple

Vec3 = Tuple[float, float, float]


def _vec3(d: dict) -> Vec3:
    return (float(d["x"]), float(d["y"]), float(d["z"]))


@dataclasses.dataclass(frozen=True)
class FluidCube:
    """Axis-aligned box of fluid, in world space (reference: scene/mod.rs:20-24)."""

    min: Vec3
    max: Vec3


@dataclasses.dataclass(frozen=True)
class TranslationAnimation:
    """Ping-pong translation toward ``target`` (reference: models.rs:27-32)."""

    target: Vec3
    curve: str  # "Linear" | "SmoothStep"
    duration: float  # seconds to reach target


@dataclasses.dataclass(frozen=True)
class RotationAnimation:
    """Constant-rate rotation (reference: models.rs:34-38)."""

    axis: Vec3
    deg_per_sec: float


@dataclasses.dataclass(frozen=True)
class RigidAnimation:
    translation: Optional[TranslationAnimation] = None
    rotation: Optional[RotationAnimation] = None


@dataclasses.dataclass(frozen=True)
class StaticObjectConfig:
    """A solid mesh in the scene (reference: models.rs:11-19)."""

    model: str
    world_position: Vec3
    scale: float
    rotation_angles: Vec3  # Euler angles in degrees (x, y, z)
    animation: Optional[RigidAnimation] = None


@dataclasses.dataclass(frozen=True)
class FluidConfig:
    """Reference: scene/mod.rs:27-35."""

    world_position: Vec3
    grid_to_world_scale: float
    grid_dimension: Tuple[int, int, int]
    max_num_particles: int
    fluid_cubes: Tuple[FluidCube, ...]


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Reference: scene/mod.rs:37-43. Gravity is in world space (m/s^2)."""

    gravity: Vec3
    fluid: FluidConfig
    static_objects: Tuple[StaticObjectConfig, ...] = ()
    name: str = ""

    @property
    def gravity_grid(self) -> Vec3:
        """Gravity converted to grid space, reference scene/mod.rs:139."""
        s = self.fluid.grid_to_world_scale
        g = self.gravity
        return (g[0] / s, g[1] / s, g[2] / s)

    def fluid_cubes_grid(self) -> Tuple[Tuple[Vec3, Vec3], ...]:
        """Fluid cubes converted to grid space (scene/mod.rs:133-138)."""
        s = self.fluid.grid_to_world_scale
        return tuple(
            ((c.min[0] / s, c.min[1] / s, c.min[2] / s), (c.max[0] / s, c.max[1] / s, c.max[2] / s))
            for c in self.fluid.fluid_cubes
        )

    @property
    def num_cells(self) -> int:
        d = self.fluid.grid_dimension
        return d[0] * d[1] * d[2]


def _parse_animation(d: Optional[dict]) -> Optional[RigidAnimation]:
    if d is None:
        return None
    tr = d.get("translation")
    rot = d.get("rotation")
    translation = None
    rotation = None
    if tr is not None:
        translation = TranslationAnimation(
            target=_vec3(tr["target"]), curve=str(tr["curve"]), duration=float(tr["duration"])
        )
    if rot is not None:
        rotation = RotationAnimation(axis=_vec3(rot["axis"]), deg_per_sec=float(rot["deg_per_sec"]))
    return RigidAnimation(translation=translation, rotation=rotation)


def load_scene_dict(d: dict, name: str = "") -> SceneConfig:
    f = d["fluid"]
    dim = f["grid_dimension"]
    fluid = FluidConfig(
        world_position=_vec3(f["world_position"]),
        grid_to_world_scale=float(f["grid_to_world_scale"]),
        grid_dimension=(int(dim["x"]), int(dim["y"]), int(dim["z"])),
        max_num_particles=int(f["max_num_particles"]),
        fluid_cubes=tuple(FluidCube(min=_vec3(c["min"]), max=_vec3(c["max"])) for c in f["fluid_cubes"]),
    )
    objs = tuple(
        StaticObjectConfig(
            model=str(o["model"]),
            world_position=_vec3(o["world_position"]),
            scale=float(o["scale"]),
            rotation_angles=_vec3(o["rotation_angles"]),
            animation=_parse_animation(o.get("animation")),
        )
        for o in d.get("static_objects", [])
    )
    return SceneConfig(gravity=_vec3(d["gravity"]), fluid=fluid, static_objects=objs, name=name)


def load_scene(path: str | pathlib.Path) -> SceneConfig:
    path = pathlib.Path(path)
    with open(path, "r") as fh:
        return load_scene_dict(json.load(fh), name=path.stem)


def scenes_dir() -> pathlib.Path:
    """The repository's ``scenes/`` directory."""
    return pathlib.Path(__file__).resolve().parents[2] / "scenes"


def list_scenes(directory: str | pathlib.Path | None = None) -> Sequence[pathlib.Path]:
    """The scene files of ``directory`` (default ``scenes/``), without those
    whose name starts with ``#``."""
    directory = pathlib.Path(directory) if directory is not None else scenes_dir()
    return sorted(p for p in directory.glob("*.json") if not p.name.startswith("#"))


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """PCG pressure-solver knobs (reference: pressure_solver.rs:58-62,
    defaults hybrid_fluid.rs:253-257)."""

    error_tolerance: float = 0.1
    max_num_iterations: int = 32
    error_check_frequency: int = 4


@dataclasses.dataclass(frozen=True)
class SimSettings:
    """Runtime simulation settings (reference GUI knobs,
    simulation_controller.rs:39). ``cfl_target`` is the CFL bound in cells
    per substep (the JAX package's addition; 0 disables substepping)."""

    simulation_steps_per_second: int = 120
    solver_velocity: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    solver_density: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    particle_rebinning_frequency: int = 60  # reference hybrid_fluid.rs:604
    cfl_target: float = 1.9
    max_substeps: int = 4

    @property
    def dt(self) -> float:
        return 1.0 / float(self.simulation_steps_per_second)


def smoothstep(x: float) -> float:
    x = min(max(x, 0.0), 1.0)
    return x * x * (3.0 - 2.0 * x)
