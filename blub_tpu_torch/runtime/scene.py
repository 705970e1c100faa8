"""Scene runtime: config + assets + per-frame orchestration (port of
``blub_tpu/runtime/scene.py::Scene``; the reference's Scene,
src/scene/mod.rs:55-222).

``step()`` advances one frame of ``settings.dt``: it reads the previous max
speed (4 bytes) to pick the CFL substep count n_sub, and voxelizes the
animated solids for each substep of that split only. Substep s of an n-way
split sees the solids at t + (s+1)*dt/n with the finite-difference velocity
over dt/n, as in the JAX package. The baked SDFs go to the device once.

No sharding mesh, axis permutation or debug fields: the scene runs in its own
axis order on one device.
"""

from __future__ import annotations

import logging
import pathlib
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..core.config import SceneConfig, SimSettings, load_scene
from ..core.device import resolve_device
from ..core.models import SolidObject, build_solid_objects
from ..core.seeding import seed_scene
from ..core.types import SimParams, SolidState
from ..sim.slot_major import CH_XY, CH_ZV, NUM_DYN, cell_coord, rel_to_pos, unpack_dyn, unpack_posq
from ..sim.step_dense import DenseFluidState, frame_dense_fn, make_dense_state
from ..sim.voxelize import rotating_flags, solid_params_at, voxelize_step

log = logging.getLogger(__name__)


class Scene:
    def __init__(
        self,
        config: SceneConfig | str | pathlib.Path,
        settings: SimSettings | None = None,
        capacity: int = 16,
        models_dir: pathlib.Path | None = None,
        device="cuda",
    ):
        """A scene file (or config) on ``device``: the card unless the caller
        asks for the CPU, which runs the plain PyTorch versions."""
        self.device = resolve_device(device)
        self.config = config if isinstance(config, SceneConfig) else load_scene(config)
        self.settings = settings or SimSettings()
        self.capacity = capacity
        self.solid_objects: List[SolidObject] = build_solid_objects(self.config, models_dir)
        standins = [o for o in self.solid_objects if o.standin]
        if standins:
            log.warning(
                "scene %s: %d solid model(s) are procedural stand-ins (%s); physics differs from the "
                "reference scene",
                self.config.name, len(standins), ", ".join(f"{o.config.model}->{o.standin}" for o in standins),
            )
        self._sdfs = [torch.from_numpy(o.sdf).to(self.device) for o in self.solid_objects]
        self._pad_los = tuple(o.pad_lo for o in self.solid_objects)
        self._rotating = rotating_flags(self.solid_objects)
        self._initial_pos = seed_scene(self.config)
        self.params = SimParams.from_scene(self.config, self.settings, num_particles=self._initial_pos.shape[0])
        self.state: DenseFluidState = make_dense_state(
            self.params, self._initial_pos, capacity, device=self.device
        )
        self.total_simulated_time = 0.0
        self.solids: Optional[SolidState] = None  # those of the last substep run
        self.last_substeps = 0  # n_sub of the last frame

    def _solids_at(self, t: float, dt: float) -> Optional[SolidState]:
        if not self.solid_objects:
            return None
        shifts, vts, oms, cts, qs, o0s = solid_params_at(self.solid_objects, t, dt)
        return voxelize_step(
            self._sdfs, self._pad_los, shifts, vts, oms, cts, self.params.grid_dim,
            rot_q=qs, origins0=o0s, rotating=self._rotating,
        )

    # -- stepping --------------------------------------------------------

    def step(self) -> None:
        """Advance one frame of dt (Scene::step, scene/mod.rs:166), split into
        CFL-bounded substeps when the flow is violent."""
        dt = self.settings.dt
        t0 = self.total_simulated_time

        def solids_fn(i: int, n_sub: int) -> Optional[SolidState]:
            sub_dt = dt / n_sub
            with record_function("ph_voxelize"):
                self.solids = self._solids_at(t0 + (i + 1) * sub_dt, sub_dt)
            return self.solids

        self.state, self.last_substeps = frame_dense_fn(
            self.params, self.state, solids_fn, self.settings.cfl_target, max(1, self.settings.max_substeps)
        )
        self.total_simulated_time += dt

    def current_solids(self) -> Optional[SolidState]:
        """The solids at the end of the next frame (t + dt)."""
        return self._solids_at(self.total_simulated_time + self.settings.dt, self.settings.dt)

    def reset(self) -> None:
        """Rebuild the fluid from the scene config (Scene::reset)."""
        self.state = make_dense_state(self.params, self._initial_pos, self.capacity, device=self.device)
        self.total_simulated_time = 0.0
        self.solids = None
        self.last_substeps = 0

    def update_settings(self, settings: SimSettings) -> None:
        """Apply new runtime settings (solver and timing knobs); the next
        step uses them."""
        self.settings = settings
        self.params = SimParams.from_scene(self.config, settings, num_particles=self.params.num_particles)

    # -- introspection ----------------------------------------------------

    def num_particles(self) -> int:
        return int(self.state.table.num_particles().item())

    def _valid_cell_major(self, a: torch.Tensor) -> torch.Tensor:
        """[K, X, Y, Z] -> the valid entries in cell-major order (x, y, z,
        then slot), the JAX package's ``to_positions`` order."""
        valid = (self.state.table.posq[:, CH_ZV] & 1) == 1
        return a.permute(1, 2, 3, 0)[valid.permute(1, 2, 3, 0)]

    def particle_positions(self) -> np.ndarray:
        """f32[N, 3] grid-space positions of the particles."""
        posq = self.state.table.posq
        rx, ry, rz, _ = unpack_posq(posq[:, CH_XY], posq[:, CH_ZV])
        grid = self.params.grid_dim
        pos = [rel_to_pos(r, cell_coord(grid, a, posq.device)) for a, r in enumerate((rx, ry, rz))]
        return torch.stack([self._valid_cell_major(p) for p in pos], dim=-1).cpu().numpy()

    def particle_velocities(self) -> np.ndarray:
        """f32[N, 3] particle velocities (grid units per second, bf16 stored)."""
        dyn = self.state.table.dyn
        vel, _ = unpack_dyn([dyn[:, c] for c in range(NUM_DYN)])
        return torch.stack([self._valid_cell_major(v) for v in vel], dim=-1).cpu().numpy()

    def solver_stats(self) -> dict:
        """Solver iterations and exit error of the last substep, and the
        lost-particle count (reads device scalars: blocks)."""
        s = self.state
        return {
            "velocity": {"error": float(s.stats_vel.error.item()), "iterations": int(s.stats_vel.iterations)},
            "density": {"error": float(s.stats_den.error.item()), "iterations": int(s.stats_den.iterations)},
            "lost_particles": int(s.table.lost.item()),
        }
