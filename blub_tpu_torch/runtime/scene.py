"""Scene runtime: config + assets + per-frame orchestration (port of
``blub_tpu/runtime/scene.py::Scene``; the reference's Scene,
src/scene/mod.rs:55-222).

``step()`` advances one frame of ``settings.dt``: it reads the previous max
speed (4 bytes) to pick the CFL substep count n_sub, fills that split's
animation parameters (substep s of an n-way split sees the solids at
t + (s+1)*dt/n with the finite-difference velocity over dt/n, as in the JAX
package) into one pinned host buffer, copies it to the device in one
transfer, and runs the frame. On the card the frame is one CUDA-graph replay
(``sim/step_dense.FrameGraphs``, one graph per n_sub): the voxelization is
captured with the substeps and reads its parameters from the device buffer,
so one dispatch advances the frame, as the JAX package's jitted frame does.
``Scene(..., graphs=False)`` runs the same frame eagerly instead: the
reference the replays are held against and the mode that per-phase profiling
reads. The baked SDFs go to the device once.

No axis permutation: the scene runs in its own axis order, so the external
layout of ``debug_fields`` and the particle readbacks is the identity.

``Scene(..., mesh=n)`` runs the simulation split along x over a
``torch.distributed`` group of n ranks (``parallel/sharded_sm.py``, the one
step definition with ``ShardedPhases``): every rank holds its x-slab, and
the readbacks gather the whole scene on every rank.
"""

from __future__ import annotations

import logging
import os
import pathlib
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core.config import SceneConfig, SimSettings, load_scene
from ..core.device import resolve_device
from ..core.models import SolidObject, build_solid_objects
from ..core.seeding import seed_scene
from ..core.types import SimParams, SolidState
from ..ops import p2g
from ..sim.divergence import compute_divergence_rhs
from ..sim.sm_phases import marker_from_counts
from ..sim.step_dense import (
    DenseFluidState,
    FrameGraphs,
    decode_scalars,
    eager_frame,
    make_dense_state,
    scalar_words,
    substep_count,
)
from ..sim.voxelize import rotating_flags, solid_params_at, voxelize_step

log = logging.getLogger(__name__)

# one object's animation parameters of one substep in the device buffer:
# shift, v_trans, omega, center (3 each), rotation q (9), origin0 (3)
_PARAM_SLICES = {"shifts": (0, 3), "v_trans": (3, 6), "omegas": (6, 9), "centers": (9, 12), "rot_q": (12, 21),
                 "origins0": (21, 24)}
_PARAM_WIDTH = 24


class _AnimatedSolids:
    """``solids_fn`` of a Scene's frames: substep i's solids voxelized from
    row i of the device parameter buffer (what a graph captures: each replay
    reads the buffer's current values). It holds no reference to the Scene,
    so a frame runner keeps no Scene alive."""

    def __init__(self, sdfs, pad_los, rotating, grid_dim, anim: torch.Tensor):
        self.sdfs, self.pad_los, self.rotating, self.grid_dim, self.anim = sdfs, pad_los, rotating, grid_dim, anim

    def __call__(self, i: int, n_sub: int) -> Optional[SolidState]:
        if not self.sdfs:
            return None
        p = {k: self.anim[i, :, a:b] for k, (a, b) in _PARAM_SLICES.items()}
        with record_function("ph_voxelize"):
            return voxelize_step(
                self.sdfs, self.pad_los, p["shifts"], p["v_trans"], p["omegas"], p["centers"], self.grid_dim,
                rot_q=p["rot_q"].unflatten(-1, (3, 3)), origins0=p["origins0"], rotating=self.rotating,
            )


class Scene:
    def __init__(
        self,
        config: SceneConfig | str | pathlib.Path,
        settings: SimSettings | None = None,
        capacity: int = 16,
        models_dir: pathlib.Path | None = None,
        device="cuda",
        graphs: bool = True,
        mesh=None,
    ):
        """A scene file (or config) on ``device``: the card unless the caller
        asks for the CPU, which runs the plain PyTorch versions. On the card
        each frame is a CUDA-graph replay; ``graphs=False`` runs it eagerly.

        ``mesh``: run split along x over a process group, as the JAX
        package's ``Scene(mesh=...)``: an int n (the world size of the
        initialized default group; ``mesh=1`` with no group starts a
        one-rank group itself, NCCL on the card and gloo on the CPU, through
        a ``file://`` store) or a ``ShardCtx``. Under ``torchrun
        --nproc-per-node N`` each rank takes the card of its LOCAL_RANK.
        Frames on the mesh run eagerly: the PCG reads max|r| on the host at
        its check iterations, which a graph cannot hold. Raises ValueError
        if the grid does not split over the mesh
        (``sharded_sm.sharded_sm_supports``)."""
        self.device = resolve_device(device)
        self._ctx = None
        if mesh is not None:
            self._ctx = self._mesh_ctx(mesh, self.device)
            self.device = self._ctx.device
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
        if self._ctx is not None:
            from ..parallel.sharded_sm import sharded_sm_supports

            if not sharded_sm_supports(self.params.grid_dim, capacity, self._ctx.n):
                raise ValueError(
                    f"grid {self.params.grid_dim} / capacity {capacity} does not split over {self._ctx.n} ranks "
                    "(x must split into slabs of at least the widest halo, 4 planes; K + slack <= 64)"
                )
        self.state: DenseFluidState = self._make_state()
        self.total_simulated_time = 0.0
        self.solids: Optional[SolidState] = None  # those of the last substep run
        self.last_substeps = 0  # n_sub of the last frame
        cuda = self.device.type == "cuda"
        self._use_graphs = cuda and graphs and self._ctx is None
        self._runner: Optional[FrameGraphs] = None
        # the animation parameters of every substep of a frame: filled on the
        # host, copied to the device once per frame (from pinned memory on
        # the card, guarded by an event so a pending copy is never overwritten)
        self._anim_copied = torch.cuda.Event() if cuda else None
        self._alloc_params(max(1, self.settings.max_substeps))
        # non-blocking solver_stats: an async copy of the six scalars after
        # each frame on the card, harvested once its event has passed
        self._stats_host = torch.zeros(6, dtype=torch.int32, pin_memory=cuda)
        self._stats_copied = torch.cuda.Event() if cuda else None
        self._stats_pending = False
        self._stats_cache = self._stats_dict(decode_scalars(np.zeros(6, np.int32)))

    @staticmethod
    def _mesh_ctx(mesh, device: torch.device):
        import torch.distributed as dist

        from ..parallel.sharded_sm import ShardCtx
        from ..parallel.world import one_rank_group

        if isinstance(mesh, ShardCtx):
            return mesh
        n = int(mesh)
        if not dist.is_initialized():
            if n != 1:
                raise ValueError(f"mesh={n}: initialize a default process group of {n} ranks first (torchrun)")
            if device.type == "cuda":
                device = torch.device("cuda", torch.cuda.current_device() if device.index is None else device.index)
            one_rank_group(device)
        if dist.get_world_size() != n:
            raise ValueError(f"mesh={n}, but the default process group has {dist.get_world_size()} ranks")
        if dist.get_backend() == "nccl":
            if n == 1 and device.index is not None:
                dev = device
            else:
                dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank())) % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
        return ShardCtx.from_group(dev)

    def _make_state(self) -> DenseFluidState:
        state = make_dense_state(self.params, self._initial_pos, self.capacity,
                                 device="cpu" if self._ctx is not None else self.device)
        if self._ctx is None:
            return state
        from ..parallel.sharded_sm import shard_sm_state

        return shard_sm_state(self._ctx, state)

    def _solids_at(self, t: float, dt: float) -> Optional[SolidState]:
        if not self.solid_objects:
            return None
        shifts, vts, oms, cts, qs, o0s = solid_params_at(self.solid_objects, t, dt)
        return voxelize_step(
            self._sdfs, self._pad_los, shifts, vts, oms, cts, self.params.grid_dim,
            rot_q=qs, origins0=o0s, rotating=self._rotating,
        )

    def _alloc_params(self, maxn: int) -> None:
        """The host and device parameter buffers for up to ``maxn`` substeps,
        and the voxelization that reads the device one."""
        cuda = self.device.type == "cuda"
        self._anim_host = torch.zeros((maxn, len(self.solid_objects), _PARAM_WIDTH), dtype=torch.float32,
                                      pin_memory=cuda)
        self._anim = self._anim_host.to(self.device) if cuda else self._anim_host
        self._solids_fn = _AnimatedSolids(self._sdfs, self._pad_los, self._rotating, self.params.grid_dim,
                                          self._anim)

    def _upload_params(self, t0: float, dt: float, n_sub: int) -> None:
        """Fill substeps 0..n_sub-1 of the n_sub-way split into the host
        buffer and copy them to the device in one transfer."""
        if self._anim_copied is not None and not self._anim_copied.query():
            self._anim_copied.synchronize()  # the previous frame's copy still reads the buffer
        sub_dt = dt / n_sub
        host = self._anim_host.numpy()
        for s in range(n_sub):
            vals = solid_params_at(self.solid_objects, t0 + (s + 1) * sub_dt, sub_dt)
            for (a, b), v in zip(_PARAM_SLICES.values(), vals):
                host[s, :, a:b] = np.asarray(v, np.float32).reshape(len(self.solid_objects), b - a)
        if self._anim_copied is not None:
            self._anim[:n_sub].copy_(self._anim_host[:n_sub], non_blocking=True)
            self._anim_copied.record()

    # -- stepping --------------------------------------------------------

    def step(self) -> None:
        """Advance one frame of dt (Scene::step, scene/mod.rs:166), split into
        CFL-bounded substeps when the flow is violent: read n_sub, upload
        that split's animation parameters, run the frame (one graph replay
        on the card)."""
        dt = self.settings.dt
        maxn = max(1, self.settings.max_substeps)
        n_sub = substep_count(self.params, self.state, self.settings.cfl_target, maxn)
        self._harvest_stats()
        if self.solid_objects:
            self._upload_params(self.total_simulated_time, dt, n_sub)
        if self._use_graphs:
            if self._runner is None:
                self._runner = FrameGraphs(self.params, self._solids_fn)
            self.state = self._runner.run(self.state, n_sub)
            self.solids = self._runner.solids
        else:
            last = [None]

            def solids_fn(i: int, n: int) -> Optional[SolidState]:
                last[0] = self._solids_fn(i, n)
                return last[0]

            phases = None
            if self._ctx is not None:
                from ..parallel.sharded_sm import ShardedPhases

                phases = ShardedPhases(self.params, self._ctx)
            self.state = eager_frame(self.params, self.state, solids_fn, n_sub, phases=phases)
            self.solids = last[0]
        self.last_substeps = n_sub
        self.total_simulated_time += dt
        if self._stats_copied is not None:
            self._stats_host.copy_(scalar_words(self.state), non_blocking=True)
            self._stats_copied.record()
            self._stats_pending = True

    def current_solids(self) -> Optional[SolidState]:
        """The solids at the end of the next frame (t + dt)."""
        return self._solids_at(self.total_simulated_time + self.settings.dt, self.settings.dt)

    def reset(self) -> None:
        """Rebuild the fluid from the scene config (Scene::reset); on the
        card the state is copied into the frame graphs' static buffers, so
        the graphs stay."""
        state = self._make_state()
        if self._runner is not None and self._runner.state is not None:
            self._runner.load(state)
            state = self._runner.state
        self.state = state
        self.total_simulated_time = 0.0
        self.solids = None
        self.last_substeps = 0

    def update_settings(self, settings: SimSettings) -> None:
        """Apply new runtime settings (solver and timing knobs). dt and the
        solver configurations are frozen into the frame graphs, so they are
        dropped (as the JAX package drops its jit cache); the next frame
        captures anew."""
        self.settings = settings
        self.params = SimParams.from_scene(self.config, settings, num_particles=self.params.num_particles)
        self._runner = None
        if max(1, settings.max_substeps) > self._anim.shape[0]:
            if self._anim_copied is not None:
                self._anim_copied.synchronize()
            self._alloc_params(max(1, settings.max_substeps))

    # -- introspection ----------------------------------------------------

    @property
    def layout(self) -> str:
        """Which implementation runs: always "sm", the slot-major kernel path
        (the JAX package may also report "pt", its XLA table path)."""
        return "sm"

    def num_particles(self) -> int:
        n = self.state.table.num_particles()
        if self._ctx is not None:
            n = self._ctx.all_reduce(n.reshape(1).clone())
        return int(n.item())

    @property
    def grid_dim_external(self) -> Tuple[int, int, int]:
        """The grid in the scene's own axis order (what the camera frames and
        the renderer draws): ``params.grid_dim``, since the port keeps the
        identity layout."""
        return self.params.grid_dim

    def particle_tensors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(positions, velocities): f32[N, 3] grid-space positions and
        velocities (grid units per second, bf16 stored) of the particles, on
        the scene's device, in ``particle_positions()``' order. They are new
        tensors, not views of the state: the next ``step()`` (a graph replay
        that rewrites the state's buffers) leaves them as they are. On a mesh:
        every rank's particles, gathered on every rank."""
        if self._ctx is not None:
            from ..parallel.sharded_sm import gather_particles

            return gather_particles(self._ctx, self.state.table)
        return self.state.table.particles()

    def particle_positions(self) -> np.ndarray:
        """f32[N, 3] grid-space positions of the particles."""
        return self.particle_tensors()[0].cpu().numpy()

    def particle_velocities(self) -> np.ndarray:
        """f32[N, 3] particle velocities (grid units per second, bf16 stored)."""
        return self.particle_tensors()[1].cpu().numpy()

    def debug_fields(self) -> dict:
        """Grid fields for volume visualization (the reference's
        VolumeVisualizationMode sources, volume_renderer.rs): the face
        velocity from P2G, its divergence error, both pressure fields and the
        marker, as numpy arrays in the scene's axis order (velocity
        [X,Y,Z,3]), with the solids at the end of the next frame, as the JAX
        package computes them. On a mesh the fields are computed on each
        slab and gathered."""
        if self._ctx is not None:
            return self._debug_fields_mesh()
        solids = self.current_solids()
        occupancy = solids.occupancy if solids is not None else None
        solid_vel = solids.velocity if solids is not None else None
        t = self.state.table
        acc = p2g.p2g(t.posq, t.dyn)
        marker = marker_from_counts(acc[-1], self.params.grid_dim, occupancy)
        vel = p2g.normalize_velocity(acc, marker, self.params.gravity_grid, np.float32(self.params.dt))
        div = compute_divergence_rhs(vel, marker, solid_vel)
        return {
            "velocity": torch.stack(vel, dim=-1).cpu().numpy(),
            "divergence_error": div.cpu().numpy(),
            "pressure_from_velocity": self.state.pressure_vel.cpu().numpy(),
            "pressure_from_density": self.state.pressure_den.cpu().numpy(),
            "marker": marker.to(torch.float32).cpu().numpy(),
        }

    def _debug_fields_mesh(self) -> dict:
        from ..parallel.sharded_sm import ShardedPhases

        ph = ShardedPhases(self.params, self._ctx)
        occupancy, solid_vel = ph.solids(self.current_solids())
        t = self.state.table
        acc = ph.p2g_raw(t.posq, t.dyn)
        marker = ph.marker(acc[-1], occupancy)
        vel = ph.normalize(acc, marker, np.float32(self.params.dt))
        div = ph.div_rhs(vel, marker, solid_vel)

        def whole(a):  # a readback: the slabs gathered along x
            return torch.cat(self._ctx.all_gather(a.contiguous()), dim=0).cpu().numpy()

        return {
            "velocity": whole(torch.stack(vel, dim=-1)),
            "divergence_error": whole(div),
            "pressure_from_velocity": whole(self.state.pressure_vel),
            "pressure_from_density": whole(self.state.pressure_den),
            "marker": whole(marker.to(torch.float32)),
        }

    def _harvest_stats(self) -> None:
        """Take the last async stats copy into the snapshot once its event
        has passed (never waits)."""
        if self._stats_pending and self._stats_copied.query():
            self._stats_cache = self._stats_dict(decode_scalars(self._stats_host.numpy()))
            self._stats_pending = False

    def solver_stats(self, block: bool = True) -> dict:
        """Solver iterations and exit error of the last substep, and the
        lost-particle count. ``block=True`` reads the device scalars (waits
        for the frame). ``block=False`` never waits: on the card it returns
        the last snapshot that the async copy after each frame has brought
        to the host, at most one frame old when frames are paced by their
        max-speed read (as the JAX package's, runtime/scene.py:316-353); on
        the CPU the values are at hand. On a mesh every rank holds the same
        stats: the solves' scalars are all-reduced, and so is each rebin's
        kept count, so lost is the whole scene's."""
        if block or self._stats_copied is None:
            return self._stats_dict(decode_scalars(scalar_words(self.state).cpu().numpy()))
        self._harvest_stats()
        return self._stats_cache

    @staticmethod
    def _stats_dict(s: dict) -> dict:
        return {
            "velocity": {"error": s["error_vel"], "iterations": s["iterations_vel"]},
            "density": {"error": s["error_den"], "iterations": s["iterations_den"]},
            "lost_particles": s["lost"],
        }
