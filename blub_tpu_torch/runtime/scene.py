"""Scene runtime: config + assets + per-frame orchestration (port of
``blub_tpu/runtime/scene.py::Scene``; the reference's Scene,
src/scene/mod.rs:55-222).

``step()`` advances one frame of ``settings.dt``. It fills the animation
parameters of every possible split of the frame into a pinned host buffer,
``[maxn, maxn, n_obj, 24]`` with ``[n-1, s]`` for substep s of an n-way
split (the solids at t + (s+1)*dt/n with the finite-difference velocity
over dt/n), as the JAX package's ``_solid_params_stacked`` does, copies it
to the device in one transfer, and runs the frame. On the card the frame is
one CUDA-graph launch (``sim/step_dense.FrameGraphs``) that picks its
substep count n_sub on the card and voxelizes each substep from row
``[n_sub-1, s]`` of the device buffer: one dispatch advances the frame and
the host reads nothing, as with the JAX package's jitted frame. The host
buffers are a ring of ``RING`` (a buffer is refilled once the copy from it
has run), so the host runs up to that many frames ahead of the card; the
stats words (and n_sub, ``last_substeps``) come back through the same ring
and are taken in once their frame has run. ``Scene(..., graphs=False)``
runs the same frame eagerly instead, with n_sub read on the host: the
reference the graph launches are held against and the mode that per-phase
profiling reads. The solids' SDFs bake on the Scene's device
(``core/models.build_solid_objects``: the card's ``sdf`` kernel, or the
plain version on the CPU; ``bake_seconds``) and go to the device once.

No axis permutation: the scene runs in its own axis order, so the external
layout of ``debug_fields`` and the particle readbacks is the identity.

``Scene(..., mesh=n)`` runs the simulation split along x over a
``torch.distributed`` group of n ranks (``parallel/sharded_sm.py``, the one
step definition with ``ShardedPhases``): every rank holds its x-slab, and
the readbacks gather the whole scene on every rank. On the card its frames
are graph launches too (each PCG loop a CUDA WHILE node with its
collectives inside); on the CPU (gloo) they run eagerly.
"""

from __future__ import annotations

import logging
import os
import pathlib
import time
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
    NUM_SCALARS,
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
RING = 3  # pinned host buffers of the parameters and stats: frames the host may run ahead


class _AnimatedSolids:
    """``solids_fn`` of a Scene's frames: substep i of an n-way split
    voxelized from row [n-1, i] of the device parameter buffer (what a graph
    captures: each launch reads the buffer's current values). It holds no
    reference to the Scene, so a frame runner keeps no Scene alive."""

    def __init__(self, sdfs, pad_los, rotating, grid_dim, anim: torch.Tensor):
        self.sdfs, self.pad_los, self.rotating, self.grid_dim, self.anim = sdfs, pad_los, rotating, grid_dim, anim

    def __call__(self, i: int, n_sub: int) -> Optional[SolidState]:
        if not self.sdfs:
            return None
        p = {k: self.anim[n_sub - 1, i, :, a:b] for k, (a, b) in _PARAM_SLICES.items()}
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
        each frame is one CUDA-graph launch that picks its n_sub on the card;
        ``graphs=False`` runs it eagerly, with n_sub read on the host.

        ``mesh``: run split along x over a process group, as the JAX
        package's ``Scene(mesh=...)``: an int n (the world size of the
        initialized default group; ``mesh=1`` with no group starts a
        one-rank group itself, NCCL on the card and gloo on the CPU, through
        a ``file://`` store) or a ``ShardCtx``. Under ``torchrun
        --nproc-per-node N`` each rank takes the card of its LOCAL_RANK.
        On the card a mesh frame is one graph launch too, each PCG loop a
        CUDA WHILE node with its collectives inside; on the CPU (gloo) it
        runs eagerly. Raises ValueError if the grid does not split over the
        mesh (``sharded_sm.sharded_sm_supports``)."""
        self.device = resolve_device(device)
        self._ctx = None
        if mesh is not None:
            self._ctx = self._mesh_ctx(mesh, self.device)
            self.device = self._ctx.device
        self.config = config if isinstance(config, SceneConfig) else load_scene(config)
        self.settings = settings or SimSettings()
        self.capacity = capacity
        t0 = time.perf_counter()
        # bakes on the Scene's device (on a mesh, the rank's card); the field
        # comes back to the host, so the time is the bake's whole
        self.solid_objects: List[SolidObject] = build_solid_objects(self.config, models_dir, self.device)
        self.bake_seconds = time.perf_counter() - t0
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
        # n_sub of the last frame; on the graph path that of the newest frame
        # whose stats came back (at most RING frames old), 0 before any
        self.last_substeps = 0
        self.pacing_waits = 0  # steps that waited for the card: the host was RING frames ahead
        cuda = self.device.type == "cuda"
        self._use_graphs = cuda and graphs
        self._runner: Optional[FrameGraphs] = None
        # on the card, a ring of RING slots: the animation parameters of
        # every split of a frame (filled on the host, copied to the device
        # once per frame) and the stats words copied back after it, from and
        # into pinned memory, and an event after both; a slot is reused once
        # its event has passed
        self._ring = None
        self._ring_at = 0
        self._frames_run, self._stats_frame = 0, 0  # frames stepped; the frame of the stats taken in
        self._alloc_params(max(1, self.settings.max_substeps))
        self._stats_cache = self._stats_dict(decode_scalars(np.zeros(NUM_SCALARS, np.int32)))

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

    def _phases(self):
        """The step's phase provider: None (``LocalPhases``) or, on a mesh,
        ``ShardedPhases``."""
        if self._ctx is None:
            return None
        from ..parallel.sharded_sm import ShardedPhases

        return ShardedPhases(self.params, self._ctx)

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
        """The parameter buffers for splits of up to ``maxn`` substeps (on
        the card the ring and the device buffer, on the CPU one buffer), and
        the voxelization that reads the device one."""
        shape = (maxn, maxn, len(self.solid_objects), _PARAM_WIDTH)
        if self.device.type == "cuda":
            self._ring = [{"anim": torch.zeros(shape, dtype=torch.float32, pin_memory=True),
                           "stats": torch.zeros(NUM_SCALARS, dtype=torch.int32, pin_memory=True),
                           "done": torch.cuda.Event(), "pending": False} for _ in range(RING)]
            self._ring_at = 0
            self._anim = torch.zeros(shape, dtype=torch.float32, device=self.device)
        else:
            self._anim = torch.zeros(shape, dtype=torch.float32)
        self._solids_fn = _AnimatedSolids(self._sdfs, self._pad_los, self._rotating, self.params.grid_dim,
                                          self._anim)

    def _fill_params(self, host: np.ndarray, t0: float, dt: float) -> None:
        """Every split's animation parameters into ``host`` (the JAX
        package's ``_solid_params_stacked``): [n-1, s] is substep s of an
        n-way split, at t0 + (s+1) * dt/n."""
        maxn = host.shape[0]
        for n in range(1, maxn + 1):
            sub_dt = dt / n
            for s in range(n):
                vals = solid_params_at(self.solid_objects, t0 + (s + 1) * sub_dt, sub_dt)
                for (a, b), v in zip(_PARAM_SLICES.values(), vals):
                    host[n - 1, s, :, a:b] = np.asarray(v, np.float32).reshape(len(self.solid_objects), b - a)

    def _next_slot(self) -> dict:
        """The ring slot this frame uses, once the card is done with it (a
        wait only when the host is RING frames ahead); its stats are taken
        in first."""
        slot = self._ring[self._ring_at]
        if slot["pending"] and not slot["done"].query():
            self.pacing_waits += 1
            slot["done"].synchronize()
        self._harvest_stats()
        return slot

    # -- stepping --------------------------------------------------------

    def step(self) -> None:
        """Advance one frame of dt (Scene::step, scene/mod.rs:166), split into
        CFL-bounded substeps when the flow is violent: upload every split's
        animation parameters, run the frame (on the card one graph launch
        that picks n_sub on the card; eagerly, n_sub read on the host), copy
        the stats words back."""
        dt = self.settings.dt
        maxn = max(1, self.settings.max_substeps)
        slot = self._next_slot() if self._ring is not None else None
        if self.solid_objects:
            if slot is None:
                self._fill_params(self._anim.numpy(), self.total_simulated_time, dt)
            else:
                self._fill_params(slot["anim"].numpy(), self.total_simulated_time, dt)
                self._anim.copy_(slot["anim"], non_blocking=True)
        if self._use_graphs:
            if self._runner is None:
                self._runner = FrameGraphs(self.params, self._solids_fn, self.settings.cfl_target, maxn, self._phases())
            self.state, _ = self._runner.run(self.state)
            self.solids = self._runner.solids
        else:
            n_sub = substep_count(self.params, self.state, self.settings.cfl_target, maxn)
            last = [None]

            def solids_fn(i: int, n: int) -> Optional[SolidState]:
                last[0] = self._solids_fn(i, n)
                return last[0]

            self.state = eager_frame(self.params, self.state, solids_fn, n_sub, phases=self._phases())
            self.solids = last[0]
            self.last_substeps = n_sub
        self.total_simulated_time += dt
        if slot is not None:
            slot["stats"].copy_(scalar_words(self.state), non_blocking=True)
            slot["done"].record()
            self._frames_run += 1
            slot["pending"], slot["frame"] = True, self._frames_run
            self._ring_at = (self._ring_at + 1) % RING

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
            for slot in self._ring or ():
                if slot["pending"]:
                    slot["done"].synchronize()  # a pending copy still uses the buffers
            self._harvest_stats()
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
        ph = self._phases()
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
        """Take in the stats words of the newest frame whose copy has come
        back (never waits); on the graph path its n_sub too."""
        done = [slot for slot in self._ring or () if slot["pending"] and slot["done"].query()]
        for slot in done:
            slot["pending"] = False
        newest = max(done, key=lambda slot: slot["frame"], default=None)
        if newest is None or newest["frame"] <= self._stats_frame:
            return
        self._stats_frame = newest["frame"]
        words = decode_scalars(newest["stats"].numpy())
        self._stats_cache = self._stats_dict(words)
        if self._use_graphs:
            self.last_substeps = words["n_sub"]

    def solver_stats(self, block: bool = True) -> dict:
        """Solver iterations and exit error of the last substep, and the
        lost-particle count. ``block=True`` reads the device scalars (waits
        for the frame). ``block=False`` never waits: on the card it returns
        the stats of the newest frame whose async copy has come back, at
        most ``RING`` frames old (the JAX package's serve the newest
        completed snapshot too, runtime/scene.py:316-353); on the CPU the
        values are at hand. On a mesh every rank holds the same stats: the
        solves' scalars are all-reduced, and so is each rebin's kept count,
        so lost is the whole scene's."""
        if block or self._ring is None:
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
