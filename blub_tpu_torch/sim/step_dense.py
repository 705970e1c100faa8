"""The dense-table simulation step and the CFL frame (port of
``blub_tpu/sim/step_dense.py``: ``_step_core`` with ``LocalPhases``,
``frame_dense_fn``, ``frame_dense`` and ``multi_frame_dense``).

One substep, in the reference's pass order (hybrid_fluid.rs:770-977) with the
two rebins that keep the table's bin invariant:

  P2G + fluid count -> marker, normalize, gravity -> divergence RHS ->
  PCG(vel) -> gridfix(remove) -> G2P advect + pack x -> pack y, z (+-2) ->
  P2G density -> density RHS -> PCG(den) -> gridfix(change) ->
  G2P correct + pack x -> pack y, z (+-1)

Each phase runs under ``torch.profiler.record_function`` with the JAX
package's scope names (``ph_*``). The particle count is n0 - lost (only
rebins drop particles), so the rebin's lost accounting needs no table-wide
reduction. A frame picks its substep count from the previous max speed,
clip(ceil(max_speed * dt / cfl), 1, max_substeps) in f32, with one 4-byte
read per frame; on the card the frame is then one CUDA-graph replay
(``FrameGraphs``), on the CPU an eager loop (``eager_frame``). With a
``SolidState`` both markers mark occupied cells SOLID,
the divergence RHS takes the moving-wall terms, the velocity gridfix gives
faces into solids the solid velocity, and advect escapes, tests penetration
against the occupancy and pushes (the solids specialisations of the gridfix
and G2P kernels); the density half sees the solids through its marker.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core.device import resolve_device
from ..core.types import SimParams, SolidState, SolverStats
from ..ops import cuda, g2p, gridfix, p2g, pcg, rebin
from .dense_transfer import density_rhs_from_raw
from .divergence import compute_divergence_rhs
from .slot_major import BYTES_PER_SLOT, SlotMajorTable
from .sm_phases import marker_from_counts
from .table import from_positions


@dataclasses.dataclass
class DenseFluidState:
    """Persistent state of the dense-table simulation; every tensor lives on
    the simulation's device."""

    table: SlotMajorTable
    pressure_vel: torch.Tensor
    pressure_den: torch.Tensor
    step_index: int
    stats_vel: SolverStats
    stats_den: SolverStats
    max_speed: torch.Tensor  # f32 scalar: max |v| (grid/s), drives CFL substepping
    # the frame runner whose static buffers these tensors are (set by the
    # frame on the card; None for a state built or stepped eagerly)
    runner: Optional["FrameGraphs"] = dataclasses.field(default=None, repr=False, compare=False)


def make_dense_state(
    params: SimParams, pos_np, capacity: int = 16, device="cuda"
) -> DenseFluidState:
    """Initial state from seeded positions, on ``device`` (the card unless
    the caller asks for the CPU)."""
    dev = resolve_device(device)
    table = from_positions(pos_np, params.grid_dim, capacity, device=dev)
    return DenseFluidState(
        table=table,
        pressure_vel=torch.zeros(params.grid_dim, dtype=torch.float32, device=dev),
        pressure_den=torch.zeros(params.grid_dim, dtype=torch.float32, device=dev),
        step_index=0,
        stats_vel=SolverStats.zero(dev),
        stats_den=SolverStats.zero(dev),
        max_speed=torch.zeros((), dtype=torch.float32, device=dev),
    )


def stage_slack(params: SimParams, capacity: int) -> int:
    x, y, z = params.grid_dim
    return rebin.default_slack(capacity * BYTES_PER_SLOT * x * y * z, capacity)


class LocalPhases:
    """The single-card phase provider of ``step_core`` (the JAX package's
    ``LocalPhases``): each table-heavy phase is a kernel wrapper on the whole
    grid, and the dense glue is plain PyTorch. ``parallel/sharded_sm.py``'s
    ``ShardedPhases`` provides the same phases on an x-slab of the grid, so
    both paths run one step definition."""

    def __init__(self, params: SimParams):
        self.params = params

    def solids(self, solids: Optional[SolidState]):
        """-> (occupancy, solid velocity) of the grid, or (None, None)."""
        if solids is None:
            return None, None
        return solids.occupancy, solids.velocity

    def p2g_raw(self, posq, dyn):
        return p2g.p2g(posq, dyn)

    def p2g_density(self, posq):
        return p2g.p2g(posq, None, density=True)

    def marker(self, fluid_count, occupancy):
        return marker_from_counts(fluid_count, self.params.grid_dim, occupancy)

    def normalize(self, acc, marker, dt):
        return p2g.normalize_velocity(acc, marker, self.params.gravity_grid, dt)

    def div_rhs(self, vel, marker, solid_vel):
        return compute_divergence_rhs(vel, marker, solid_vel)

    def den_rhs(self, raw_density, marker, dt):
        return density_rhs_from_raw(raw_density, marker, dt)

    def solve(self, initial_pressure, rhs, marker, config, dt):
        return pcg.solve_pressure(initial_pressure, rhs, marker, config, dt)

    def gridfix_vel(self, vel, pressure, marker, solid_vel):
        return gridfix.gridfix_remove(vel, pressure, marker, solid_vel)

    def gridfix_den(self, pressure, marker, dt):
        return gridfix.gridfix_change(pressure, marker, dt)

    def advect_pack(self, posq, vel, dt, occupancy, solid_vel, k_mid):
        """G2P advect, then the x pack into k_mid slots: -> (posq, dyn, max |v|)."""
        posq, dyn, max_speed = g2p.advect(posq, vel, dt, occupancy, solid_vel)
        posq, dyn, _, _ = rebin.pack(posq, dyn, 0, g2p.ADVECT_SHIFT, k_mid)
        return posq, dyn, max_speed

    def correct_pack(self, posq, dyn, change, marker, k_mid):
        posq = g2p.correct(posq, change, marker)
        posq, dyn, _, _ = rebin.pack(posq, dyn, 0, g2p.CORRECT_SHIFT, k_mid)
        return posq, dyn

    def rebin_yz(self, posq, dyn, s, k, lost, before, out=None):
        return rebin.rebin_yz(posq, dyn, s, k, lost, before, out)


def step_core(
    params: SimParams, state: DenseFluidState, dt, solids: Optional[SolidState] = None, out=None, phases=None
) -> DenseFluidState:
    """One substep of length ``dt`` (f32), with the voxelized ``solids`` of
    this substep or none. ``out``: a (posq, dyn) pair the last rebin writes
    the new table into (the frame graphs' static table) instead of new
    tensors. ``phases``: the phase provider, ``LocalPhases`` by default (the
    mesh passes ``ShardedPhases``). The input state is not modified (apart
    from ``out``)."""
    dt = np.float32(dt)
    if solids is not None:
        occupancy, solid_vel = solids.occupancy, solids.velocity
        if tuple(occupancy.shape) != tuple(params.grid_dim) or tuple(solid_vel.shape) != (3,) + tuple(params.grid_dim):
            raise ValueError(
                f"solids of shape {tuple(occupancy.shape)} / {tuple(solid_vel.shape)} do not fit the grid "
                f"{tuple(params.grid_dim)}"
            )
    ph = LocalPhases(params) if phases is None else phases
    occupancy, solid_vel = ph.solids(solids)
    table = state.table
    k = table.capacity
    k_mid = k + stage_slack(params, k)
    n0 = params.num_particles

    with record_function("ph_p2g"):
        acc = ph.p2g_raw(table.posq, table.dyn)
    with record_function("ph_marker"):
        marker = ph.marker(acc[-1], occupancy)
        vel = ph.normalize(acc, marker, dt)
    with record_function("ph_div_rhs"):
        rhs = ph.div_rhs(vel, marker, solid_vel)
    with record_function("ph_pcg_vel"):
        res_vel = ph.solve(state.pressure_vel, rhs, marker, params.solver_vel, dt)
    with record_function("ph_gridfix_vel"):
        vel = ph.gridfix_vel(vel, res_vel.pressure, marker, solid_vel)

    lost = table.lost
    with record_function("ph_advect"):
        posq, dyn, max_speed = ph.advect_pack(table.posq, vel, dt, occupancy, solid_vel, k_mid)
    with record_function("ph_rebin2"):
        posq, dyn, lost = ph.rebin_yz(posq, dyn, g2p.ADVECT_SHIFT, k, lost, n0 - lost)

    with record_function("ph_p2g_density"):
        dacc = ph.p2g_density(posq)
    with record_function("ph_den_rhs"):
        marker2 = ph.marker(dacc[1], occupancy)
        den_rhs = ph.den_rhs(dacc[0], marker2, dt)
    with record_function("ph_pcg_den"):
        res_den = ph.solve(state.pressure_den, den_rhs, marker2, params.solver_den, dt)
    with record_function("ph_gridfix_den"):
        change = ph.gridfix_den(res_den.pressure, marker2, dt)
    with record_function("ph_correct"):
        posq, dyn = ph.correct_pack(posq, dyn, change, marker2, k_mid)
    with record_function("ph_rebin1"):
        posq, dyn, lost = ph.rebin_yz(posq, dyn, g2p.CORRECT_SHIFT, k, lost, n0 - lost, out)

    return DenseFluidState(
        table=SlotMajorTable(posq=posq, dyn=dyn, lost=lost, grid_dim=table.grid_dim),
        pressure_vel=res_vel.pressure,
        pressure_den=res_den.pressure,
        step_index=state.step_index + 1,
        stats_vel=res_vel.stats,
        stats_den=res_den.stats,
        # position correction leaves velocities alone: the advect by-product
        # is the substep's final max |v|
        max_speed=max_speed,
    )


def substep_count(params: SimParams, state: DenseFluidState, cfl_target: float, max_substeps: int) -> int:
    """clip(ceil(max_speed * dt / cfl), 1, max_substeps) in f32; one 4-byte
    read of the device scalar."""
    if not (cfl_target > 0 and max_substeps > 1):
        return 1
    ms = np.float32(state.max_speed.item())
    cells = ms * np.float32(params.dt) / np.float32(cfl_target)
    return int(min(max(math.ceil(float(cells)), 1), max_substeps))


def eager_frame(
    params: SimParams,
    state: DenseFluidState,
    solids_fn: Callable[[int, int], Optional[SolidState]],
    n_sub: int,
    phases=None,
) -> DenseFluidState:
    """One frame as n_sub eager ``step_core`` calls of dt / n_sub: the CPU
    path, the profiler's mode, the mesh's frame (``phases``) and the
    reference the graph replays are held against. ``solids_fn(i, n_sub)``
    gives the solids of substep i."""
    sub_dt = np.float32(params.dt) / np.float32(n_sub)
    for i in range(n_sub):
        state = step_core(params, state, sub_dt, solids_fn(i, n_sub), phases=phases)
    return state


NUM_SCALARS = 6  # the static scalars: vel error, vel iterations, den error, den iterations, lost, max speed


def _f32_view(scalars: torch.Tensor, i: int) -> torch.Tensor:
    """A 0-d f32 view of int32 word ``i`` of ``scalars``."""
    return scalars[i:i + 1].view(torch.float32).squeeze(0)


def _scalars(state: DenseFluidState):
    """The state's six scalars (0-d tensors), in the order of
    ``NUM_SCALARS``."""
    return (state.stats_vel.error, state.stats_vel.iterations, state.stats_den.error, state.stats_den.iterations,
            state.table.lost, state.max_speed)


def _words(scalars) -> torch.Tensor:
    """Six 0-d scalars -> int32[6], f32 ones by their bits."""
    return torch.stack([a.view(torch.int32) for a in scalars])


def scalar_words(state: DenseFluidState) -> torch.Tensor:
    """int32[NUM_SCALARS] on the state's device: the solver stats, lost and
    max speed (f32 ones by their bits) in one vector, for one copy to the
    host. A frame runner's static state hands out its own vector."""
    runner = state.runner
    if runner is not None and all(a is b for a, b in zip(_scalars(state), _scalars(runner.state))):
        return runner.scalars
    return _words(_scalars(state))


def decode_scalars(words) -> dict:
    """``scalar_words`` read back on the host (a numpy int32[6]) -> the
    stats as Python numbers."""
    w = np.asarray(words, np.int32)
    f = w.view(np.float32)
    return {"error_vel": float(f[0]), "iterations_vel": int(w[1]), "error_den": float(f[2]),
            "iterations_den": int(w[3]), "lost": int(w[4]), "max_speed": float(f[5])}


class _FixedSolids:
    """``solids_fn`` of ``frame_dense``: the same solids for every substep.
    Two are equal when they hold the same SolidState object, so a frame
    runner keyed by it survives from frame to frame."""

    def __init__(self, solids: Optional[SolidState]):
        self.solids = solids

    def __call__(self, i: int, n_sub: int) -> Optional[SolidState]:
        return self.solids

    def __eq__(self, other) -> bool:
        return isinstance(other, _FixedSolids) and other.solids is self.solids

    __hash__ = None


class FrameGraphs:
    """The frame as one CUDA-graph replay per frame, the counterpart of the
    JAX package's jitted frame (one dispatch per frame).

    It owns a static state (every tensor of a ``DenseFluidState``, the six
    scalars in one int32 vector) and one ``torch.cuda.CUDAGraph`` per n_sub,
    captured the first time a frame needs that n_sub: n_sub ``step_core``
    calls at dt / n_sub, whose last rebin writes the static table (the
    substep's input is dead by then), then copies of the two pressures, the
    six scalars and, with solids, the last substep's solids into the static
    buffers. sub_dt, the tolerances and every host value are frozen into a
    graph, which is why there is one per n_sub; ``solids_fn(i, n_sub)`` is
    called while capturing, so what it reads from device tensors is re-read
    at every replay and what it takes from the host is frozen (as under
    ``jax.jit``). The graphs share one memory pool: nothing allocated inside
    a capture outlives its replay (every result is copied to a static
    buffer), and replays run one after another on one stream.

    The first frame of a runner runs eagerly (``eager_frame``): it builds and
    loads the kernels and fills the occupancy caches before any capture, and
    its result becomes the static state. A capture records launches instead
    of running them, so it does not advance the simulation; each graph's
    launch tally (``cuda.capture_tally``) is added to the counts at every
    replay. The garbage collector runs before a capture and is held off
    during it: destroying a dead graph inside a capture fails it. The
    returned states refer to the runner, the runner not to them, so a
    dropped runner is freed at once. A failed capture or replay raises;
    nothing falls back.
    """

    def __init__(self, params: SimParams, solids_fn: Callable[[int, int], Optional[SolidState]]):
        self.params = params
        self.solids_fn = solids_fn
        self.state: Optional[DenseFluidState] = None  # the static state, after the first frame
        self.scalars: Optional[torch.Tensor] = None  # int32[NUM_SCALARS], views in self.state
        self.solids: Optional[SolidState] = None  # static: the solids of the last substep
        self.graphs = {}  # n_sub -> (CUDAGraph, launch tally)
        self.capture_s = {}  # n_sub -> seconds its capture took
        self._pool = None

    def matches(self, params: SimParams, solids_fn) -> bool:
        return self.params == params and (self.solids_fn is solids_fn or self.solids_fn == solids_fn)

    def _allocate(self, state: DenseFluidState, solids: Optional[SolidState]) -> None:
        t = state.table
        dev = t.posq.device
        self.scalars = torch.zeros(NUM_SCALARS, dtype=torch.int32, device=dev)
        w = self.scalars
        self.state = DenseFluidState(
            table=SlotMajorTable(posq=torch.empty_like(t.posq), dyn=torch.empty_like(t.dyn), lost=w[4],
                                 grid_dim=t.grid_dim),
            pressure_vel=torch.empty_like(state.pressure_vel),
            pressure_den=torch.empty_like(state.pressure_den),
            step_index=state.step_index,
            stats_vel=SolverStats(error=_f32_view(w, 0), iterations=w[1]),
            stats_den=SolverStats(error=_f32_view(w, 2), iterations=w[3]),
            max_speed=_f32_view(w, 5),
        )
        if solids is not None:
            self.solids = SolidState(occupancy=torch.empty_like(solids.occupancy),
                                     velocity=torch.empty_like(solids.velocity))

    def load(self, state: DenseFluidState) -> None:
        """Take ``state`` as the static state: each tensor that is not already
        the static one is copied in (none on the usual frame-to-frame path)."""
        s = self.state
        pairs = ((s.table.posq, state.table.posq), (s.table.dyn, state.table.dyn),
                 (s.pressure_vel, state.pressure_vel), (s.pressure_den, state.pressure_den))
        pairs += tuple(zip(_scalars(s), _scalars(state)))
        for dst, src in pairs:
            if src is not dst:
                if src.shape != dst.shape:
                    raise ValueError(f"state tensor of shape {tuple(src.shape)} where the frame's graphs hold "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        s.step_index = state.step_index

    def _store(self, out: DenseFluidState, solids: Optional[SolidState]) -> None:
        """Copy a frame's results that are not written in place into the
        static buffers."""
        s = self.state
        s.pressure_vel.copy_(out.pressure_vel)
        s.pressure_den.copy_(out.pressure_den)
        self.scalars.copy_(_words(_scalars(out)))
        if solids is not None:
            self.solids.occupancy.copy_(solids.occupancy)
            self.solids.velocity.copy_(solids.velocity)

    def _capture(self, n_sub: int):
        t0 = time.perf_counter()
        s = self.state
        sub_dt = np.float32(self.params.dt) / np.float32(n_sub)
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with cuda.capture_tally() as tally, torch.cuda.graph(graph, pool=self._pool):
                out = s
                for i in range(n_sub):
                    solids = self.solids_fn(i, n_sub)
                    last = (s.table.posq, s.table.dyn) if i == n_sub - 1 else None
                    out = step_core(self.params, out, sub_dt, solids, out=last)
                self._store(out, solids)
                del out, solids
        finally:
            if was_enabled:
                gc.enable()
        if self._pool is None:
            self._pool = graph.pool()
        self.graphs[n_sub] = (graph, tally)
        self.capture_s[n_sub] = time.perf_counter() - t0
        return self.graphs[n_sub]

    def run(self, state: DenseFluidState, n_sub: int) -> DenseFluidState:
        """One frame of n_sub substeps from ``state``; returns the static
        state. The frame takes ownership of ``state``, as the JAX package's
        jitted frame takes it donated: its tensors may be the static buffers,
        which the next frame overwrites (clone what must survive)."""
        if not state.table.posq.is_cuda:
            raise ValueError("frame graphs need the state on a CUDA device")
        if self.state is None:
            last = []

            def solids_fn(i, n):
                last[:] = [self.solids_fn(i, n)]
                return last[0]

            out = eager_frame(self.params, state, solids_fn, n_sub)
            self._allocate(out, last[0])
            self.load(out)
            if last[0] is not None:
                self.solids.occupancy.copy_(last[0].occupancy)
                self.solids.velocity.copy_(last[0].velocity)
        else:
            self.load(state)
            graph, tally = self.graphs.get(n_sub) or self._capture(n_sub)
            graph.replay()
            cuda.add_launches(tally)
            self.state.step_index += n_sub
        return dataclasses.replace(self.state, runner=self)


def frame_dense_fn(
    params: SimParams,
    state: DenseFluidState,
    solids_fn: Callable[[int, int], Optional[SolidState]],
    cfl_target: float = 1.9,
    max_substeps: int = 4,
) -> Tuple[DenseFluidState, int]:
    """One display frame (params.dt of simulated time) as n_sub substeps of
    dt / n_sub; ``solids_fn(i, n_sub)`` gives the solids of substep i of the
    n_sub-way split (or None). Returns (state, n_sub).

    On the card the frame replays the CUDA graph of its n_sub
    (``FrameGraphs``, kept on the returned state and reused while ``params``
    and ``solids_fn`` stay the same): the one host read is the 4-byte max
    speed that picks n_sub. The frame takes ownership of ``state`` (its
    tensors may be overwritten by the next frame), and ``solids_fn`` runs
    only in the runner's first (eager) frame and while a graph is captured,
    so what changes from frame to frame must reach it through device
    tensors. On the CPU it runs ``eager_frame``."""
    n_sub = substep_count(params, state, cfl_target, max_substeps)
    if not state.table.posq.is_cuda:
        return eager_frame(params, state, solids_fn, n_sub), n_sub
    runner = state.runner
    if runner is None or not runner.matches(params, solids_fn):
        runner = FrameGraphs(params, solids_fn)
    return runner.run(state, n_sub), n_sub


def frame_dense(
    params: SimParams,
    state: DenseFluidState,
    solids: Optional[SolidState] = None,
    cfl_target: float = 1.9,
    max_substeps: int = 4,
) -> Tuple[DenseFluidState, int]:
    """``frame_dense_fn`` with the same ``solids`` for every substep (on the
    card their tensors are read at every replay: update them in place)."""
    return frame_dense_fn(params, state, _FixedSolids(solids), cfl_target, max_substeps)


def multi_frame_dense(
    params: SimParams,
    state: DenseFluidState,
    num_frames: int,
    solids: Optional[SolidState] = None,
    cfl_target: float = 1.9,
    max_substeps: int = 4,
) -> Tuple[DenseFluidState, List[int]]:
    """``num_frames`` CFL frames (one graph replay each on the card; the
    state is taken over as in ``frame_dense_fn``). Returns (state, n_sub per
    frame)."""
    n_subs = []
    for _ in range(num_frames):
        state, n = frame_dense(params, state, solids, cfl_target, max_substeps)
        n_subs.append(n)
    return state, n_subs
