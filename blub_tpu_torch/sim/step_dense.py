"""The dense-table simulation step and the CFL frame (port of
``blub_tpu/sim/step_dense.py``: ``_step_core`` with ``LocalPhases``,
``frame_dense_fn``, ``frame_dense`` and ``multi_frame_dense``, and the
fixed-dt ``step_dense`` and ``multi_step_dense``; the JAX package's
``make_jitted_dense_step`` has no counterpart, since nothing is compiled).

One substep, in the reference's pass order (hybrid_fluid.rs:770-977) with the
two rebins that keep the table's bin invariant:

  P2G + fluid count -> marker, normalize, gravity -> divergence RHS ->
  PCG(vel) -> gridfix(remove) -> G2P advect + pack x -> pack y, z (+-2) ->
  P2G density -> density RHS -> PCG(den) -> gridfix(change) ->
  G2P correct + pack x -> pack y, z (+-1)

G2P and the x pack are one kernel each (``ops/advect_pack.py``), so the
moved table is never written. The fused kernels take every table the card's
packs take, so the step has no unfused branch: the JAX package's
``LocalPhases.fused`` gate would be true at every shape.

Each phase runs under ``torch.profiler.record_function`` with the JAX
package's scope names (``ph_*``). The particle count is n0 - lost (only
rebins drop particles), so the rebin's lost accounting needs no table-wide
reduction. A frame picks its substep count from the previous max speed,
clip(ceil(max_speed * dt / cfl), 1, max_substeps) in f32
(``substep_count_device``). On the card it does so on the card, as the JAX
frame does: the frame is one launch of a CUDA graph (``FrameGraphs``) that
computes the count, then runs the substep chain of that count behind a
conditional node, and the host reads nothing. On the CPU the frame is an
eager loop (``eager_frame``). With a ``SolidState`` both markers mark
occupied cells SOLID,
the divergence RHS takes the moving-wall terms, the velocity gridfix gives
faces into solids the solid velocity, and advect escapes, tests penetration
against the occupancy and pushes (the solids specialisations of the gridfix
and G2P kernels); the density half sees the solids through its marker.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core.device import resolve_device
from ..core.types import SimParams, SolidState, SolverStats
from ..ops import advect_pack, cuda, g2p, graph, gridfix, p2g, pcg, rebin
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
    step_index: torch.Tensor  # int32 scalar: substeps taken, counted on the device
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
        step_index=torch.zeros((), dtype=torch.int32, device=dev),
        stats_vel=SolverStats.zero(dev),
        stats_den=SolverStats.zero(dev),
        max_speed=torch.zeros((), dtype=torch.float32, device=dev),
    )


def stage_slack(grid_dim, capacity: int) -> int:
    """Slots a rebin's stage table holds beyond ``capacity`` between its two
    packs (k_mid = capacity + this), on a ``grid_dim`` grid."""
    x, y, z = grid_dim
    return rebin.default_slack(capacity * BYTES_PER_SLOT * x * y * z, capacity)


class LocalPhases:
    """The single-card phase provider of ``step_core`` (the JAX package's
    ``LocalPhases``): each table-heavy phase is a kernel wrapper on the whole
    grid, and the dense glue is plain PyTorch. ``parallel/sharded_sm.py``'s
    ``ShardedPhases`` provides the same phases on an x-slab of the grid, so
    both paths run one step definition. ``loops`` and ``counters``: what a
    frame graph's capture hands the mesh's solve and the tallies it keeps
    besides the launch counts; this provider's solve is one launch and
    keeps no other tally."""

    loops = None
    counters = ()

    def __init__(self, params: SimParams):
        self.params = params

    def __eq__(self, other) -> bool:
        return isinstance(other, LocalPhases) and other.params == self.params

    __hash__ = None

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
        """G2P advect fused with the x pack into k_mid slots: -> (posq, dyn,
        max |v|)."""
        return advect_pack.advect_pack(posq, vel, dt, occupancy, solid_vel, k_mid)

    def correct_pack(self, posq, dyn, change, marker, k_mid):
        return advect_pack.correct_pack(posq, dyn, change, marker, k_mid)

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
    k_mid = k + stage_slack(params.grid_dim, k)
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


def step_dense(params: SimParams, state: DenseFluidState, solids: Optional[SolidState] = None,
               dt=None) -> DenseFluidState:
    """One fixed-dt step: one eager ``step_core`` at ``params.dt``, or at
    ``dt`` when given (the JAX package's ``step_dense``). The input state is
    not modified."""
    return step_core(params, state, params.dt if dt is None else dt, solids)


def substep_count_device(params: SimParams, max_speed: torch.Tensor, cfl_target: float,
                         max_substeps: int) -> torch.Tensor:
    """The frame's substep count as the JAX frame computes it on the device,
    ``clip(ceil(max_speed * dt / cfl).astype(int32), 1, max_substeps)``: an
    int32 scalar on ``max_speed``'s device, nothing read on the host. The
    product and the quotient round apart in f32, and both divide truly (by
    tensors: PyTorch divides a CUDA tensor by a host scalar through its
    reciprocal). The clip is taken in f32 before the cast, with NaN taken to
    1 and inf to max_substeps, which is what JAX's cast and clip give on the
    CPU. 1 unless cfl_target > 0 and max_substeps > 1."""
    if not (cfl_target > 0 and max_substeps > 1):
        return torch.ones((), dtype=torch.int32, device=max_speed.device)
    dt = torch.full_like(max_speed, float(np.float32(params.dt)))
    cfl = torch.full_like(max_speed, float(np.float32(cfl_target)))
    n = torch.nan_to_num(torch.ceil((max_speed * dt) / cfl), nan=1.0)
    return torch.clamp(n, 1.0, float(max_substeps)).to(torch.int32)


def substep_count(params: SimParams, state: DenseFluidState, cfl_target: float, max_substeps: int) -> int:
    """``substep_count_device`` read on the host (on the card a 4-byte read
    that waits for the frame before): the eager frames' count."""
    if not (cfl_target > 0 and max_substeps > 1):
        return 1
    return int(substep_count_device(params, state.max_speed, cfl_target, max_substeps))


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
    n_sub = int(n_sub)
    sub_dt = np.float32(params.dt) / np.float32(n_sub)
    for i in range(n_sub):
        state = step_core(params, state, sub_dt, solids_fn(i, n_sub), phases=phases)
    return state


NUM_SCALARS = 7  # vel error, vel iterations, den error, den iterations, lost, max speed, n_sub
N_SUB = 6  # the word of the frame's substep count (0 where a state carries none)


def _f32_view(scalars: torch.Tensor, i: int) -> torch.Tensor:
    """A 0-d f32 view of int32 word ``i`` of ``scalars``."""
    return scalars[i:i + 1].view(torch.float32).squeeze(0)


def _scalars(state: DenseFluidState):
    """The state's six scalars (0-d tensors), in the order of the words."""
    return (state.stats_vel.error, state.stats_vel.iterations, state.stats_den.error, state.stats_den.iterations,
            state.table.lost, state.max_speed)


def _words(scalars) -> torch.Tensor:
    """0-d scalars -> int32[len], f32 ones by their bits."""
    return torch.stack([a.view(torch.int32) for a in scalars])


def scalar_words(state: DenseFluidState) -> torch.Tensor:
    """int32[NUM_SCALARS] on the state's device: the solver stats, lost and
    max speed (f32 ones by their bits) and the n_sub of the frame that made
    the state, in one vector for one copy to the host. A frame runner's
    static state hands out its own vector; any other state has no n_sub
    (0)."""
    runner = state.runner
    if runner is not None and all(a is b for a, b in zip(_scalars(state), _scalars(runner.state))):
        return runner.scalars
    words = _words(_scalars(state))
    return torch.cat([words, torch.zeros(NUM_SCALARS - len(words), dtype=torch.int32, device=words.device)])


def decode_scalars(words) -> dict:
    """``scalar_words`` read back on the host (a numpy int32[7]) -> the
    stats and n_sub as Python numbers."""
    w = np.asarray(words, np.int32)
    f = w.view(np.float32)
    return {"error_vel": float(f[0]), "iterations_vel": int(w[1]), "error_den": float(f[2]),
            "iterations_den": int(w[3]), "lost": int(w[4]), "max_speed": float(f[5]), "n_sub": int(w[N_SUB])}


class FixedSolids:
    """``solids_fn`` of ``frame_dense``: the same solids for every substep.
    Two are equal when they hold the same SolidState object, so a frame
    runner keyed by it survives from frame to frame."""

    def __init__(self, solids: Optional[SolidState]):
        self.solids = solids

    def __call__(self, i: int, n_sub: int) -> Optional[SolidState]:
        return self.solids

    def __eq__(self, other) -> bool:
        return isinstance(other, FixedSolids) and other.solids is self.solids

    __hash__ = None


class FrameGraphs:
    """The frame as one CUDA-graph launch whose substep count is decided on
    the card: the counterpart of the JAX package's jitted frame, which
    traces n_sub and runs its substeps in a ``fori_loop`` (no host read, one
    dispatch per frame).

    It owns a static state (every tensor of a ``DenseFluidState``, its
    scalars and the frame's n_sub in one int32 vector) and one graph
    (``ops/graph.BranchGraph``): a head that writes
    ``substep_count_device`` of the static max speed into the n_sub word,
    then one IF node per n in 1 .. maxn, which runs branch n where n_sub ==
    n. Branch n is n ``step_core`` calls at dt / n whose last rebin writes
    the static table (the substep's input is dead by then), then copies of
    the two pressures, step_index, the six scalars and, with solids, the
    last substep's solids into the static buffers, and one more frame in
    ``frames[n - 1]``. sub_dt, the tolerances and every host value are
    frozen into a branch, which is why there is one per n; ``solids_fn(i,
    n)`` is called while capturing, so what it reads from device tensors is
    re-read at every launch and what it takes from the host is frozen (as
    under ``jax.jit``). The head and the branches are PyTorch captures in one
    memory pool: nothing allocated inside a capture outlives its run (every
    result is copied to a static buffer), and one branch runs per launch.

    The first frame of a runner runs eagerly (``eager_frame``, its n_sub
    read on the host once): it builds and loads the kernels and fills the
    occupancy caches before the capture, and its result becomes the static
    state. The second frame captures the graph (all branches) and launches
    it. A capture records launches instead of running them, so it does not
    advance the simulation. ``phases`` is the step's phase provider
    (``LocalPhases`` by default; the mesh's ``ShardedPhases``, whose static
    state is this rank's slab). While a branch is captured the provider's
    ``loops`` is the branch's capture (``ops/graph.Chain``): the mesh's
    solves end the running segment there and run their iterations as CUDA
    WHILE nodes, so a branch is a chain of segments and loops; the head
    reads the static max speed, which the mesh all-reduces, so every rank
    opens the same branch. Each branch's launch tally (``cuda.capture_tally``)
    is counted per frame that ran it, and each loop body's per run, from
    the device counts of both (``frames``, ``graph.runs``), which
    ``cuda.count_branches`` reads when the launch counts are read (a
    ``ShardCtx``'s collective tally the same way). The garbage collector runs
    before the capture and is held off during it: destroying a dead graph
    inside a capture fails it. The returned states refer to the runner, the
    runner not to them, so a dropped runner is freed at once. A failed
    capture or launch raises (where the card or the CUDA version has no
    conditional nodes, naming the versions); nothing falls back.
    """

    def __init__(self, params: SimParams, solids_fn: Callable[[int, int], Optional[SolidState]],
                 cfl_target: float = 1.9, max_substeps: int = 4, phases=None):
        self.params = params
        self.phases = LocalPhases(params) if phases is None else phases
        self.solids_fn = solids_fn
        self.cfl_target, self.max_substeps = cfl_target, max_substeps
        self.maxn = max_substeps if cfl_target > 0 and max_substeps > 1 else 1
        self.state: Optional[DenseFluidState] = None  # the static state, after the first frame
        self.scalars: Optional[torch.Tensor] = None  # int32[NUM_SCALARS], views in self.state
        self.solids: Optional[SolidState] = None  # static: the solids of the last substep
        self.frames: Optional[torch.Tensor] = None  # int32[maxn]: frames run by branch n at [n - 1]
        self.graph: Optional[graph.BranchGraph] = None
        self.capture_s: Optional[float] = None  # seconds the capture took (head, branches, composition)

    def matches(self, params: SimParams, solids_fn, cfl_target: float, max_substeps: int, phases=None) -> bool:
        return (self.params == params and (self.solids_fn is solids_fn or self.solids_fn == solids_fn)
                and (self.cfl_target, self.max_substeps) == (cfl_target, max_substeps)
                and self.phases == (LocalPhases(params) if phases is None else phases))

    @property
    def n_sub(self) -> torch.Tensor:
        """The last frame's substep count: a 0-d int32 view of the static
        vector (the next frame overwrites it)."""
        return self.scalars[N_SUB]

    def _allocate(self, state: DenseFluidState, solids: Optional[SolidState]) -> None:
        t = state.table
        dev = t.posq.device
        self.scalars = torch.zeros(NUM_SCALARS, dtype=torch.int32, device=dev)
        self.frames = torch.zeros(self.maxn, dtype=torch.int32, device=dev)
        w = self.scalars
        self.state = DenseFluidState(
            table=SlotMajorTable(posq=torch.empty_like(t.posq), dyn=torch.empty_like(t.dyn), lost=w[4],
                                 grid_dim=t.grid_dim),
            pressure_vel=torch.empty_like(state.pressure_vel),
            pressure_den=torch.empty_like(state.pressure_den),
            step_index=torch.zeros((), dtype=torch.int32, device=dev),
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
                 (s.pressure_vel, state.pressure_vel), (s.pressure_den, state.pressure_den),
                 (s.step_index, state.step_index))
        pairs += tuple(zip(_scalars(s), _scalars(state)))
        for dst, src in pairs:
            if src is not dst:
                if src.shape != dst.shape:
                    raise ValueError(f"state tensor of shape {tuple(src.shape)} where the frame's graph holds "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)

    def _store(self, out: DenseFluidState, solids: Optional[SolidState]) -> None:
        """Copy a frame's results that are not written in place into the
        static buffers (the n_sub word is the head's)."""
        s = self.state
        s.pressure_vel.copy_(out.pressure_vel)
        s.pressure_den.copy_(out.pressure_den)
        s.step_index.copy_(out.step_index)
        self.scalars[:N_SUB].copy_(_words(_scalars(out)))
        if solids is not None:
            self.solids.occupancy.copy_(solids.occupancy)
            self.solids.velocity.copy_(solids.velocity)

    def _head(self) -> None:
        self.scalars[N_SUB].copy_(substep_count_device(self.params, self.state.max_speed, self.cfl_target,
                                                       self.max_substeps))

    def _branch(self, n: int, chain: graph.Chain) -> None:
        s = self.state
        sub_dt = np.float32(self.params.dt) / np.float32(n)
        out = s
        self.phases.loops = chain
        try:
            for i in range(n):
                solids = self.solids_fn(i, n)
                last = (s.table.posq, s.table.dyn) if i == n - 1 else None
                out = step_core(self.params, out, sub_dt, solids, out=last, phases=self.phases)
        finally:
            self.phases.loops = None
        self._store(out, solids)
        self.frames[n - 1:n].add_(1)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        counters = (cuda,) + tuple(self.phases.counters)
        try:
            captures = graph.Captures(counters)
            head = captures.capture(lambda chain: self._head())
            branches, tallies = [], []
            for n in range(1, self.maxn + 1):
                with contextlib.ExitStack() as stack:
                    tallies.append([stack.enter_context(c.capture_tally()) for c in counters])
                    branches.append(captures.capture(lambda chain, n=n: self._branch(n, chain)))
            self.graph = graph.BranchGraph(captures, head, branches, self.scalars[N_SUB])
        finally:
            if was_enabled:
                gc.enable()
        for j, c in enumerate(counters):
            c.count_branches(self, self.frames, [t[j] for t in tallies])
            if self.graph.loops:
                c.count_branches(self, self.graph.runs, [lp.tallies[j] for lp in self.graph.loops])
        self.capture_s = time.perf_counter() - t0

    def run(self, state: DenseFluidState) -> Tuple[DenseFluidState, torch.Tensor]:
        """One frame from ``state``; returns the static state and the
        frame's n_sub (a 0-d int32 on the card, the static word). The frame
        takes ownership of ``state``, as the JAX package's jitted frame takes
        it donated: its tensors may be the static buffers, which the next
        frame overwrites (clone what must survive)."""
        if not state.table.posq.is_cuda:
            raise ValueError("frame graphs need the state on a CUDA device")
        if self.state is None:
            last = []

            def solids_fn(i, n):
                last[:] = [self.solids_fn(i, n)]
                return last[0]

            n_sub = substep_count(self.params, state, self.cfl_target, self.max_substeps)
            out = eager_frame(self.params, state, solids_fn, n_sub, self.phases)
            self._allocate(out, last[0])
            self.load(out)
            self.scalars[N_SUB].fill_(n_sub)
            if last[0] is not None:
                self.solids.occupancy.copy_(last[0].occupancy)
                self.solids.velocity.copy_(last[0].velocity)
        else:
            self.load(state)
            if self.graph is None:
                self._capture()
            self.graph.replay()
        return dataclasses.replace(self.state, runner=self), self.n_sub


def frame_dense_fn(
    params: SimParams,
    state: DenseFluidState,
    solids_fn: Callable[[int, int], Optional[SolidState]],
    cfl_target: float = 1.9,
    max_substeps: int = 4,
    phases=None,
) -> Tuple[DenseFluidState, torch.Tensor]:
    """One display frame (params.dt of simulated time) as n_sub substeps of
    dt / n_sub, n_sub = ``substep_count_device`` of the state's max speed;
    ``solids_fn(i, n_sub)`` gives the solids of substep i of the n_sub-way
    split (or None). Returns (state, n_sub), n_sub a 0-d int32 tensor on the
    state's device, as the JAX frame returns it.

    On the card the frame is one launch of the runner's graph
    (``FrameGraphs``, kept on the returned state and reused while
    ``params``, ``solids_fn``, ``cfl_target`` and ``max_substeps`` stay the
    same), which picks n_sub on the card: nothing is read on the host. The
    frame takes ownership of ``state`` (its tensors, n_sub too, may be
    overwritten by the next frame), and ``solids_fn`` runs only in the
    runner's first (eager) frame and while the graph is captured, so what
    changes from frame to frame must reach it through device tensors. On
    the CPU it runs ``eager_frame``. ``phases``: the phase provider
    (``LocalPhases`` by default; ``parallel/sharded_sm.frame_dense_sharded_fn``
    passes ``ShardedPhases``)."""
    if not state.table.posq.is_cuda:
        n_sub = substep_count_device(params, state.max_speed, cfl_target, max_substeps)
        return eager_frame(params, state, solids_fn, int(n_sub), phases), n_sub
    runner = state.runner
    if runner is None or not runner.matches(params, solids_fn, cfl_target, max_substeps, phases):
        runner = FrameGraphs(params, solids_fn, cfl_target, max_substeps, phases)
    return runner.run(state)


def frame_dense(
    params: SimParams,
    state: DenseFluidState,
    solids: Optional[SolidState] = None,
    cfl_target: float = 1.9,
    max_substeps: int = 4,
) -> Tuple[DenseFluidState, torch.Tensor]:
    """``frame_dense_fn`` with the same ``solids`` for every substep (on the
    card their tensors are read at every launch: update them in place)."""
    return frame_dense_fn(params, state, FixedSolids(solids), cfl_target, max_substeps)


def multi_frame_dense(
    params: SimParams,
    state: DenseFluidState,
    num_frames: int,
    solids: Optional[SolidState] = None,
    cfl_target: float = 1.9,
    max_substeps: int = 4,
) -> Tuple[DenseFluidState, torch.Tensor]:
    """``num_frames`` CFL frames (one graph launch each on the card; the
    state is taken over as in ``frame_dense_fn``). Returns (state, n_sub per
    frame as int32[num_frames] on the state's device), as the JAX package's
    ``lax.scan`` returns ``i32[num_frames]``: each frame's n_sub is copied
    into it on the device, so the frames run with no host read."""
    n_subs = torch.zeros(num_frames, dtype=torch.int32, device=state.table.posq.device)
    for i in range(num_frames):
        state, n = frame_dense(params, state, solids, cfl_target, max_substeps)
        n_subs[i].copy_(n)
    return state, n_subs


def multi_step_dense(
    params: SimParams,
    state: DenseFluidState,
    num_steps: int,
    solids: Optional[SolidState] = None,
) -> DenseFluidState:
    """``num_steps`` fixed-dt steps at ``params.dt`` (the JAX package's
    ``multi_step_dense``, which scans ``step_dense``): each step is a frame
    of ``frame_dense`` with ``cfl_target=0``, whose n_sub is 1 whatever the
    speed, so its substep is ``step_dense``'s. On the card the runner holds
    one branch: a step is one graph launch after the runner's eager first
    one, and the state is taken over as in ``frame_dense_fn`` (clone what
    must survive the next step). On the CPU the frames run eagerly."""
    for _ in range(num_steps):
        state, _ = frame_dense(params, state, solids, cfl_target=0.0)
    return state
