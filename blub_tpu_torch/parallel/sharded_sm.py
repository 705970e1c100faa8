"""The slot-major production step split along x over a ``torch.distributed``
process group (port of ``blub_tpu/parallel/sharded_sm.py``).

Rank r of n holds the x-slab [r X/n, (r+1) X/n) of every table and grid;
particle positions stay global. Each table-heavy phase runs its kernel on the
slab extended by an x halo, then keeps the slab's planes (its core):

  * TABLE halos come from the x neighbours (``dist.batch_isend_irecv``) with
    zero slots at the domain's ends, the "no particles beyond the edge" of
    the whole-grid kernels; GRID halos read by G2P wrap around the domain's
    ends, as the whole grid's cyclic reads do, so a window repeats the whole
    grid's reads bit for bit;
  * the fused G2P + x pack kernels (``ops/advect_pack.py``) take the
    window's global x origin (``x_start``, their ``with_xs`` variant) and
    the domain's dims, so their clamps and target bins are the domain's;
  * P2G runs its kernel as it is on the slab extended by one table plane
    (its neighbour masks stop at the window's ends, where the halo holds the
    neighbours' slots or zeros);
  * the dense glue (marker, normalization, divergence and density RHS) and
    gridfix run on the slab extended by their stencil reach, one plane,
    exchanged with zeros at the domain's ends (``gridops.shift``'s fill), and
    the marker marks the domain's border from the slab's x origin;
  * the PCG runs the ``pcg.cu`` pass kernels on the slab (``ops/pcg.py::
    slab_*``) with the halos of z and As exchanged between them and the
    partials of the dot products and max|r| all-reduced
    (``solve_pressure_sharded``): a whole-grid kernel cannot exchange halos
    inside its loop. Its loop predicate is computed on the device, and on
    the card the frame (``frame_dense_sharded_fn``) is one launch of a
    graph in which each solve's loop is a CUDA WHILE node, its collectives
    inside, as the JAX mesh frame holds its ``while_loop`` on the device.

Per-kernel wrappers give the whole-grid kernels' bits on every core;
a step on n > 1 ranks differs from the one-rank step only where the PCG's
dot products add the ranks' partials. At n == 1 the halo
exchange is local (as the JAX package's n == 1 branch) and the solve gives
``pcg_solve_kernel``'s bits. The max speed, the survivor counts and the PCG
scalars are all-reduced, so every rank holds the same lost count, n_sub and
solver stats. No table or grid is all-gathered on the step's path
(``ShardCtx.tally`` counts every collective by kind and bytes);
``gather_sm_state`` and ``gather_particles`` are readbacks for callers.
On the card the group is NCCL; a CUDA tensor never goes through gloo.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import SolverConfig
from ..core.types import SimParams, SolidState, SolverStats
from ..ops import advect_pack, cuda, g2p, gridfix, p2g, pcg, rebin
from ..sim.dense_transfer import density_rhs_from_raw
from ..sim.divergence import compute_divergence_rhs
from ..sim.pressure import PressureSolveResult, solve_tolerance
from ..sim.slot_major import NUM_DYN, NUM_POSQ, SlotMajorTable
from ..sim.sm_phases import marker_from_counts
from ..sim.step_dense import DenseFluidState, FixedSolids, frame_dense_fn, step_core

WIDEST_HALO = g2p.ADVECT_SHIFT + 2  # the fused advect + x pack with solids: s + hx
MAX_SLOTS = 64  # the pack kernels' widest slot mask


@dataclasses.dataclass(eq=False)
class ShardCtx:
    """The decomposition: a process group (None: the default group), this
    process's rank among n, its device, and the split axis "x". ``tally``
    counts the collectives this rank has issued, by kind ("p2p" sends,
    "all_reduce", "all_gather"): calls, bytes and the largest message. A
    CUDA graph records its collectives once, at capture: the frame graph
    hands each piece's tally (``capture_tally``) with the device count of
    that piece's runs to ``count_branches``, and reading ``tally`` adds each
    tally times the runs since the last read (one read of the card), as
    ``ops/cuda.launch_counts`` does for launches."""

    group: Optional[dist.ProcessGroup]
    rank: int
    n: int
    device: torch.device
    axis: str = "x"
    _tally: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    _scaled: List[cuda.Scaled] = dataclasses.field(default_factory=list)

    @staticmethod
    def from_group(device, group=None) -> "ShardCtx":
        """The context of this process in ``group`` (the default group if
        None), which must be initialized: NCCL for a CUDA device."""
        dev = torch.device(device)
        if not dist.is_initialized():
            raise RuntimeError("ShardCtx: no process group is initialized")
        backend = dist.get_backend(group)
        if (dev.type == "cuda") != (backend == "nccl"):
            raise ValueError(f"ShardCtx: a {dev.type} device in a {backend} group (NCCL for CUDA, gloo for the CPU)")
        return ShardCtx(group=group, rank=dist.get_rank(group), n=dist.get_world_size(group), device=dev)

    def x_slab(self, x: int) -> Tuple[int, int]:
        """(x0, xl): this rank's slab of a domain x planes wide."""
        if x % self.n:
            raise ValueError(f"an x extent of {x} does not split over {self.n} ranks")
        xl = x // self.n
        return self.rank * xl, xl

    @property
    def tally(self) -> Dict[str, Dict[str, int]]:
        self._scaled[:] = [s for s in self._scaled if s.resolve()]
        return self._tally

    def reset_tally(self) -> None:
        self.tally.clear()

    def _add(self, delta: Dict[str, Dict[str, int]], runs: int) -> None:
        for kind, d in delta.items():
            e = self._tally.setdefault(kind, {"calls": 0, "bytes": 0, "max_bytes": 0})
            e["calls"] += d["calls"] * runs
            e["bytes"] += d["bytes"] * runs
            e["max_bytes"] = max(e["max_bytes"], d["max_bytes"])

    @contextlib.contextmanager
    def capture_tally(self):
        """Around a CUDA-graph capture: yields a dict that receives, on exit,
        the collectives the block recorded (kind -> calls, bytes, largest),
        which stay out of ``tally``, since a capture runs nothing."""
        kept, self._tally = self._tally, {}
        captured: Dict[str, Dict[str, int]] = {}
        try:
            yield captured
        finally:
            captured.update(self._tally)
            self._tally = kept

    def count_branches(self, owner, runs: torch.Tensor, tallies: List[Dict[str, Dict[str, int]]]) -> None:
        """Count tallies[k] once per run in the device int32 ``runs[k]``,
        whenever ``tally`` is read, for as long as ``owner`` lives (and once
        after)."""
        self._scaled.append(cuda.Scaled(owner, runs, tallies, self._add))

    def _record(self, kind: str, t: torch.Tensor) -> None:
        nb = t.numel() * t.element_size()
        self._add({kind: {"calls": 1, "bytes": nb, "max_bytes": nb}}, 1)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In place over the group (also at n == 1, so the card's run goes
        through NCCL as a larger world does)."""
        self._record("all_reduce", t)
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor):
        """-> the ranks' ``t`` (of one shape), by rank. Readbacks only."""
        self._record("all_gather", t)
        out = [torch.empty_like(t) for _ in range(self.n)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return out

    def _neighbours(self, wrap: bool):
        r, n = self.rank, self.n
        return (r - 1) % n if (wrap or r > 0) else None, (r + 1) % n if (wrap or r < n - 1) else None

    def exchange(self, first: torch.Tensor, last: torch.Tensor, left_out: torch.Tensor, right_out: torch.Tensor,
                 wrap: bool) -> None:
        """Send this rank's ``first`` planes to its left neighbour and its
        ``last`` planes to its right one; receive the left neighbour's last
        planes into ``left_out`` and the right neighbour's first planes into
        ``right_out``. Without ``wrap`` the domain's ends receive nothing
        (the outputs keep what they hold). At n == 1 the exchange is local.
        The sends of the last planes go first and the receives of the left
        halo first, so at n == 2, where both neighbours are one rank, the
        two messages between a pair match in order (and by tag)."""
        if self.n == 1:
            if wrap:
                left_out.copy_(last)
                right_out.copy_(first)
            return
        left, right = self._neighbours(wrap)
        first, last = first.contiguous(), last.contiguous()
        ops = []
        if right is not None:
            ops.append(dist.P2POp(dist.isend, last, right, self.group, 0))
            self._record("p2p", last)
        if left is not None:
            ops.append(dist.P2POp(dist.isend, first, left, self.group, 1))
            self._record("p2p", first)
        recv_l = torch.empty_like(last) if left is not None and not left_out.is_contiguous() else left_out
        recv_r = torch.empty_like(first) if right is not None and not right_out.is_contiguous() else right_out
        if left is not None:
            ops.append(dist.P2POp(dist.irecv, recv_l, left, self.group, 0))
        if right is not None:
            ops.append(dist.P2POp(dist.irecv, recv_r, right, self.group, 1))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if recv_l is not left_out:
            left_out.copy_(recv_l)
        if recv_r is not right_out:
            right_out.copy_(recv_r)


def _extend_x(ctx: ShardCtx, arr: torch.Tensor, h: int, dim: int, wrap: bool, exchange: bool = True) -> torch.Tensor:
    """``arr`` extended along x (dimension ``dim``) by h planes each side:
    [left halo | arr | right halo], the halos from the neighbours (``wrap``:
    cyclic over the domain; else zeros at its ends) or zeros
    (``exchange=False``)."""
    if h == 0:
        return arr
    xl = arr.shape[dim]
    if h > xl:
        raise ValueError(f"a halo of {h} planes is wider than the slab's {xl}")
    out_shape = list(arr.shape)
    out_shape[dim] = xl + 2 * h
    out = torch.zeros(out_shape, dtype=arr.dtype, device=arr.device)
    out.narrow(dim, h, xl).copy_(arr)
    if exchange:
        ctx.exchange(arr.narrow(dim, 0, h), arr.narrow(dim, xl - h, h), out.narrow(dim, 0, h),
                     out.narrow(dim, xl + h, h), wrap)
    return out


def _core(arr: torch.Tensor, h: int, xl: int, dim: int) -> torch.Tensor:
    return arr.narrow(dim, h, xl).contiguous()


def _pad_x(arr: torch.Tensor, lo: int, hi: int, dim: int) -> torch.Tensor:
    """Zero planes before and after ``arr`` along x."""
    pads = [0, 0] * (arr.dim() - 1 - dim) + [lo, hi]
    return torch.nn.functional.pad(arr, pads)


def fill_halo(ctx: ShardCtx, ext: torch.Tensor) -> torch.Tensor:
    """The halo planes 0 and -1 of an extended grid [X+2, ...] from the
    neighbours' planes (zeros stay at the domain's ends)."""
    x = ext.shape[0] - 2
    ctx.exchange(ext[1:2], ext[x:x + 1], ext[0:1], ext[x + 1:x + 2], wrap=False)
    return ext


# --------------------------------------------------------------------------
# sharded kernel phases (posq/dyn: this rank's slab of the table; grids: its
# slab of the grid; domain: the whole grid's dims)


def p2g_raw_accumulators_sharded(ctx: ShardCtx, posq, dyn) -> torch.Tensor:
    """``ops/p2g.p2g`` (velocity and fluid count, f32[7, xl, Y, Z]) on the
    slab: the kernel as it is on the slab extended by one exchanged table
    plane, whose core is the whole-grid result bit for bit."""
    xl = posq.shape[2]
    acc = p2g.p2g(_extend_x(ctx, posq, 1, 2, wrap=False), _extend_x(ctx, dyn, 1, 2, wrap=False))
    return _core(acc, 1, xl, 1)


def p2g_density_sharded(ctx: ShardCtx, posq) -> torch.Tensor:
    """``ops/p2g.p2g(density=True)`` (raw density and fluid count) on the
    slab."""
    xl = posq.shape[2]
    acc = p2g.p2g(_extend_x(ctx, posq, 1, 2, wrap=False), None, density=True)
    return _core(acc, 1, xl, 1)


def _grid_windows(ctx: ShardCtx, grids, h: int):
    return [_extend_x(ctx, g_, h, 0, wrap=True) for g_ in grids]


def _solid_windows(ctx: ShardCtx, occupancy, solid_vel, h: int):
    if occupancy is None:
        return None, None
    return _extend_x(ctx, occupancy, h, 0, wrap=True), _extend_x(ctx, solid_vel, h, 1, wrap=True)


def _max_all(ctx: ShardCtx, ms: torch.Tensor) -> torch.Tensor:
    m = ms.reshape(1).clone()
    return ctx.all_reduce(m, dist.ReduceOp.MAX).reshape(())


def advect_sharded(ctx: ShardCtx, posq, vel, dt, occupancy, solid_vel, domain):
    """``g2p.advect`` on the slab: -> (posq, dyn, max speed all-reduced
    (MAX)). The table is zero-extended (advect is per slot), the grids are
    wrap-exchanged by the G2P reach (2 planes with solids, else 1)."""
    xl = posq.shape[2]
    x0, _ = ctx.x_slab(domain[0])
    h = 2 if occupancy is not None else 1
    occ_w, sv_w = _solid_windows(ctx, occupancy, solid_vel, h)
    out_p, out_d, ms = g2p.advect(_extend_x(ctx, posq, h, 2, wrap=False, exchange=False), _grid_windows(ctx, vel, h),
                                  dt, occ_w, sv_w, x_start=x0 - h, domain=domain)
    return _core(out_p, h, xl, 2), _core(out_d, h, xl, 2), _max_all(ctx, ms)


def correct_sharded(ctx: ShardCtx, posq, change, marker, domain):
    """``g2p.correct`` on the slab (grids wrap-exchanged by one plane)."""
    xl = posq.shape[2]
    x0, _ = ctx.x_slab(domain[0])
    out = g2p.correct(_extend_x(ctx, posq, 1, 2, wrap=False, exchange=False), _grid_windows(ctx, change, 1),
                      _extend_x(ctx, marker, 1, 0, wrap=True), x_start=x0 - 1, domain=domain)
    return _core(out, 1, xl, 2)


def pack_x_sharded(ctx: ShardCtx, posq, dyn, s: int, k_out: int, domain):
    """The x pack on the slab extended by s exchanged table planes (arrivals
    come in, emigrants' copies are cut off with the halo) -> (posq, dyn)
    of k_out slots."""
    xl = posq.shape[2]
    x0, _ = ctx.x_slab(domain[0])
    out_p, out_d, _, _ = rebin.pack(_extend_x(ctx, posq, s, 2, wrap=False), _extend_x(ctx, dyn, s, 2, wrap=False),
                                    0, s, k_out, x_start=x0 - s, dim=domain[0])
    return _core(out_p, s, xl, 2), _core(out_d, s, xl, 2)


def rebin_yz_sharded(ctx: ShardCtx, posq, dyn, s: int, k_out: int, lost, before, out=None):
    """``rebin.rebin_yz`` on the slab: the y and z packs are local (y and z
    moves never cross the x split); the kept count is all-reduced (SUM), so
    ``lost`` stays the same on every rank. -> (posq, dyn, lost)."""
    posq, dyn, counts = rebin.pack_yz(posq, dyn, s, k_out, out)
    kept = ctx.all_reduce(counts[3:4].clone()).reshape(())
    return posq, dyn, lost + (before - kept)


def rebin_sharded(ctx: ShardCtx, posq, dyn, s: int, k_mid: int, lost, before, domain):
    """A whole rebin on the slab (``rebin.rebin_slot_major``'s stages): the
    x pack on the s-extended window, then y and z locally. -> (posq, dyn,
    lost)."""
    k = posq.shape[0]
    posq, dyn = pack_x_sharded(ctx, posq, dyn, s, k_mid, domain)
    return rebin_yz_sharded(ctx, posq, dyn, s, k, lost, before)


def advect_pack_sharded(ctx: ShardCtx, posq, vel, dt, occupancy, solid_vel, k_out: int, domain):
    """G2P advect fused with the x pack (``ops/advect_pack.advect_pack``'s
    x-window form) on one window: the slab extended by h = s + hx planes (s
    = 2, the pack's reach; hx = 2 with solids, else 1, the G2P reach). The
    table's inner s halo planes are the neighbours' (the pack's arrivals),
    its outer hx planes zero, so every valid slot of the window has its
    whole grid neighbourhood (a real outer slot would feed a wrong velocity
    into the max speed); the grids are wrap-exchanged by h. -> (posq, dyn)
    of k_out slots on the slab, max speed all-reduced (MAX)."""
    xl = posq.shape[2]
    x0, _ = ctx.x_slab(domain[0])
    s = g2p.ADVECT_SHIFT
    hx = 2 if occupancy is not None else 1
    h = s + hx
    pq = _pad_x(_extend_x(ctx, posq, s, 2, wrap=False), hx, hx, 2)
    occ_w, sv_w = _solid_windows(ctx, occupancy, solid_vel, h)
    out_p, out_d, ms = advect_pack.advect_pack(pq, _grid_windows(ctx, vel, h), dt, occ_w, sv_w, k_out,
                                               x_start=x0 - h, domain=domain)
    return _core(out_p, h, xl, 2), _core(out_d, h, xl, 2), _max_all(ctx, ms)


def correct_pack_sharded(ctx: ShardCtx, posq, dyn, change, marker, k_out: int, domain):
    """G2P correct fused with the x pack (s = 1) on one window of h = 2
    planes each side (inner plane real, outer plane zero, as
    advect_pack_sharded). -> (posq, dyn) of k_out slots on the slab."""
    xl = posq.shape[2]
    x0, _ = ctx.x_slab(domain[0])
    s, hx = g2p.CORRECT_SHIFT, 1
    h = s + hx
    pq = _pad_x(_extend_x(ctx, posq, s, 2, wrap=False), hx, hx, 2)
    dy = _pad_x(_extend_x(ctx, dyn, s, 2, wrap=False), hx, hx, 2)
    out_p, out_d = advect_pack.correct_pack(pq, dy, _grid_windows(ctx, change, h),
                                            _extend_x(ctx, marker, h, 0, wrap=True), k_out, x_start=x0 - h,
                                            domain=domain)
    return _core(out_p, h, xl, 2), _core(out_d, h, xl, 2)


# --------------------------------------------------------------------------
# the PCG on the mesh


@dataclasses.dataclass(eq=False)
class SlabSolve:
    """The carried state of the mesh's PCG, in fixed buffers (the grids with
    one halo plane each side): what one iteration (``slab_iteration``) reads
    and writes in place, so that the same tensors serve every iteration, as
    a loop body captured once needs. ``it`` and ``go`` are device int32s:
    the iterations run and the loop predicate; ``it``'s parity picks the
    older grid of each pair r and s."""

    config: SolverConfig
    tol: float
    diag: torch.Tensor
    dfl: torch.Tensor
    p: torch.Tensor
    r: torch.Tensor  # [2, X+2, Y, Z]: r_old is r[it % 2], the iteration writes r[1 - it % 2]
    s: torch.Tensor  # [2, X+2, Y, Z]: s, paired as r
    z: torch.Tensor
    As: torch.Tensor
    scal: torch.Tensor  # f32[4]: sigma, alpha, beta, err
    part: torch.Tensor
    part_zr: torch.Tensor
    part_max: torch.Tensor
    it: torch.Tensor
    go: torch.Tensor


def slab_start(ctx: ShardCtx, initial_pressure, rhs, marker_ext, config: SolverConfig, dt) -> SlabSolve:
    """The solve's start on the slab: diag and dsafe (dfl's halo from the
    neighbours), p0 and r0 (r0's halo too), then z0 = K K^T r0 and sigma0 by
    the k2 pass with alpha = 0 and s = As = 0 (r0 into r[0], the r_old of
    iteration 0), its partials all-reduced, and the tail with beta = 0; it =
    0 and go = (max_num_iterations > 0), JAX's ``cond`` at the loop's
    entry."""
    dev = rhs.device
    diag, dfl = pcg.slab_setup(marker_ext)
    fill_halo(ctx, dfl)
    p, r0 = pcg.slab_init(_extend_x(ctx, initial_pressure, 1, 0, wrap=False), _pad_x(rhs, 1, 1, 0), diag, dfl)
    fill_halo(ctx, r0)
    r, s = (torch.zeros((2,) + tuple(dfl.shape), dtype=torch.float32, device=dev) for _ in range(2))
    st = SlabSolve(
        config=config, tol=solve_tolerance(config, dt), diag=diag, dfl=dfl, p=p, r=r, s=s,
        z=torch.zeros_like(dfl), As=torch.zeros_like(dfl),
        scal=torch.zeros(4, dtype=torch.float32, device=dev),
        part=pcg.slab_partials(rhs.shape, dev), part_zr=pcg.slab_partials(rhs.shape, dev),
        part_max=pcg.slab_partials(rhs.shape, dev), it=torch.zeros((), dtype=torch.int32, device=dev),
        go=torch.full((), int(config.max_num_iterations > 0), dtype=torch.int32, device=dev))
    # at parity 0 the pair (r0, r[0]) runs r0 -> r[0], and (s[1], s[0]) reads s[0] (zeros)
    pcg.slab_k2(st.p, (r0, r[0]), (s[1], s[0]), 0, st.As, None, st.scal, dfl, st.z, st.part_zr, st.part_max)
    ctx.all_reduce(st.part_zr)
    ctx.all_reduce(st.part_max, dist.ReduceOp.MAX)
    pcg.slab_tail(st.part_zr, st.part_max, st.scal, first=True)
    return st


def slab_iteration(ctx: ShardCtx, st: SlabSolve) -> None:
    """One PCG iteration on the slab, in place (JAX's ``body``), three
    launches: z's halo; k1 (s = z + beta s_old into the newer s, As = A s,
    the partials of s.As), its partials all-reduced (SUM); As's halo; k2
    (alpha from those partials in every block, p, the newer r, z, the
    partials of z.r and max|r|), its partials all-reduced (SUM, and max|r|
    MAX at every iteration, so that every rank takes the same branch of the
    predicate); the tail (beta, sigma, err, it += 1 and go). The older r and
    s are r[it % 2] and s[it % 2], read on the device, so the next iteration
    reads what this one wrote and nothing is copied; at world size 1 the
    body is the three kernels."""
    fill_halo(ctx, st.z)
    pcg.slab_k1(st.z, st.s, st.it, st.scal, st.diag, st.dfl, st.As, st.part)
    ctx.all_reduce(st.part)
    fill_halo(ctx, st.As)
    pcg.slab_k2(st.p, st.r, st.s, st.it, st.As, st.part, st.scal, st.dfl, st.z, st.part_zr, st.part_max)
    ctx.all_reduce(st.part_zr)
    ctx.all_reduce(st.part_max, dist.ReduceOp.MAX)
    cfg = st.config
    pcg.slab_tail(st.part_zr, st.part_max, st.scal, it=st.it, go=st.go, tol=st.tol, max_iter=cfg.max_num_iterations,
                  freq=max(cfg.error_check_frequency, 1))


def solve_pressure_sharded(ctx: ShardCtx, initial_pressure, rhs, marker_ext, config: SolverConfig, dt,
                           loops=None) -> PressureSolveResult:
    """PCG solve of A p = rhs on the slab's fluid cells (``marker_ext``: the
    marker with one halo plane each side): the ``pcg.cu`` pass kernels on
    the slab (``ops/pcg.py::slab_*``) with z's and As's x halos exchanged
    before the passes that read them at the neighbours and the partials of
    the dot products and max|r| all-reduced before their reductions, in
    three pieces: ``slab_start``, ``slab_iteration`` and its predicate, as
    the JAX solver's ``lax.while_loop``. Eagerly (``loops`` None: the CPU,
    the card's eager frames) a Python loop runs the iteration while the
    host reads go as 1. Inside a frame graph's capture ``loops`` is the
    capture (``ops/graph.Chain``), whose ``loop(body, go)`` makes the
    iteration the body of a CUDA WHILE node that runs while go is nonzero:
    the host reads nothing. The iterations are the device int32 ``it``."""
    st = slab_start(ctx, initial_pressure, rhs, marker_ext, config, dt)
    if loops is None:
        while int(st.go):
            slab_iteration(ctx, st)
    else:
        loops.loop(lambda: slab_iteration(ctx, st), st.go)
    stats = SolverStats(error=st.scal[pcg.ERR] * float(dt), iterations=st.it)
    return PressureSolveResult(pressure=_core(st.p, 1, rhs.shape[0], 0), stats=stats)


# --------------------------------------------------------------------------
# the sharded production step


def sharded_sm_supports(grid_dim, capacity: int, n: int) -> bool:
    """Whether the mesh path runs this configuration on n ranks. From the
    algorithm (as the JAX package): x splits into n equal slabs of at least
    4 planes (the widest halo, the fused advect + x pack with solids). From
    the port's kernels, in place of the TPU's VMEM budgets: K + the stage
    slack <= 64 slots (the packs' widest mask) and every table word of the
    widest window addressable by a 32-bit index. The TPU's y % 8 tile
    condition is not kept: the port's kernels take any y."""
    x, y, z = grid_dim
    if n < 1 or x % n or x // n < WIDEST_HALO:
        return False
    k_mid = capacity + rebin.default_slack(capacity * (NUM_POSQ + NUM_DYN) * 4 * x * y * z, capacity)
    words = k_mid * (NUM_POSQ + NUM_DYN) * (x // n + 2 * WIDEST_HALO) * y * z
    return k_mid <= MAX_SLOTS and words <= np.iinfo(np.int32).max


class ShardedPhases:
    """The mesh's phase provider of ``sim/step_dense.step_core``, the twin of
    ``LocalPhases``: one step definition runs both paths. Every grid it sees
    is this rank's slab, every table its slab of the table; the solids come
    whole and it keeps their slab. Each phase extends the grids it reads
    at the neighbours by one plane (``halo1``). While a frame graph captures
    a branch, ``loops`` is its capture, and each solve's loop becomes a
    WHILE node of the graph (``solve_pressure_sharded``); ``counters`` are
    the tallies a capture moves into the graph besides the launch counts."""

    loops = None

    def __init__(self, params: SimParams, ctx: ShardCtx):
        self.params = params
        self.ctx = ctx
        self.counters = (ctx,)
        self.domain = tuple(params.grid_dim)
        self.x0, self.xl = ctx.x_slab(self.domain[0])

    def __eq__(self, other) -> bool:
        return isinstance(other, ShardedPhases) and other.ctx is self.ctx and other.params == self.params

    __hash__ = None

    def halo1(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """``t`` extended by one exchanged plane each side (zeros at the
        domain's ends)."""
        return _extend_x(self.ctx, t, 1, dim, wrap=False)

    def _core(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return _core(t, 1, self.xl, dim)

    def solids(self, solids: Optional[SolidState]):
        if solids is None:
            return None, None
        sl = slice(self.x0, self.x0 + self.xl)
        return solids.occupancy[sl].contiguous(), solids.velocity[:, sl].contiguous()

    def p2g_raw(self, posq, dyn):
        return p2g_raw_accumulators_sharded(self.ctx, posq, dyn)

    def p2g_density(self, posq):
        return p2g_density_sharded(self.ctx, posq)

    def marker(self, fluid_count, occupancy):
        return marker_from_counts(fluid_count, self.domain, occupancy, x_start=self.x0)

    def normalize(self, acc, marker, dt):
        vel = p2g.normalize_velocity(_pad_x(acc, 1, 1, 1), self.halo1(marker), self.params.gravity_grid, dt)
        return tuple(self._core(v) for v in vel)

    def div_rhs(self, vel, marker, solid_vel):
        sv = None if solid_vel is None else self.halo1(solid_vel, 1)
        return self._core(compute_divergence_rhs([self.halo1(v) for v in vel], self.halo1(marker), sv))

    def den_rhs(self, raw_density, marker, dt):
        return self._core(density_rhs_from_raw(_pad_x(raw_density, 1, 1, 0), self.halo1(marker), dt))

    def solve(self, initial_pressure, rhs, marker, config, dt):
        return solve_pressure_sharded(self.ctx, initial_pressure, rhs, self.halo1(marker), config, dt, self.loops)

    def gridfix_vel(self, vel, pressure, marker, solid_vel):
        sv = None if solid_vel is None else self.halo1(solid_vel, 1)
        out = gridfix.gridfix_remove([self.halo1(v) for v in vel], self.halo1(pressure), self.halo1(marker), sv)
        return tuple(self._core(v) for v in out)

    def gridfix_den(self, pressure, marker, dt):
        out = gridfix.gridfix_change(self.halo1(pressure), self.halo1(marker), dt)
        return tuple(self._core(v) for v in out)

    def advect_pack(self, posq, vel, dt, occupancy, solid_vel, k_mid):
        return advect_pack_sharded(self.ctx, posq, vel, dt, occupancy, solid_vel, k_mid, self.domain)

    def correct_pack(self, posq, dyn, change, marker, k_mid):
        return correct_pack_sharded(self.ctx, posq, dyn, change, marker, k_mid, self.domain)

    def rebin_yz(self, posq, dyn, s, k, lost, before, out=None):
        return rebin_yz_sharded(self.ctx, posq, dyn, s, k, lost, before, out)


def step_dense_sharded(params: SimParams, ctx: ShardCtx, state: DenseFluidState,
                       solids: Optional[SolidState] = None, dt=None) -> DenseFluidState:
    """One substep of the mesh path: ``sim/step_dense.step_core``, the one
    step definition, with ``ShardedPhases``. ``state`` is this rank's slab
    state (``shard_sm_state``); ``solids`` the whole grid's."""
    return step_core(params, state, params.dt if dt is None else dt, solids, phases=ShardedPhases(params, ctx))


def frame_dense_sharded_fn(params: SimParams, ctx: ShardCtx, state: DenseFluidState, solids_fn,
                           cfl_target: float = 1.9, max_substeps: int = 4):
    """One CFL frame on the mesh: ``sim/step_dense.frame_dense_fn`` with
    ``ShardedPhases``. n_sub comes from the max speed, which every rank
    holds all-reduced, so every rank runs the same substeps. On the card
    the frame is one launch of the runner's graph (``FrameGraphs``, kept on
    the returned state), which picks n_sub on the card and runs each solve's
    loop as a WHILE node with its collectives inside: the host reads
    nothing. On the CPU (gloo) it runs ``eager_frame``. ``solids_fn(i,
    n_sub)`` gives substep i's solids (the whole grid's). -> (state, n_sub),
    n_sub a 0-d int32 tensor on the state's device, as the JAX frame."""
    return frame_dense_fn(params, state, solids_fn, cfl_target, max_substeps, phases=ShardedPhases(params, ctx))


def frame_dense_sharded(params: SimParams, ctx: ShardCtx, state: DenseFluidState,
                        solids: Optional[SolidState] = None, cfl_target: float = 1.9, max_substeps: int = 4):
    """``frame_dense_sharded_fn`` with the same solids every substep (on the
    card their tensors are read at every launch: update them in place)."""
    return frame_dense_sharded_fn(params, ctx, state, FixedSolids(solids), cfl_target, max_substeps)


# --------------------------------------------------------------------------
# state across the mesh


def shard_sm_state(ctx: ShardCtx, state: DenseFluidState) -> DenseFluidState:
    """This rank's x-slab of a whole ``DenseFluidState`` (built on the host
    or any device), on ``ctx.device``; the scalars are copied whole."""
    x, y, z = state.table.grid_dim
    x0, xl = ctx.x_slab(x)
    dev = ctx.device

    def slab(a, dim):
        return a.narrow(dim, x0, xl).contiguous().to(dev)

    t = state.table
    return DenseFluidState(
        table=SlotMajorTable(posq=slab(t.posq, 2), dyn=slab(t.dyn, 2), lost=t.lost.to(dev), grid_dim=(xl, y, z)),
        pressure_vel=slab(state.pressure_vel, 0),
        pressure_den=slab(state.pressure_den, 0),
        step_index=state.step_index.to(dev),
        stats_vel=SolverStats(error=state.stats_vel.error.to(dev), iterations=state.stats_vel.iterations.to(dev)),
        stats_den=SolverStats(error=state.stats_den.error.to(dev), iterations=state.stats_den.iterations.to(dev)),
        max_speed=state.max_speed.to(dev),
    )


def gather_sm_state(ctx: ShardCtx, state: DenseFluidState) -> DenseFluidState:
    """The whole state on every rank, from the ranks' slabs (an all-gather
    of tables and grids: a readback, never on the step's path)."""
    t = state.table
    xl, y, z = t.grid_dim

    def whole(a, dim):
        return torch.cat(ctx.all_gather(a), dim=dim)

    return dataclasses.replace(
        state,
        table=SlotMajorTable(posq=whole(t.posq, 2), dyn=whole(t.dyn, 2), lost=t.lost, grid_dim=(xl * ctx.n, y, z)),
        pressure_vel=whole(state.pressure_vel, 0), pressure_den=whole(state.pressure_den, 0), runner=None,
    )


def gather_particles(ctx: ShardCtx, table: SlotMajorTable) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions, velocities) f32[N, 3] of every rank's particles, on every
    rank, in the whole table's cell-major order: the counts are all-gathered,
    then the valid particles (padded to the largest count)."""
    pos, vel = table.particles()
    x0, _ = ctx.x_slab(table.grid_dim[0] * ctx.n)
    pos = pos + torch.tensor([float(x0), 0.0, 0.0], device=pos.device)
    cnt = torch.tensor([pos.shape[0]], dtype=torch.int64, device=pos.device)
    counts = [int(c.item()) for c in ctx.all_gather(cnt)]
    m = max(counts)
    both = torch.zeros((m, 6), dtype=torch.float32, device=pos.device)
    both[:pos.shape[0]] = torch.cat([pos, vel], dim=1)
    parts = [p[:c] for p, c in zip(ctx.all_gather(both), counts)]
    allp = torch.cat(parts, dim=0)
    return allp[:, :3].contiguous(), allp[:, 3:].contiguous()
