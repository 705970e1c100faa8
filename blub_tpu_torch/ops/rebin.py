"""Rebin pack: the stayers-keep-slots pack along one axis (port of
``blub_tpu/ops/pallas_rebin.py::_pack_core`` as run by ``_stage_x_kernel``,
``_stage_yz_kernel`` and the x-pack of the fused advect/correct kernels).

Per output cell, along ``axis`` within +-s (the placement spec,
``pallas_rebin.py:21-32`` and ``tests/test_rebin_overflow_spec.py``):

  1. stayers (target bin == own cell) with slot q < k_out keep slot q;
  2. movers queue in order: tail stayers (q >= k_out, ascending), then the
     slots of the cells at offsets -s..-1, +1..+s (slots ascending within
     each) whose target bin is this cell;
  3. the queue fills the empty output slots in ascending order; what is left
     of the queue is dropped.

The target bin along the axis is clip(cell + ((r + 4096) >> 13), 0, dim-1).
Movers rebase their rel16 field by the offset (an exact integer add on the
packed channel). Payload moves as int32 bits; empty slots are exact zeros.
A rebin is x (K -> K+slack), then y, then z (-> K); ``lost`` grows by the
particles the rebin did not keep (``rebin_slot_major``; the step runs the x
stage after its G2P phases and calls ``rebin_yz``).

``pack`` (one axis) and ``pack_yz`` (y then z, the counterpart of
``_stage_yz_kernel``) take the plain version for CPU tensors and launch
``csrc/pack.cu`` for CUDA tensors: ``pack_kernel`` and ``pack_yz_kernel``,
one launch each, counted as ``pack`` and ``pack_yz``. On the card they take
K <= 64 slots (32-bit slot masks up to 32, 64-bit ones beyond) and s <= 3,
and raise beyond (the JAX package takes any capacity).

``pack`` along x with ``x_start`` and ``dim`` is ``_stage_x_kernel``'s
``with_xs`` variant (the mesh's x-windows, ``parallel/sharded_sm.py``): the
table is an x-window whose column 0 is global x plane ``x_start`` of a domain
``dim`` planes wide, so target bins clip at the domain's walls; counted as
``pack_xs``.
"""

from __future__ import annotations

import torch

from ..sim.gridops import shift
from ..sim.slot_major import CH_XY, CH_ZV, HI_MASK, LO_MASK, NUM_DYN, NUM_POSQ, cell_coord, sext16, valid_mask
from . import cuda

_P, _I = cuda.P, cuda.I
_SIG = {
    "pack_launch": [_P] * 5 + [_I] * 10 + [_P],
    "pack_yz_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "pack_smem_bytes": [_I, _I, _I, _I, _I, _I, _I],
}
MAX_SLOTS = 64  # the widest slot-mask word
MAX_SHIFT = 3  # a placement code holds the offset index in 3 bits

SLACK_BYTE_BUDGET = 256 << 20  # per-stage buffer size above which slack drops


def default_slack(table_nbytes: int, capacity: int) -> int:
    """Stage-buffer slot slack (``pallas_rebin.default_slack``): 4 for small
    tables, 1 once a K+4-slot stage buffer passes 256 MiB. With the port's
    unpadded table bytes this gives 1 at the dam shape and 4 at test shapes,
    as the JAX formula does."""
    per_slot = table_nbytes // max(capacity, 1)
    return 1 if (capacity + 4) * per_slot > SLACK_BYTE_BUDGET else 4


def axis_rel(posq: torch.Tensor, axis: int) -> torch.Tensor:
    """int32 rel16 field along ``axis`` of every slot."""
    if axis == 0:
        return posq[:, CH_XY] >> 16
    if axis == 1:
        return sext16(posq[:, CH_XY])
    return posq[:, CH_ZV] >> 16


def _rebase(posq: torch.Tensor, axis: int, off: int) -> torch.Tensor:
    """Add ``off`` cells to the rel16 field along ``axis`` (slot_major
    layout), leaving the other half of the channel untouched."""
    v = off * 8192
    out = posq.clone()
    if axis == 1:
        b = posq[:, CH_XY]
        out[:, CH_XY] = (b & HI_MASK) | ((b + v) & LO_MASK)
    else:  # high half: add in int64 and wrap, no signed int32 overflow
        ch = CH_XY if axis == 0 else CH_ZV
        t = (posq[:, ch].to(torch.int64) + v * 65536) & 0xFFFFFFFF
        out[:, ch] = torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)
    return out


def pack_plain(posq, dyn, axis: int, s: int, k_out: int, x_start: int = 0, dim=None):
    """Plain PyTorch version: -> (posq_out, dyn_out, dropped, kept) with the
    counts as int32 0-dim tensors. ``x_start``/``dim``: an x-window of a
    domain ``dim`` planes wide (module docstring)."""
    k_in = posq.shape[0]
    grid = posq.shape[2:]
    dim_a = grid[axis] if dim is None else dim
    dev = posq.device
    coord = cell_coord(grid, axis, dev, torch.int32)
    valid = (posq[:, CH_ZV] & 1) == 1
    if x_start:  # the target in the window's frame, clipped at the domain's walls
        target = torch.clamp(coord + (x_start + ((axis_rel(posq, axis) + 4096) >> 13)), 0, dim_a - 1) - x_start
    else:
        target = torch.clamp(coord + ((axis_rel(posq, axis) + 4096) >> 13), 0, dim_a - 1)

    out_p = torch.zeros((k_out, NUM_POSQ) + tuple(grid), dtype=torch.int32, device=dev)
    out_d = torch.zeros((k_out, NUM_DYN) + tuple(grid), dtype=torch.int32, device=dev)
    stay = valid & (target == coord)
    taken = torch.zeros((k_out,) + tuple(grid), dtype=torch.bool, device=dev)
    n = min(k_in, k_out)
    taken[:n] = stay[:n]
    out_p[:n] = torch.where(stay[:n, None], posq[:n], 0)
    out_d[:n] = torch.where(stay[:n, None], dyn[:n], 0)
    empty = ~taken
    erank = torch.cumsum(empty.to(torch.int32), dim=0)  # inclusive rank of each empty slot
    n_empty = erank[-1]

    queued = torch.zeros(tuple(grid), dtype=torch.int32, device=dev)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)

    def assign(flag, pay_p, pay_d):
        nonlocal queued, dropped
        if not bool(flag.any()):  # nothing queues: every update below is a no-op
            return
        rank = queued + 1
        hit = flag[None] & empty & (erank == rank[None])
        out_p.bitwise_or_(torch.where(hit[:, None], pay_p[None], 0))
        out_d.bitwise_or_(torch.where(hit[:, None], pay_d[None], 0))
        dropped = dropped + (flag & (rank > n_empty)).sum(dtype=torch.int32)
        queued = queued + flag.to(torch.int32)

    for q in range(k_out, k_in):  # tail stayers re-home first
        assign(stay[q], posq[q], dyn[q])
    for off in [o for o in range(-s, s + 1) if o]:
        sh = [0, 0, 0]
        sh[axis] = off
        src_valid = shift(valid, sh)  # out of domain: invalid
        src_target = shift(target, sh)
        src_p = shift(_rebase(posq, axis, off), sh)
        src_d = shift(dyn, sh)
        for q in range(k_in):
            assign(src_valid[q] & (src_target[q] == coord), src_p[q], src_d[q])
    kept = ((out_p[:, CH_ZV] & 1) == 1).sum(dtype=torch.int32)
    return out_p, out_d, dropped, kept


def _kernel_outputs(posq, dyn, s: int, k_out: int, what: str, out=None):
    """Validate a pack kernel's arguments; -> the k_out-slot output tables on
    the tables' device: ``out`` (a (posq, dyn) pair, checked and used as it
    is) or new empty ones."""
    k_in, _, x, y, z = posq.shape
    if not (0 < k_out <= MAX_SLOTS and 0 < k_in <= MAX_SLOTS and 0 <= s <= MAX_SHIFT):
        raise ValueError(f"{what} on the card takes up to {MAX_SLOTS} slots (64-bit slot masks) and s <= {MAX_SHIFT} "
                         f"(k_in={k_in}, k_out={k_out}, s={s})")
    cuda.require(posq, torch.int32, (k_in, NUM_POSQ, x, y, z), f"{what} posq")
    cuda.require(dyn, torch.int32, (k_in, NUM_DYN, x, y, z), f"{what} dyn")
    if out is not None:
        cuda.require(out[0], torch.int32, (k_out, NUM_POSQ, x, y, z), f"{what} out posq")
        cuda.require(out[1], torch.int32, (k_out, NUM_DYN, x, y, z), f"{what} out dyn")
        if {out[0].data_ptr(), out[1].data_ptr()} & {posq.data_ptr(), dyn.data_ptr()}:
            raise ValueError(f"{what}: the output tables must not be the input tables")
        return out
    dev = posq.device
    return (torch.empty((k_out, NUM_POSQ, x, y, z), dtype=torch.int32, device=dev),
            torch.empty((k_out, NUM_DYN, x, y, z), dtype=torch.int32, device=dev))


def pack(posq: torch.Tensor, dyn: torch.Tensor, axis: int, s: int, k_out: int, x_start=None, dim=None):
    """One pack stage: -> (posq_out, dyn_out, dropped, kept), counts as int32
    0-dim tensors on the tables' device. ``x_start`` (an int) and ``dim``
    (the domain's x planes), axis 0 only: the x-window variant."""
    if axis not in (0, 1, 2):
        raise ValueError(f"pack axis must be 0, 1 or 2, got {axis}")
    window = x_start is not None
    if window and (axis != 0 or dim is None or not -posq.shape[2] < int(x_start) < int(dim)):
        raise ValueError(f"pack: an x-window (x_start {x_start}, domain {dim}) on axis {axis}")
    if (dim is not None) != window:
        raise ValueError("pack: dim comes with x_start")
    if not posq.is_cuda:
        return pack_plain(posq, dyn, axis, s, k_out, int(x_start) if window else 0, dim)
    out_p, out_d = _kernel_outputs(posq, dyn, s, k_out, "pack")
    k_in, _, x, y, z = posq.shape
    counts = torch.zeros(2, dtype=torch.int32, device=posq.device)
    lib = cuda.library("pack", _SIG)
    P = cuda.ptr
    err = lib.pack_launch(
        P(posq), P(dyn), P(out_p), P(out_d), P(counts), k_in, k_out, x, y, z, axis, s, int(window),
        int(x_start) if window else 0, int(dim) if window else x, cuda.stream()
    )
    cuda.count_launch("pack_xs" if window else "pack")
    cuda.check(lib, err, "pack")
    return out_p, out_d, counts[0], counts[1]


def pack_yz_plain(posq, dyn, s: int, k_out: int):
    """Plain version of ``pack_yz``: ``pack_plain`` along y (k_mid -> k_mid)
    then along z (-> k_out)."""
    p, d, dropped_y, kept_y = pack_plain(posq, dyn, 1, s, posq.shape[0])
    p, d, dropped_z, kept_z = pack_plain(p, d, 2, s, k_out)
    return p, d, torch.stack([dropped_y, kept_y, dropped_z, kept_z])


def pack_yz(posq: torch.Tensor, dyn: torch.Tensor, s: int, k_out: int, out=None):
    """The y pack (k_mid = posq.shape[0] slots in and out) then the z pack
    (-> k_out) in one launch, with no intermediate table: -> (posq_out,
    dyn_out, counts), counts int32 [y dropped, y kept, z dropped, z kept].
    ``out``: a (posq, dyn) pair the result is written into (not the
    inputs)."""
    if not posq.is_cuda:
        p, d, counts = pack_yz_plain(posq, dyn, s, k_out)
        if out is None:
            return p, d, counts
        out[0].copy_(p)
        out[1].copy_(d)
        return out[0], out[1], counts
    out_p, out_d = _kernel_outputs(posq, dyn, s, k_out, "pack_yz", out)
    k_mid, _, x, y, z = posq.shape
    counts = torch.zeros(4, dtype=torch.int32, device=posq.device)
    lib = cuda.library("pack", _SIG)
    P = cuda.ptr
    err = lib.pack_yz_launch(P(posq), P(dyn), P(out_p), P(out_d), P(counts), k_mid, k_out, x, y, z, s, cuda.stream())
    cuda.count_launch("pack_yz")
    cuda.check(lib, err, "pack_yz")
    return out_p, out_d, counts


def smem_bytes(k_in: int, k_out: int, grid, s: int, axis=None) -> int:
    """Dynamic shared memory per block of ``pack_kernel`` along ``axis``, or
    of ``pack_yz_kernel`` (``axis=None``, ``k_in`` = k_mid), at ``grid``."""
    x, y, z = grid
    return cuda.library("pack", _SIG).pack_smem_bytes(k_in, k_out, x, y, z, 3 if axis is None else axis, s)


def rebin_yz(posq, dyn, s: int, k_out: int, lost, before, out=None):
    """The y then z stages (K+slack -> K+slack -> k_out) in one ``pack_yz``
    (into ``out`` if given); ``lost`` grows by ``before`` minus the particles
    kept (``rebin_yz_slot_major``)."""
    posq, dyn, counts = pack_yz(posq, dyn, s, k_out, out)
    return posq, dyn, lost + (before - counts[3])


def rebin_slot_major(posq, dyn, s: int, slack: int, lost):
    """A whole rebin (``pallas_rebin.py::rebin_slot_major``): the x pack (K
    -> K+slack), then y and z (-> K); ``lost`` grows by the particles it did
    not keep. -> (posq, dyn, lost)."""
    k = posq.shape[0]
    before = valid_mask(posq).sum(dtype=torch.int32)
    posq, dyn, _, _ = pack(posq, dyn, 0, s, k + slack)
    return rebin_yz(posq, dyn, s, k, lost, before)
