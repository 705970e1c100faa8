"""rel16 fixed-point op smoke (port of ``scripts/tpu_smoke_relops.py``:
``kern`` :32, ``pallas_call`` :55).

The rel16 table layout (``sim/slot_major.py``) rests on a few integer ops:
round half to even, int32 <-> f32 converts, arithmetic shifts and masks,
and bit patterns carried through a select. ``relops`` runs that sequence on
f32 ``[8, 128]`` inputs ``pos`` and ``cell``:

    r  = round_half_even((pos - cell - 1) * 8192)   int32
    b  = (r << 16) | (r & 0xFFFF), carried through a select on pos > -1e9
    rx = b >> 16                                    as f32
    rt = cell + 1 + ((b << 16) >> 16) * 2^-13       the decode round trip

It launches ``csrc/relops.cu`` (the ``pack16``/``hi16``/``sext16`` helpers
of the table kernels) for CUDA tensors and takes the plain version for CPU
tensors. ``check`` holds kernel, plain version and the script's numpy
expressions to each other bit for bit on the script's seed-0 inputs, its tie
case and the ties and extremes of ``cases``.

    python -m blub_tpu_torch.probes.relops   # on a machine with a CUDA card
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import cuda
from ..sim.slot_major import LO_MASK, POS_INV, POS_SCALE, sext16
from . import timing

SHAPE = (8, 128)
_SIG = {"relops_launch": [cuda.P, cuda.P, cuda.P, cuda.P, cuda.I, cuda.P]}


def relops_plain(pos: torch.Tensor, cell: torch.Tensor):
    """-> (rx, rt), f32. ``torch.round`` rounds half to even; ``r << 16`` is
    written ``r * 65536`` (no left shift of a negative int32, the rule of
    ``sim/slot_major.py``)."""
    r = torch.round((pos - cell - 1.0) * POS_SCALE).to(torch.int32)
    packed = (r * 65536) | (r & LO_MASK)
    b = torch.where(pos > -1e9, packed.view(torch.float32), 0.0).view(torch.int32)
    return (b >> 16).to(torch.float32), cell + 1.0 + sext16(b).to(torch.float32) * POS_INV


def relops(pos: torch.Tensor, cell: torch.Tensor):
    """-> (rx, rt): the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if not pos.is_cuda:
        return relops_plain(pos, cell)
    shape = tuple(pos.shape)
    cuda.require(pos, torch.float32, shape, "relops pos")
    cuda.require(cell, torch.float32, shape, "relops cell")
    rx, rt = torch.empty_like(pos), torch.empty_like(pos)
    lib = cuda.library("relops", _SIG)
    err = lib.relops_launch(cuda.ptr(pos), cuda.ptr(cell), cuda.ptr(rx), cuda.ptr(rt), pos.numel(), cuda.stream())
    cuda.count_launch("relops")
    cuda.check(lib, err, "relops")
    return rx, rt


def numpy_expected(pos: np.ndarray, cell: np.ndarray):
    """The script's own expectations (``want_r``, ``want_rt``)."""
    want_r = np.round((pos - cell - 1.0).astype(np.float32) * 8192.0)
    want_rt = (cell + 1.0 + want_r * np.float32(2.0 ** -13)).astype(np.float32)
    return want_r, want_rt


def cases():
    """{name: (pos, cell)} f32 ``[8, 128]``: the script's seed-0 inputs, its
    tie (pos = 1 + 0.5 quantum, cell 0: rounds to 0), and one row each of the
    ties +1.5, -1.5, -0.5 and +2.5 quanta and the extremes +-3.5 cells over
    cells 0..381."""
    rng = np.random.default_rng(0)
    cell = rng.integers(0, 500, SHAPE).astype(np.float32)
    pos = cell + 1.0 + (rng.random(SHAPE).astype(np.float32) * 7.0 - 3.5)
    q = np.float32(2.0 ** -13)
    tie = np.full(SHAPE, np.float32(0.5) * q + np.float32(1.0), np.float32)
    cells = np.broadcast_to((np.arange(SHAPE[1]) * 3).astype(np.float32), SHAPE).copy()
    offs = np.float32([1.5 * q, -1.5 * q, -0.5 * q, 2.5 * q, 3.5, -3.5, 0.5 * q, 0.0])
    edges = (cells + np.float32(1.0) + offs[:, None]).astype(np.float32)
    return {"seed0": (pos, cell), "tie": (tie, np.zeros(SHAPE, np.float32)), "edges": (edges, cells)}


def check(device="cuda") -> float:
    """Kernel (on ``device``), plain version and numpy on every case; raises
    on any difference. Returns the max |kernel - plain| (0)."""
    for name, (pos, cell) in cases().items():
        want_r, want_rt = numpy_expected(pos, cell)
        p, c = torch.from_numpy(pos), torch.from_numpy(cell)
        ref = relops_plain(p, c)
        got = [a.cpu() for a in relops(p.to(device), c.to(device))]
        for g, r, w, what in zip(got, ref, (want_r, want_rt), ("rx", "rt")):
            if not torch.equal(g.view(torch.int32), r.view(torch.int32)):
                raise AssertionError(f"relops {name}: kernel {what} differs from the plain version")
            if not np.array_equal(r.numpy(), w):
                raise AssertionError(f"relops {name}: {what} differs from the script's numpy expression")
    return 0.0


def measure(reps: int = 200) -> dict:
    """Kernel ms per call on the seed-0 inputs, device time back to back
    (``timing.device_ms``) and host-paced (CUDA events around the wrapper
    calls), the plain version's ms, the bound (two f32 inputs read, two
    written; ~12 operations per element) and the launch floor
    (``launch_floor_ms``: the same kernel's device time on a [1, 1] slice of
    the inputs, back to back: what a launch costs with no work in it)."""
    pos, cell = (torch.from_numpy(a).cuda() for a in cases()["seed0"])
    p1, c1 = pos[:1, :1].contiguous(), cell[:1, :1].contiguous()
    floor = timing.device_ms(lambda: relops(p1, c1), reps)
    ms = timing.device_ms(lambda: relops(pos, cell), reps)
    paced = timing.cuda_ms(lambda: relops(pos, cell), reps)
    plain = timing.cuda_ms(lambda: relops_plain(pos, cell), reps)
    bms, by = timing.bound_ms(4 * 4 * pos.numel(), 12 * pos.numel())
    return {"shape": list(SHAPE), "ms": ms, "host_paced_ms": paced, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "launch_floor_ms": floor}


if __name__ == "__main__":
    timing.require_card("relops")
    err = check()
    print(json.dumps({"card": timing.card_line(), "max_abs_err": err, **measure()}))
