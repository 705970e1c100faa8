"""Table round-trip bandwidth probe (port of ``scripts/tpu_bench_copy_bw.py``:
``pallas_step`` :74 and ``halo_step`` :105).

The probe adds 1 to every int32 word of a slot-major table (posq + dyn)
and writes it to a new table: the least traffic any table sweep has, read
once and written once. ``round_trip`` launches ``csrc/copy.cu`` for CUDA
tensors (``halo=True``: each 32-row y tile of posq also reads the 8 rows
before and after it, as the TPU probe's lead/trail blocks did) and takes the
plain version, ``posq + 1, dyn + 1``, for CPU tensors. The plain version is
also the one PyTorch call for the same function.

    python -m blub_tpu_torch.probes.copy_bw   # on a machine with a CUDA card

prints the device ms and GB/s of the plain call, the kernel and the kernel
with halos at the dam table shape, next to the card's name and power limit.
"""

from __future__ import annotations

import json

import torch

from ..ops import cuda
from . import timing, yz_floor

_SIG = {"copy_launch": [cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I, cuda.U, cuda.P]}


def round_trip_plain(posq: torch.Tensor, dyn: torch.Tensor):
    return posq + 1, dyn + 1


def _launch(lib, a: torch.Tensor, halo: bool) -> torch.Tensor:
    cuda.require(a, torch.int32, tuple(a.shape), "copy table")
    k, c, x, y, z = a.shape
    out = torch.empty_like(a)
    err = lib.copy_launch(cuda.ptr(a), cuda.ptr(out), k * c, x, y, z, int(halo), 0, cuda.stream())
    cuda.count_launch("copy")
    cuda.check(lib, err, "copy")
    return out


def round_trip(posq: torch.Tensor, dyn: torch.Tensor, halo: bool = False):
    """-> (posq + 1, dyn + 1); with ``halo`` the posq pass also reads y halos."""
    if not posq.is_cuda:
        return round_trip_plain(posq, dyn)
    if posq.shape[3] % 32 or posq.shape[4] % 4:
        raise ValueError(f"copy probe needs Y % 32 == 0 and Z % 4 == 0, got {tuple(posq.shape)}")
    lib = cuda.library("copy", _SIG)
    return _launch(lib, posq, halo), _launch(lib, dyn, False)


def measure(posq: torch.Tensor, dyn: torch.Tensor, reps: int = 20) -> dict:
    """ms per round trip of the plain call, the kernel and the kernel with
    halos (``ms``: device time back to back, ``timing.device_ms``; beside it
    the host-paced CUDA-event time), their GB/s at the device time (bytes
    read once + written once) and the kernels' max difference from the plain
    version."""
    ref = round_trip_plain(posq, dyn)
    err = 0
    for halo in (False, True):
        got = round_trip(posq, dyn, halo)
        err = max(err, max(int((g.long() - r.long()).abs().max().item()) for g, r in zip(got, ref)))
    nbytes = 2 * (posq.numel() + dyn.numel()) * 4
    out = {"bytes": nbytes, "max_abs_err": err}
    for name, fn in (("plain", lambda: round_trip_plain(posq, dyn)), ("kernel", lambda: round_trip(posq, dyn)),
                     ("kernel_halo", lambda: round_trip(posq, dyn, True))):
        ms = timing.device_ms(fn, reps)
        out[name] = {"ms": ms, "host_paced_ms": timing.cuda_ms(fn, reps), "gb_per_s": nbytes / ms / 1e6}
    return out


if __name__ == "__main__":
    timing.require_card("copy_bw")
    print(json.dumps({"card": timing.card_line(), **measure(*yz_floor.seeded_table()[:2])}))
