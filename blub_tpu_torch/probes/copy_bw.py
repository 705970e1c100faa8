"""Table round-trip bandwidth probe (port of ``scripts/tpu_bench_copy_bw.py``:
``pallas_step`` :74 and ``halo_step`` :105).

The probe adds 1 to every int32 word of a slot-major table (posq + dyn)
and writes it to a new table: the least traffic any table sweep has, read
once and written once. ``round_trip`` launches ``csrc/copy.cu`` once for
both tables of CUDA tensors (a block per 16 KB chunk of one flat range of
16-byte words, posq's then dyn's; ``halo=True``: each 32-row y tile of posq also reads the 8
rows before and after it, as the TPU probe's lead/trail blocks did) and
takes the plain version, ``posq + 1, dyn + 1``, for CPU tensors. The plain
version is also the one PyTorch call for the same function (two elementwise
kernels). The kernel takes Y % 32 == 0 and Z % 4 == 0 (``check_shapes``
raises otherwise).

    python -m blub_tpu_torch.probes.copy_bw   # on a machine with a CUDA card

prints the device ms (and host-paced ms) and GB/s of the plain call, the
kernel and the kernel with halos at the dam table shape, with the bound,
next to the card's name and power limit.
"""

from __future__ import annotations

import json

import torch

from ..ops import cuda
from ..sim.slot_major import NUM_DYN, NUM_POSQ
from . import timing, yz_floor

_SIG = {"copy_launch": [cuda.P, cuda.P, cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I, cuda.U, cuda.P]}
TILE_Y = 32  # y rows per halo tile of csrc/copy.cu (and of the TPU probe's blocks)


def round_trip_plain(posq: torch.Tensor, dyn: torch.Tensor):
    return posq + 1, dyn + 1


def check_shapes(posq: torch.Tensor, dyn: torch.Tensor) -> None:
    """Raises ValueError unless the kernel takes these tables: posq [K, 2,
    X, Y, Z] and dyn [K, 6, X, Y, Z] with Y a multiple of the 32-row halo
    tile and Z of the 4 words of a 16-byte access, under 2^31 such words
    together."""
    k, _, x, y, z = posq.shape
    if tuple(dyn.shape) != (k, NUM_DYN, x, y, z) or posq.shape[1] != NUM_POSQ:
        raise ValueError(f"copy probe needs posq [K, 2, X, Y, Z] and dyn [K, 6, X, Y, Z], got "
                         f"{tuple(posq.shape)}, {tuple(dyn.shape)}")
    if y % TILE_Y or z % 4 or (posq.numel() + dyn.numel()) // 4 >= 2**31:
        raise ValueError(f"copy probe needs Y % {TILE_Y} == 0, Z % 4 == 0 and fewer than 2^31 16-byte words, "
                         f"got {tuple(posq.shape)}")


def round_trip(posq: torch.Tensor, dyn: torch.Tensor, halo: bool = False):
    """-> (posq + 1, dyn + 1), one launch of the kernel for CUDA tensors;
    with ``halo`` each 32-row y tile of posq also reads its y halos."""
    if not posq.is_cuda:
        return round_trip_plain(posq, dyn)
    check_shapes(posq, dyn)
    cuda.require(posq, torch.int32, tuple(posq.shape), "copy posq")
    cuda.require(dyn, torch.int32, tuple(dyn.shape), "copy dyn")
    k, _, x, y, z = posq.shape
    lib = cuda.library("copy", _SIG)
    p_out, d_out = torch.empty_like(posq), torch.empty_like(dyn)
    err = lib.copy_launch(cuda.ptr(posq), cuda.ptr(p_out), cuda.ptr(dyn), cuda.ptr(d_out), k * NUM_POSQ * x,
                          k * NUM_DYN * x, y, z, int(halo), 0, cuda.stream())
    cuda.count_launch("copy")
    cuda.check(lib, err, "copy")
    return p_out, d_out


def measure(posq: torch.Tensor, dyn: torch.Tensor, reps: int = 20) -> dict:
    """ms per round trip of the plain call, the kernel and the kernel with
    halos (``ms``: device time back to back, ``timing.device_ms``; beside it
    the host-paced CUDA-event time), their GB/s at the device time (bytes
    read once + written once), the bound, and the kernels' max difference
    from the plain version (raises on any)."""
    ref = round_trip_plain(posq, dyn)
    err = 0
    for halo in (False, True):
        got = round_trip(posq, dyn, halo)
        err = max(err, max(int((g.long() - r.long()).abs().max().item()) for g, r in zip(got, ref)))
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"copy (halo={halo}) differs from posq + 1, dyn + 1 by {err}")
    nbytes = 2 * (posq.numel() + dyn.numel()) * 4
    bms, by = timing.bound_ms(nbytes, 0)
    out = {"bytes": nbytes, "bound_ms": bms, "bound_by": by, "max_abs_err": err}
    for name, fn in (("plain", lambda: round_trip_plain(posq, dyn)), ("kernel", lambda: round_trip(posq, dyn)),
                     ("kernel_halo", lambda: round_trip(posq, dyn, True))):
        ms = timing.device_ms(fn, reps)
        out[name] = {"ms": ms, "host_paced_ms": timing.cuda_ms(fn, reps), "gb_per_s": nbytes / ms / 1e6}
    return out


if __name__ == "__main__":
    timing.require_card("copy_bw")
    print(json.dumps({"card": timing.card_line(), **measure(*yz_floor.seeded_table()[:2])}))
