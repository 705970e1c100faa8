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

prints the GB/s of the plain call, the kernel and the kernel with halos at
the dam table shape, next to the card's name and power limit.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import cuda

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


def dam_table(device="cuda", capacity: int = 14):
    """The dam cell's seeded table (128x64x64, K=14): posq and dyn."""
    from ..core.seeding import add_fluid_cube
    from ..sim.table import from_positions

    grid = (128, 64, 64)
    pos = add_fluid_cube(grid, (1, 1, 1), (64, 32, 63), 10**9)
    t = from_positions(pos, grid, capacity, device=device)
    rng = np.random.default_rng(0)
    t.dyn = torch.from_numpy(rng.integers(-2**31, 2**31, t.dyn.shape, dtype=np.int64).astype(np.int32)).to(device)
    return t.posq, t.dyn


def measure(posq: torch.Tensor, dyn: torch.Tensor, reps: int = 20) -> dict:
    """CUDA-event ms per round trip of the plain call, the kernel and the
    kernel with halos, their GB/s (bytes read once + written once) and the
    kernels' max difference from the plain version."""
    ref = round_trip_plain(posq, dyn)
    err = 0
    for halo in (False, True):
        got = round_trip(posq, dyn, halo)
        err = max(err, max(int((g.long() - r.long()).abs().max().item()) for g, r in zip(got, ref)))
    nbytes = 2 * (posq.numel() + dyn.numel()) * 4
    out = {"bytes": nbytes, "max_abs_err": err}
    for name, fn in (("plain", lambda: round_trip_plain(posq, dyn)), ("kernel", lambda: round_trip(posq, dyn)),
                     ("kernel_halo", lambda: round_trip(posq, dyn, True))):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        out[name] = {"ms": ms, "gb_per_s": nbytes / ms / 1e6}
    return out


if __name__ == "__main__":
    import subprocess

    if not torch.cuda.is_available():
        raise SystemExit("copy_bw: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, **measure(*dam_table())}))
