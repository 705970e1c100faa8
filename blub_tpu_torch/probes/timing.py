"""Timing helpers of the probes and ``chip_smoke.py`` (CUDA only: a
measurement without a card raises, it never falls back to the CPU)."""

from __future__ import annotations

import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores

# cycles of the spin kernel that holds the stream while device_ms enqueues
# its launches (about 25 ms at the H100's 1.98 GHz boost clock)
_HOLD_CYCLES = 50_000_000


def require_card(name: str) -> None:
    """Exit with an error when there is no CUDA card (the probes' entry
    points measure the card and nothing else)."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{name}: needs a CUDA card")


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def _events(n: int):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back runs after one warm-up
    (CUDA events; includes whatever gaps the host leaves between launches)."""
    fn()
    torch.cuda.synchronize()
    start, end = _events(2)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` runs, without host gaps: a
    spin kernel holds the stream while the host enqueues all the runs, so
    they execute back to back. Raises if the host took longer to enqueue
    than the spin lasted (``fn`` must not synchronise)."""
    fn()
    torch.cuda.synchronize()
    cycles = _HOLD_CYCLES
    for _ in range(4):
        e0, e1, e2 = _events(3)
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        e2.record()
        torch.cuda.synchronize()
        if host_ms < e0.elapsed_time(e1):
            return e1.elapsed_time(e2) / reps
        cycles *= 4
    raise RuntimeError(f"device_ms: the host needed {host_ms:.1f} ms to enqueue {reps} runs")


def bound_ms(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the larger of bytes over the data-sheet
    memory rate and f32 operations over the f32 peak."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")
