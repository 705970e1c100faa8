"""Process groups for the mesh path (``parallel/sharded_sm.py``).

``one_rank_group`` starts a group of world size 1 in this process (NCCL for a
CUDA device, gloo for the CPU) through a ``file://`` store, so no network is
touched. ``run_world`` spawns a world of n processes on this host, each with
its own group over a shared ``file://`` store, runs a function in every rank
and returns the ranks' results: the CPU tests' gloo worlds, and the card's
NCCL runs where the host has several cards (rank r takes card r). Under
``torchrun --nproc-per-node N`` the caller starts the default group itself
(``torch.distributed.init_process_group``, ``env://``) and passes
``mesh=N``.
"""

from __future__ import annotations

import os
import pathlib
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.device import resolve_device


def backend_for(device: torch.device) -> str:
    """NCCL for CUDA tensors, gloo for CPU ones: a CUDA tensor never goes
    through gloo."""
    return "nccl" if device.type == "cuda" else "gloo"


def _init(device: torch.device, store: pathlib.Path, rank: int, n: int) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device), init_method=f"file://{store}", rank=rank, world_size=n)


def one_rank_group(device: torch.device) -> None:
    """Start the default group with this process as its one rank."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")
    store = pathlib.Path(tempfile.mkdtemp(prefix="blub_pg_")) / "store"
    _init(device, store, 0, 1)


def _rank_main(rank: int, n: int, device: str, store: str, threads: int, fn, args, results) -> None:
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device) if device == "cpu" else torch.device("cuda", rank)
        _init(dev, pathlib.Path(store), rank, n)
        try:
            out = fn(rank, n, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # the parent raises with this rank's traceback
        results.put((rank, False, traceback.format_exc()))


def run_world(n: int, fn: Callable[..., Any], args: Sequence = (), device: str = "cuda", threads: int = 1,
              timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, n, device, *args)`` in n spawned processes, each rank
    of one group (NCCL on card ``rank`` for ``device="cuda"``, the default,
    which raises before spawning where CUDA is missing; gloo on
    ``device="cpu"``); ``fn`` must be importable (a module-level function)
    and its result picklable, and a calling script must guard its entry
    point with ``if __name__ == "__main__"`` (the ranks are spawned). Returns the results by rank; raises with the
    tracebacks if a rank fails, or if the world does not finish within
    ``timeout`` seconds (its processes are then killed)."""
    device = resolve_device(device).type
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="blub_world_")
    procs = [ctx.Process(target=_rank_main, args=(r, n, device, os.path.join(tmp, "store"), threads, fn,
                                                   tuple(args), results), daemon=True) for r in range(n)]
    try:
        for p in procs:
            p.start()
        out, errors = [None] * n, []
        for _ in range(n):
            try:
                rank, ok, val = results.get(timeout=timeout)
            except queue.Empty:
                raise RuntimeError(f"run_world: the world of {n} did not finish within {timeout} s") from None
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
                break  # the other ranks may wait on this one forever
        if errors:
            raise RuntimeError("run_world: a rank failed\n" + "\n".join(errors))
        for p in procs:
            p.join(timeout)
        return out
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
