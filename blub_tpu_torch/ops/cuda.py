"""Build, load and count the hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries are
named by a hash of their sources and flags, so an edited source never loads a
stale build. ``build()`` starts one ``nvcc`` per source, all together.

No ``--use_fast_math``: flush-to-zero and approximate division would break
the bit patterns and the position quantization. ``-fmad=false`` keeps every
multiply and add separately rounded, as the plain PyTorch versions are, so a
kernel and its plain version can be compared tightly.

Every wrapper calls ``count_launch(name)`` where it launches its kernel, once
per ``__global__`` launch, and nowhere else; ``reset_launch_counts`` /
``launch_counts`` read the counts. Under CUDA-graph capture a wrapper's
launch is recorded, not run: ``capture_tally`` moves the capture's counts
into the graph's tally. The frame graph, whose branch is picked on the
card, keeps a device count of the frames each branch ran and registers it
with its branches' tallies (``count_branches``): the counts are resolved
from it whenever they are read or reset (one read of the card), so they
mean the same with and without graphs. A source may hold several counted
kernels: ``gridfix.cu`` and ``g2p.cu`` count their solids specialisations
apart (``gridfix_solids``, ``g2p_solids``), ``pack.cu`` its fused y + z
kernel (``pack_yz``), ``pcg.cu`` its history instantiation
(``pcg_history``), ``yz_floor.cu`` its streaming read kernel
(``yz_floor_read``). The mesh path's x-window instantiations of ``g2p.cu``
and ``pack.cu`` count as ``g2p_xs``, ``g2p_solids_xs`` and ``pack_xs``, and
``pcg.cu``'s slab passes as ``pcg_slab``. ``advect_pack.cu`` holds the
fused G2P + x pack kernels of the main path: ``advect_pack`` (with solids
``advect_pack_solids``) and ``correct_pack``, their x-window forms with
``_xs``. ``sdf.cu`` is the scene load's
mesh bake (``sdf``), its triangles' bounds (``sdf_bounds``), their order's
groups and tiles (``sdf_unite``) and its points' keys (``sdf_keys``).
``graph.cu`` holds no counted kernel: it composes the frame graph
(``ops/graph.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
import weakref
from typing import Callable, Dict, Iterable, List

import torch

SOURCES = ("p2g", "pcg", "gridfix", "g2p", "pack", "advect_pack", "copy", "yz_floor", "relops",
           "graph", "sdf")  # csrc/<name>.cu, one library each
KERNELS = ("p2g", "pcg", "pcg_history", "gridfix", "gridfix_solids", "g2p", "g2p_solids", "pack", "pack_yz",
           "copy", "yz_floor", "yz_floor_read", "relops", "g2p_xs", "g2p_solids_xs", "pack_xs",
           "pcg_slab", "sdf", "sdf_bounds", "sdf_unite", "sdf_keys", "advect_pack", "advect_pack_solids",
           "advect_pack_xs", "advect_pack_solids_xs", "correct_pack", "correct_pack_xs")  # launch counts

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(
    os.environ.get(
        "BLUB_TORCH_BUILD_DIR",
        pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels",
    )
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_COUNTS: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_BRANCHES: List["Scaled"] = []


class Scaled:
    """Tallies recorded once, at a graph's capture, and the device int32
    count of the runs of each (``runs[k]`` for ``tallies[k]``): ``resolve``
    passes each tally with the runs since the last call to ``add(tally,
    runs)`` (one read of the card) and says whether ``owner`` still lives."""

    def __init__(self, owner, runs: torch.Tensor, tallies: list, add: Callable[[dict, int], None]):
        self.owner = weakref.ref(owner)
        self.runs, self.tallies, self.add = runs, tallies, add
        self.seen = [0] * len(tallies)

    def resolve(self) -> bool:
        runs = self.runs.tolist()
        for tally, n, seen in zip(self.tallies, runs, self.seen):
            if n != seen:
                self.add(tally, n - seen)
        self.seen = runs
        return self.owner() is not None


def count_launch(name: str) -> None:
    _COUNTS[name] += 1


def _add_launches(tally: Dict[str, int], runs: int) -> None:
    for name, v in tally.items():
        _COUNTS[name] += v * runs


def count_branches(owner, frames: torch.Tensor, tallies: List[Dict[str, int]]) -> None:
    """Count the launches of a graph piece k that runs ``tallies[k]`` and
    adds one to the device int32 ``frames[k]`` each time (a frame graph's
    branch, a loop body): resolved whenever the counts are read, for as long
    as ``owner`` lives (and once after)."""
    _BRANCHES.append(Scaled(owner, frames, tallies, _add_launches))


def _resolve() -> None:
    _BRANCHES[:] = [b for b in _BRANCHES if b.resolve()]


def reset_launch_counts() -> None:
    _resolve()
    for k in _COUNTS:
        _COUNTS[k] = 0


def launch_counts() -> Dict[str, int]:
    _resolve()
    return dict(_COUNTS)


@contextlib.contextmanager
def capture_tally():
    """Around a CUDA-graph capture: yields a dict that receives, on exit, the
    launches the block recorded (name -> count, nonzero only) and takes them
    back out of the counts, since a capture launches nothing."""
    before = dict(_COUNTS)
    tally: Dict[str, int] = {}
    try:
        yield tally
    finally:
        for k, v in before.items():
            if _COUNTS[k] != v:
                tally[k] = _COUNTS[k] - v
            _COUNTS[k] = v


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all in parallel. Returns seconds per built source; raises with the
    compiler's output on any failure. The ptxas report (registers, spills)
    lands beside each library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
    times = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return times


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use), with
    ``argtypes``/``restype`` set from ``signatures``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build([name])
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.blub_error_string.argtypes = [ctypes.c_int]
    lib.blub_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: {lib.blub_error_string(err).decode()}")


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t: torch.Tensor, dtype: torch.dtype, shape, what: str) -> None:
    """Validate a kernel argument: CUDA, dtype, shape, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
F = ctypes.c_float
