"""The frame graph whose branch is picked on the card (``csrc/graph.cu``),
for ``sim/step_dense.FrameGraphs``.

``Captures`` records PyTorch work into CUDA graphs that share one memory
pool and keeps each one's ``cudaGraph_t`` (``torch.cuda.CUDAGraph(
keep_graph=True)``); none is instantiated on its own. ``BranchGraph``
composes a head and branches 1 .. maxn into one graph: the head, a
one-thread kernel that opens the IF node of the branch whose n equals the
device int32 ``n_sub`` (which the head writes), then one IF node per
branch, chained. ``replay()`` launches it on the current stream: one launch
per frame, and the host reads nothing. Conditional nodes need CUDA 12.4 or
later in the runtime and the driver. Where the composition fails, it raises
an error naming PyTorch's CUDA runtime, the library's and the driver's
versions; nothing falls back to a host read.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List

import torch

from . import cuda

_P, _I = cuda.P, cuda.I
_SIG = {
    "frame_graph_build": [_P, _P, _I, _P, _P, _P],
    "frame_graph_launch": [_P, _P],
    "frame_graph_destroy": [_P, _P],
    "graph_count_nodes": [_P, _P],
    "cuda_versions": [_P, _P],
}
NODE_KINDS = ("kernel", "memcpy", "memset", "other")


def _lib():
    return cuda.library("graph", _SIG)


def _version(v: int) -> str:
    return f"{v // 1000}.{v % 1000 // 10}"


def versions() -> Dict[str, str]:
    """PyTorch's CUDA runtime, the runtime ``graph.cu`` was built with, and
    the driver's CUDA version."""
    lib = _lib()
    rt, dr = ctypes.c_int(), ctypes.c_int()
    cuda.check(lib, lib.cuda_versions(ctypes.byref(rt), ctypes.byref(dr)), "cuda versions")
    return {"torch_cuda": str(torch.version.cuda), "runtime": _version(rt.value), "driver": _version(dr.value)}


class Captures:
    """CUDA graphs captured from PyTorch work into one memory pool, kept
    (with the pool) for as long as this object lives."""

    def __init__(self):
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.pool = None

    def capture(self, fn: Callable[[], None]) -> torch.cuda.CUDAGraph:
        try:
            g = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError as e:
            raise RuntimeError(f"PyTorch {torch.__version__} cannot keep a captured graph (keep_graph): the frame "
                               "graph needs it") from e
        with torch.cuda.graph(g, pool=self.pool):
            fn()
        if self.pool is None:
            self.pool = g.pool()
        self.graphs.append(g)
        return g


def node_counts(g: torch.cuda.CUDAGraph) -> Dict[str, int]:
    """The nodes of a captured graph by kind (child graphs descended into)."""
    lib = _lib()
    counts = (ctypes.c_int * len(NODE_KINDS))()
    cuda.check(lib, lib.graph_count_nodes(ctypes.c_void_p(g.raw_cuda_graph()), counts), "graph node count")
    out = dict(zip(NODE_KINDS, counts))
    out["total"] = sum(counts)
    return out


class BranchGraph:
    """``head``, then branch n of ``branches`` (n = 1 .. len) where the
    int32 ``n_sub`` is n, as one instantiated graph."""

    def __init__(self, captures: Captures, head: torch.cuda.CUDAGraph, branches: List[torch.cuda.CUDAGraph],
                 n_sub: torch.Tensor):
        self.captures = captures  # the pool and the graphs the composition was cloned from
        self.head, self.branches = head, branches
        self._graph, self._exec = ctypes.c_void_p(), ctypes.c_void_p()
        self._lib = lib = _lib()  # kept: __del__ may run while the interpreter shuts down
        raw = (ctypes.c_void_p * len(branches))(*[b.raw_cuda_graph() for b in branches])
        err = lib.frame_graph_build(ctypes.c_void_p(head.raw_cuda_graph()), raw, len(branches), cuda.ptr(n_sub),
                                    ctypes.byref(self._graph), ctypes.byref(self._exec))
        if err != 0:
            raise RuntimeError(
                f"the frame graph's conditional nodes failed (CUDA error {err}: "
                f"{lib.blub_error_string(err).decode()}); they need CUDA 12.4 or later in the runtime and the "
                f"driver: {versions()}")

    def replay(self) -> None:
        cuda.check(self._lib, self._lib.frame_graph_launch(self._exec, cuda.stream()), "frame graph launch")

    def __del__(self):
        if self._exec:
            self._lib.frame_graph_destroy(self._graph, self._exec)
            self._exec = None
