"""Graphs composed on the card from PyTorch captures (``csrc/graph.cu``), for
``sim/step_dense.FrameGraphs``.

``Captures`` records PyTorch work into CUDA graphs that share one memory
pool and keeps each one's ``cudaGraph_t`` (``torch.cuda.CUDAGraph(
keep_graph=True)``); none is instantiated on its own. A capture is a
``Chain``: the work cut into segments at its loops. Inside the captured
function, ``chain.loop(body, go)`` ends the running segment, captures
``body()`` as a graph of its own and begins the next segment; the
composition runs that body as a CUDA WHILE node while the device int32
``go`` (which the work before the loop and the body itself write) is
nonzero, and counts the body's runs on the card. Most captures have no
loop: one segment.

``BranchGraph`` composes a head and branches 1 .. maxn into one graph: the
head, a one-thread kernel that opens the IF node of the branch whose n
equals the device int32 ``n_sub`` (which the head writes), then one IF
node per branch, chained, each over its chain. ``ChainGraph`` is one chain
on its own. ``replay()`` launches either on the current stream: one launch,
and the host reads nothing. Conditional nodes need CUDA 12.4 or later in
the runtime and the driver. Where the composition fails, it raises an
error naming PyTorch's CUDA runtime, the library's and the driver's
versions; nothing falls back to a host read.

Captures run in the ``thread_local`` error mode: NCCL's watchdog thread of
PyTorch's process group may query its events while another thread
captures. A chain's segments and bodies share the pool in the order they
run (segment, body, segment, ...), so a tensor a body reads must be made
before the loop and outlive it (``parallel/sharded_sm.SlabSolve``).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Dict, List, Sequence

import torch

from . import cuda

_P, _I = cuda.P, cuda.I
_SIG = {
    "frame_graph_build": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "chain_graph_build": [_P, _I, _P, _P, _P, _P, _P],
    "graph_launch": [_P, _P],
    "graph_destroy": [_P, _P],
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


class Loop:
    """A loop of a chain: its body's graph, the device int32 ``go`` and the
    tallies its capture recorded (one per counter of the captures)."""

    def __init__(self, body: torch.cuda.CUDAGraph, go: torch.Tensor, tallies: list):
        self.body, self.go, self.tallies = body, go, tallies


class Chain:
    """One capture: ``segments[0]``, loop 0, ``segments[1]``, ..., the last
    segment."""

    def __init__(self, captures: "Captures"):
        self.captures = captures
        self.segments: List[torch.cuda.CUDAGraph] = []
        self.loops: List[Loop] = []
        self._open = None

    def loop(self, body: Callable[[], None], go: torch.Tensor) -> None:
        """Run ``body()`` while the device int32 ``go`` is nonzero (checked
        before each run): ends the running segment, captures the body (its
        tallies apart from the segment's) and begins the next segment."""
        cap = self.captures
        seg, self._open = self._open, None
        self.segments.append(cap.end(seg))
        with contextlib.ExitStack() as stack:
            tallies = [stack.enter_context(c.capture_tally()) for c in cap.counters]
            g = cap.begin()
            try:
                body()
            finally:
                cap.end(g)
        self.loops.append(Loop(g, go, tallies))
        self._open = cap.begin()


class Captures:
    """CUDA graphs captured from PyTorch work into one memory pool, kept
    (with the pool) for as long as this object lives. ``counters``: objects
    with ``capture_tally()`` (``ops/cuda``, a ``ShardCtx``) whose tallies a
    loop body keeps apart."""

    def __init__(self, counters: Sequence = (cuda,)):
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.pool = None
        self.counters = tuple(counters)
        self.stream = None

    def begin(self) -> torch.cuda.CUDAGraph:
        try:
            g = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError as e:
            raise RuntimeError(f"PyTorch {torch.__version__} cannot keep a captured graph (keep_graph): the frame "
                               "graph needs it") from e
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        return g

    def end(self, g: torch.cuda.CUDAGraph) -> torch.cuda.CUDAGraph:
        g.capture_end()
        if self.pool is None:
            self.pool = g.pool()
        self.graphs.append(g)
        return g

    def capture(self, fn: Callable[[Chain], None]) -> Chain:
        """``fn(chain)`` captured on a side stream, after a synchronize."""
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        torch.cuda.synchronize()
        chain = Chain(self)
        with torch.cuda.stream(self.stream):
            chain._open = self.begin()
            try:
                fn(chain)
            finally:
                if chain._open is not None:  # None where a loop body failed to capture
                    chain.segments.append(self.end(chain._open))
                    chain._open = None
        return chain


def node_counts(g) -> Dict[str, int]:
    """The nodes of a captured graph by kind (child graphs descended into),
    or of a chain: its segments' and its loop bodies' together."""
    if isinstance(g, Chain):
        out = dict.fromkeys(NODE_KINDS + ("total",), 0)
        for part in g.segments + [lp.body for lp in g.loops]:
            for k, v in node_counts(part).items():
                out[k] += v
        return out
    lib = _lib()
    counts = (ctypes.c_int * len(NODE_KINDS))()
    cuda.check(lib, lib.graph_count_nodes(ctypes.c_void_p(g.raw_cuda_graph()), counts), "graph node count")
    out = dict(zip(NODE_KINDS, counts))
    out["total"] = sum(counts)
    return out


class _Composed:
    """A graph composed in ``graph.cu`` from chains, instantiated; ``runs``:
    the device int32 count of each loop body's runs, in chain order."""

    def __init__(self, captures: Captures, chains: List[Chain], device):
        self.captures = captures  # the pool and the graphs the composition was cloned from
        self.loops = [lp for c in chains for lp in c.loops]
        self.runs = torch.zeros(max(1, len(self.loops)), dtype=torch.int32, device=device)
        self._graph, self._exec = ctypes.c_void_p(), ctypes.c_void_p()
        self._lib = _lib()  # kept: __del__ may run while the interpreter shuts down

    def _chain_args(self, chains: List[Chain]):
        """(segments, segments per chain, bodies, go pointers), flattened."""
        segs = [s for c in chains for s in c.segments]
        raw = (ctypes.c_void_p * len(segs))(*[s.raw_cuda_graph() for s in segs])
        nsegs = (ctypes.c_int * len(chains))(*[len(c.segments) for c in chains])
        nl = max(1, len(self.loops))
        bodies = (ctypes.c_void_p * nl)(*[lp.body.raw_cuda_graph() for lp in self.loops])
        gos = (ctypes.c_void_p * nl)(*[lp.go.data_ptr() for lp in self.loops])
        return raw, nsegs, bodies, gos

    def _built(self, err: int) -> None:
        if err != 0:
            raise RuntimeError(
                f"the graph's conditional nodes failed (CUDA error {err}: "
                f"{self._lib.blub_error_string(err).decode()}); they need CUDA 12.4 or later in the runtime and the "
                f"driver: {versions()}")

    def replay(self) -> None:
        cuda.check(self._lib, self._lib.graph_launch(self._exec, cuda.stream()), "graph launch")

    def __del__(self):
        if self._exec:
            self._lib.graph_destroy(self._graph, self._exec)
            self._exec = None


class BranchGraph(_Composed):
    """``head`` (a chain without loops), then branch n of ``branches`` (n =
    1 .. len) where the int32 ``n_sub`` is n, as one instantiated graph."""

    def __init__(self, captures: Captures, head: Chain, branches: List[Chain], n_sub: torch.Tensor):
        super().__init__(captures, branches, n_sub.device)
        if head.loops:
            raise ValueError("the frame graph's head holds a loop")
        self.head, self.branches = head.segments[0], branches
        segs, nsegs, bodies, gos = self._chain_args(branches)
        self._built(self._lib.frame_graph_build(
            ctypes.c_void_p(self.head.raw_cuda_graph()), len(branches), cuda.ptr(n_sub), segs, nsegs, bodies, gos,
            cuda.ptr(self.runs), ctypes.byref(self._graph), ctypes.byref(self._exec)))


class ChainGraph(_Composed):
    """One chain as an instantiated graph of its own."""

    def __init__(self, captures: Captures, chain: Chain):
        super().__init__(captures, [chain], torch.device("cuda", torch.cuda.current_device()))
        segs, nsegs, bodies, gos = self._chain_args([chain])
        self.chain = chain
        self._built(self._lib.chain_graph_build(
            segs, len(chain.segments), bodies, gos, cuda.ptr(self.runs), ctypes.byref(self._graph),
            ctypes.byref(self._exec)))
