// Graphs composed on the card from PyTorch captures: the counterpart of the
// JAX frame's traced n_sub and fori_loop (blub_tpu/sim/step_dense.py:454-494,
// frame_dense_fn) and of the while_loop of its XLA PCG solver
// (blub_tpu/sim/pressure.py:147-175), which the mesh's frame runs with its
// collectives inside (blub_tpu/parallel/sharded_sm.py:555-560): XLA control
// flow, not Pallas kernels. sim/step_dense.FrameGraphs captures, with
// PyTorch's stream capture, a head graph (the count, written to a device
// int32) and, per n = 1 .. maxn, n substeps at dt / n as a chain: segments
// of captured work and, between them, loop bodies (the mesh's PCG
// iterations; ops/graph.Chain). This file composes them:
//
//   chain   segment 0, a one-thread kernel that sets a WHILE handle from the
//           loop's device int32 go, a WHILE node whose body is the loop's
//           captured body (a child graph) and that kernel again (which also
//           counts the run), segment 1, and so on; a chain without loops is
//           its one segment as a child graph;
//   frame   the head as a child graph, a one-thread kernel that sets one IF
//           handle per n (1 where the count is n, else 0), then one IF node
//           per n, chained, whose body is branch n's chain.
//
// One launch of the instantiated graph runs one frame (or one chain), and
// the host reads nothing. Conditional nodes need CUDA 12.4 or later in the
// runtime and the driver; a WHILE node inside an IF body is a nested
// conditional, whose handle belongs to that body graph. Each call returns
// the CUDA error for the caller to raise.
#include "common.cuh"

#define MAX_BRANCHES 8

struct Handles {
  cudaGraphConditionalHandle h[MAX_BRANCHES];
};

// handle k (branch n = k + 1) opens where *n_sub == k + 1
__global__ void set_branches_kernel(Handles hs, int maxn, const int* n_sub) {
  const int n = *n_sub;
  for (int k = 0; k < maxn; ++k) cudaGraphSetConditional(hs.h[k], n == k + 1 ? 1u : 0u);
}

// the WHILE handle from the loop's predicate; in the body also one more run
__global__ void set_loop_kernel(cudaGraphConditionalHandle h, const int* go, int* runs) {
  if (runs) ++*runs;
  cudaGraphSetConditional(h, *go ? 1u : 0u);
}

#define TRY(x)                                   \
  do {                                           \
    const cudaError_t e_ = (x);                  \
    if (e_ != cudaSuccess) return e_;            \
  } while (0)

static cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* dep, void* func,
                              void** args) {
  cudaKernelNodeParams kp{};
  kp.func = func;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(node, g, dep, dep ? 1 : 0, &kp);
}

static cudaError_t add_loop_kernel(cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* dep,
                                   cudaGraphConditionalHandle h, const int* go, int* runs) {
  void* args[] = {&h, &go, &runs};
  return add_kernel(node, g, dep, reinterpret_cast<void*>(set_loop_kernel), args);
}

// segs[0 .. nseg), bodies[0 .. nseg - 1) with their go words and run
// counters, appended to g (which holds nothing yet) as a chain
static cudaError_t add_chain(cudaGraph_t g, const cudaGraph_t* segs, int nseg, const cudaGraph_t* bodies,
                             const int* const* gos, int* runs) {
  cudaGraphNode_t prev;
  TRY(cudaGraphAddChildGraphNode(&prev, g, nullptr, 0, segs[0]));
  for (int j = 1; j < nseg; ++j) {
    cudaGraphConditionalHandle h;
    TRY(cudaGraphConditionalHandleCreate(&h, g, 0u, 0u));
    cudaGraphNode_t set;
    TRY(add_loop_kernel(&set, g, &prev, h, gos[j - 1], nullptr));
    cudaGraphNodeParams p{};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = h;
    p.conditional.type = cudaGraphCondTypeWhile;
    p.conditional.size = 1;
    cudaGraphNode_t loop, body, again, seg;
    TRY(cudaGraphAddNode(&loop, g, &set, 1, &p));
    const cudaGraph_t bg = p.conditional.phGraph_out[0];
    TRY(cudaGraphAddChildGraphNode(&body, bg, nullptr, 0, bodies[j - 1]));
    TRY(add_loop_kernel(&again, bg, &body, h, gos[j - 1], runs + (j - 1)));
    TRY(cudaGraphAddChildGraphNode(&seg, g, &loop, 1, segs[j]));
    prev = seg;
  }
  return cudaSuccess;
}

static int finish(cudaError_t e, cudaGraph_t g, cudaGraph_t* graph_out, cudaGraphExec_t* exec_out) {
  if (e == cudaSuccess) e = cudaGraphInstantiate(exec_out, g, 0);
  if (e != cudaSuccess) {
    cudaGraphDestroy(g);
    return static_cast<int>(e);
  }
  *graph_out = g;
  return 0;
}

static cudaError_t add_frame(cudaGraph_t g, cudaGraph_t head, int maxn, const int* n_sub, const cudaGraph_t* segs,
                             const int* nsegs, const cudaGraph_t* bodies, const int* const* gos, int* runs) {
  cudaGraphNode_t prev;
  TRY(cudaGraphAddChildGraphNode(&prev, g, nullptr, 0, head));
  Handles hs{};
  for (int k = 0; k < maxn; ++k) TRY(cudaGraphConditionalHandleCreate(&hs.h[k], g, 0u, cudaGraphCondAssignDefault));
  void* args[] = {&hs, &maxn, &n_sub};
  cudaGraphNode_t set;
  TRY(add_kernel(&set, g, &prev, reinterpret_cast<void*>(set_branches_kernel), args));
  prev = set;
  int seg = 0, loop = 0;
  for (int k = 0; k < maxn; ++k) {
    if (nsegs[k] < 1) return cudaErrorInvalidValue;
    cudaGraphNodeParams p{};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = hs.h[k];
    p.conditional.type = cudaGraphCondTypeIf;
    p.conditional.size = 1;
    cudaGraphNode_t cond;
    TRY(cudaGraphAddNode(&cond, g, &prev, 1, &p));
    TRY(add_chain(p.conditional.phGraph_out[0], segs + seg, nsegs[k], bodies + loop, gos + loop, runs + loop));
    seg += nsegs[k];
    loop += nsegs[k] - 1;
    prev = cond;
  }
  return cudaSuccess;
}

// head; branch k (n = k + 1) is the chain of nsegs[k] segments from segs
// (consecutive over the branches) and nsegs[k] - 1 loops from bodies, gos
// and runs (consecutive too); n_sub: the device int32 the head writes. ->
// the frame graph and its instantiation.
BLUB_EXPORT int frame_graph_build(cudaGraph_t head, int maxn, const int* n_sub, const cudaGraph_t* segs,
                                  const int* nsegs, const cudaGraph_t* bodies, const int* const* gos, int* runs,
                                  cudaGraph_t* graph_out, cudaGraphExec_t* exec_out) {
  if (maxn < 1 || maxn > MAX_BRANCHES) return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t g = nullptr;
  const cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  return finish(add_frame(g, head, maxn, n_sub, segs, nsegs, bodies, gos, runs), g, graph_out, exec_out);
}

// one chain (nseg segments, nseg - 1 loops) as a graph of its own
BLUB_EXPORT int chain_graph_build(const cudaGraph_t* segs, int nseg, const cudaGraph_t* bodies, const int* const* gos,
                                  int* runs, cudaGraph_t* graph_out, cudaGraphExec_t* exec_out) {
  if (nseg < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t g = nullptr;
  const cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  return finish(add_chain(g, segs, nseg, bodies, gos, runs), g, graph_out, exec_out);
}

BLUB_EXPORT int graph_launch(cudaGraphExec_t exec, cudaStream_t st) {
  return static_cast<int>(cudaGraphLaunch(exec, st));
}

BLUB_EXPORT int graph_destroy(cudaGraph_t g, cudaGraphExec_t exec) {
  const cudaError_t a = exec ? cudaGraphExecDestroy(exec) : cudaSuccess;
  const cudaError_t b = g ? cudaGraphDestroy(g) : cudaSuccess;
  return static_cast<int>(a != cudaSuccess ? a : b);
}

// Nodes of graph g by kind, child graphs descended into (their own node not
// counted): counts[0] kernels, [1] memcpy, [2] memset, [3] any other
// (conditional nodes, event nodes, host nodes).
BLUB_EXPORT int graph_count_nodes(cudaGraph_t g, int* counts) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess || n == 0) return static_cast<int>(e);
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  e = cudaGraphGetNodes(g, nodes, &n);
  for (size_t i = 0; i < n && e == cudaSuccess; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e != cudaSuccess) break;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (e == cudaSuccess) e = static_cast<cudaError_t>(graph_count_nodes(child, counts));
    } else {
      counts[t == cudaGraphNodeTypeKernel ? 0 : t == cudaGraphNodeTypeMemcpy ? 1 : t == cudaGraphNodeTypeMemset ? 2 : 3]++;
    }
  }
  delete[] nodes;
  return static_cast<int>(e);
}

// The CUDA runtime this library was built with and the driver's version
// (e.g. 12080 for 12.8).
BLUB_EXPORT int cuda_versions(int* runtime, int* driver) {
  const cudaError_t e = cudaRuntimeGetVersion(runtime);
  return static_cast<int>(e != cudaSuccess ? e : cudaDriverGetVersion(driver));
}
