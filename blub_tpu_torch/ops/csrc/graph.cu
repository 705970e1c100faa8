// The frame graph whose substep count is decided on the card: the
// counterpart of the JAX frame's traced n_sub and fori_loop
// (blub_tpu/sim/step_dense.py:454-494, frame_dense_fn), which is XLA control
// flow, not a Pallas kernel. sim/step_dense.FrameGraphs captures, with
// PyTorch's stream capture, a head graph (the count, written to a device
// int32) and one graph per n = 1 .. maxn (n substeps at dt / n). This file
// composes them: the head as a child graph, a one-thread kernel that sets
// one conditional handle per n (1 where the count is n, else 0), then one
// IF node per n, chained, whose body is branch n as a child graph. One
// launch of the instantiated graph runs one frame, and the host reads
// nothing. Conditional nodes need CUDA 12.4 or later in the runtime and the
// driver; each call returns the CUDA error for the caller to raise.
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

#define TRY(x)                         \
  do {                                 \
    const cudaError_t e_ = (x);        \
    if (e_ != cudaSuccess) {           \
      cudaGraphDestroy(g);             \
      return static_cast<int>(e_);     \
    }                                  \
  } while (0)

// head, branches[0 .. maxn): captured graphs (cloned into the frame graph);
// n_sub: the device int32 the head writes. -> the frame graph and its
// instantiation.
BLUB_EXPORT int frame_graph_build(cudaGraph_t head, const cudaGraph_t* branches, int maxn, const int* n_sub,
                                  cudaGraph_t* graph_out, cudaGraphExec_t* exec_out) {
  if (maxn < 1 || maxn > MAX_BRANCHES) return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t g = nullptr;
  {
    const cudaError_t e = cudaGraphCreate(&g, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaGraphNode_t prev;
  TRY(cudaGraphAddChildGraphNode(&prev, g, nullptr, 0, head));
  Handles hs{};
  for (int k = 0; k < maxn; ++k) TRY(cudaGraphConditionalHandleCreate(&hs.h[k], g, 0u, cudaGraphCondAssignDefault));
  void* args[] = {&hs, &maxn, &n_sub};
  cudaKernelNodeParams kp{};
  kp.func = reinterpret_cast<void*>(set_branches_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t set;
  TRY(cudaGraphAddKernelNode(&set, g, &prev, 1, &kp));
  prev = set;
  for (int k = 0; k < maxn; ++k) {
    cudaGraphNodeParams p{};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = hs.h[k];
    p.conditional.type = cudaGraphCondTypeIf;
    p.conditional.size = 1;
    cudaGraphNode_t cond, child;
    TRY(cudaGraphAddNode(&cond, g, &prev, 1, &p));
    TRY(cudaGraphAddChildGraphNode(&child, p.conditional.phGraph_out[0], nullptr, 0, branches[k]));
    prev = cond;
  }
  TRY(cudaGraphInstantiate(exec_out, g, 0));
  *graph_out = g;
  return 0;
}

BLUB_EXPORT int frame_graph_launch(cudaGraphExec_t exec, cudaStream_t st) {
  return static_cast<int>(cudaGraphLaunch(exec, st));
}

BLUB_EXPORT int frame_graph_destroy(cudaGraph_t g, cudaGraphExec_t exec) {
  const cudaError_t a = exec ? cudaGraphExecDestroy(exec) : cudaSuccess;
  const cudaError_t b = g ? cudaGraphDestroy(g) : cudaSuccess;
  return static_cast<int>(a != cudaSuccess ? a : b);
}

// Nodes of graph g by kind, child graphs descended into (their own node not
// counted): counts[0] kernels, [1] memcpy, [2] memset, [3] any other.
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
