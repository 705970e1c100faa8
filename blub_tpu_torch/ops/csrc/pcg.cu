// PCG pressure solve for Hopper: one cooperative persistent kernel per solve.
// Replaces the TPU kernels blub_tpu/ops/pallas_pcg.py::_kernel (def :68,
// pallas_call :180; the whole while-loop held in VMEM) and
// blub_tpu/ops/pallas_pcg_blocked.py::_k1_kernel (:152 / :237) and _k2_kernel
// (:178 / :267), which compute the same solve.
//
// pcg_solve_kernel runs the whole solve in one launch; grid-wide barriers
// separate the phases:
//
//   setup  diag = non-solid neighbour count; dfl = dsafe at fluid cells, 0
//          elsewhere (dfl > 0 is the fluid mask); s0 = As = 0   | barrier
//   init   p0 = F p_init; r0 = F (rhs - A p0)                   | barrier
//   z0     z0 = K K^T r0: the k2 body with alpha = 0; sums      | barrier
//   loop   k1  s = z + beta s_old; As = A s; sums of s.As       | barrier
//              alpha = sigma / (s.As +- 1e-10)
//          k2  p += alpha s; r = r_old - alpha As; z = K K^T r (Incomplete
//              Poisson, recomputing r and t = K^T r at the stencil's
//              neighbours); sums of z.r, max|r|                 | barrier
//              sigma' = z.r; beta = sigma' / (sigma +- 1e-10); err = max|r|;
//              stop if (i % freq == 0 or i == max_iter - 1) and err < tol
//
// s and r are double-buffered: both passes read the previous vector at the
// neighbours. Every PCG vector is fluid-masked and the border ring is SOLID
// (the marker of sim/sm_phases.marker_from_counts), so neighbour reads need
// no fluid mask: a non-fluid neighbour holds exactly 0. Out-of-domain reads
// are 0. The iteration count, the scalars [sigma, alpha, beta, err] and the
// pressure stay on the device: the host reads nothing during a solve.
//
// Reductions: the sums keep the order of the pass kernels, whatever the
// block count. Chunk c is the 256 cells of pass-kernel block c. A block walks
// its chunks and writes each chunk's partial in block_reduce's order
// (chunk_sums); after the barrier EVERY block sums all chunk partials in the
// order of the pass kernels' one block of RTHREADS threads (ordered_reduce).
// So the scalars do not depend on the block count, the SM count or the
// registers, every block computes the same bits, and a solve gives the bits
// of the pass kernels run one launch at a time. max|r| does not depend on the
// grouping: one partial per block. No float atomics: every block takes the
// same branch of the stopping rule. That is what keeps the barrier safe: a
// block that left the loop one iteration early would leave the others
// waiting at a barrier forever. The price: every block reads every chunk
// partial, 8 KB per sum at the dam shape and 64 KB at highres.
//
// Barrier: cooperative_groups::this_grid().sync(), which builds without -rdc
// and needs the cooperative launch (cudaLaunchCooperativeKernel), which also
// guarantees that every block is resident. Vectors written in one phase and
// read at the neighbours in the next are read with plain loads, never through
// the read-only cache (no const __restrict__ on them in this kernel): the
// barrier orders plain loads and stores across the grid, the read-only cache
// is not kept coherent within a kernel.
//
// What bounds it on the card: at the dam shape (128x64x64) a grid is 2 MB and
// the ten grids of a solve stay in the 50 MB L2; the least a solve must move
// is rhs, the warm start and the marker in and the pressure out (7 MB, 0.002
// ms) and its arithmetic is ~30 operations per fluid cell and iteration, so
// the floor is the barrier latency (two per iteration) plus the passes' L2
// time. At highres (256x128x128) a grid is 16.8 MB and the passes stream from
// HBM: bounds k1 0.0300 ms and k2 0.0401 ms per iteration. What the design
// does about it: one launch per solve, so an iteration costs no launch and no
// host Python, and the host never reads err, so the stream never drains
// inside a substep; two barriers per iteration, because every block sums
// the partials itself instead of one block reducing and broadcasting; no
// block barrier between the chunks of a pass (warps run ahead). Blocks walk
// the chunks and threads the cells grid-stride; pcg_solve_blocks sets the
// block count (512 at the dam shape, 792 at highres on an H100).
//
// History: pcg_solve_kernel<true> also writes err, the max|r| it reduces at
// every iteration anyway, to history[it] from block 0: the per-iteration
// record of ops/pallas_pcg.py::_kernel with with_history=True (:122, :141,
// :161, its (16, 128) stats output at :186) and of the history carry of
// ops/pallas_pcg_blocked.py::solve_pressure_blocked (:396), with no cap on
// the iteration count (the TPU's history tile held 1024). One 4-byte store per
// iteration beside two grid barriers; the production instantiation <false>
// compiles to the code it had before the flag.
//
// The pass kernels (setup_kernel, init_kernel, k1_kernel, k2_kernel and
// tail_kernel, below) compute the same cells in the same arithmetic and sum
// in the same order one launch at a time, on shared-memory tiles; the probe
// blub_tpu_torch/probes/pcg_passes.py times them alone, and the mesh
// (parallel/sharded_sm.py) runs their x-slab instantiation (H = 1), three
// launches an iteration with the halo exchanges and all-reduces between
// them; the tail also computes the loop predicate on the device, which a
// CUDA WHILE node reads (ops/csrc/graph.cu).
#include <cooperative_groups.h>

#include <initializer_list>

#include "common.cuh"

namespace cg = cooperative_groups;

#define SIGMA 0
#define ALPHA 1
#define BETA 2
#define ERR 3
#define EPS 1e-10f

#define THREADS 256
#define RTHREADS 1024  // threads of the one-block sum whose order ordered_reduce keeps
#define RED_SLOTS 33   // shared floats of ordered_reduce: 32 warp values + the result
#define WARPS (THREADS / 32)
#define CHUNK_BATCH 32  // chunks a block folds at once in chunk_sums
#define MIN_BLOCKS 6    // blocks per SM the persistent solve must fit (<= 40 registers)
#define MIN_CHUNKS 4    // chunks per block and pass at least (pcg_solve_blocks)

struct Grid {
  int X, Y, Z;
  __device__ int n() const { return X * Y * Z; }
};

// Every cell body takes a grid with H halo planes on each side along x
// ([X + 2H, Y, Z]; cell i of the X planes between is element i + H Y Z):
// H = 0 for the whole grid (the persistent solve, the probes' passes), H = 1
// for the mesh's x slab, whose halo planes hold the x neighbours' planes, or
// zeros at the domain's ends. H = 0 compiles to the whole-grid code.
template <int H>
__device__ __forceinline__ int ext_index(Grid g, int i) {
  return i + H * g.Y * g.Z;
}

// value of v at cell (x,y,z) + offset, -H <= x < X + H; 0 beyond
template <int H = 0>
__device__ __forceinline__ float at(const float* v, Grid g, int x, int y, int z) {
  if (x < -H || x >= g.X + H || y < 0 || y >= g.Y || z < 0 || z >= g.Z) return 0.f;
  return v[((x + H) * g.Y + y) * g.Z + z];
}

__device__ __forceinline__ float guarded_div(float num, float den) {
  return num / (den + (den < 0.f ? -EPS : EPS));
}

// ---------------------------------------------------------------------------
// cell bodies: the one copy of the stencil, used by the persistent kernel and
// by the pass kernels

template <int H = 0>
__device__ __forceinline__ void setup_cell(const int8_t* marker, float* diag, float* dfl, Grid g, int i) {
  const int z = i % g.Z, y = (i / g.Z) % g.Y, x = i / (g.Y * g.Z);
  const int e = ext_index<H>(g, i);
  const int dx[3] = {1, 0, 0}, dy[3] = {0, 1, 0}, dz[3] = {0, 0, 1};
  float d = 0.f;
  for (int a = 0; a < 3; ++a) {
    const int xp = x + dx[a], yp = y + dy[a], zp = z + dz[a];
    const int xn = x - dx[a], yn = y - dy[a], zn = z - dz[a];
    const bool ip = xp < g.X + H && yp < g.Y && zp < g.Z;
    const bool in = xn >= -H && yn >= 0 && zn >= 0;
    const float mp = ip ? fabsf((float)marker[((xp + H) * g.Y + yp) * g.Z + zp]) : 0.f;
    const float mn = in ? fabsf((float)marker[((xn + H) * g.Y + yn) * g.Z + zn]) : 0.f;
    d = d + mp + mn;
  }
  diag[e] = d;
  dfl[e] = marker[e] == CELL_FLUID ? (d > 0.f ? d : 1.f) : 0.f;
}

// r0 = F (rhs - A p0) with p0 = F p_init; A reads p0 at the 6 neighbours
template <int H = 0>
__device__ __forceinline__ void init_cell(const float* pinit, const float* rhs, const float* diag,
                                          const float* dfl, float* p, float* r, Grid g, int i) {
  const int z = i % g.Z, y = (i / g.Z) % g.Y, x = i / (g.Y * g.Z);
  const int e = ext_index<H>(g, i);
  const bool fluid = dfl[e] > 0.f;
  const float p0 = fluid ? pinit[e] : 0.f;
  float acc = diag[e] * p0;
  const int dx[3] = {1, 0, 0}, dy[3] = {0, 1, 0}, dz[3] = {0, 0, 1};
  for (int a = 0; a < 3; ++a) {
    const int xs[2] = {x + dx[a], x - dx[a]}, ys[2] = {y + dy[a], y - dy[a]}, zs[2] = {z + dz[a], z - dz[a]};
    for (int h = 0; h < 2; ++h) {
      const float f = at<H>(dfl, g, xs[h], ys[h], zs[h]);
      acc = acc - (f > 0.f ? at<H>(pinit, g, xs[h], ys[h], zs[h]) : 0.f);
    }
  }
  p[e] = p0;
  r[e] = fluid ? rhs[e] - (fluid ? acc : 0.f) : 0.f;
}

// s = z + beta s_old; As = A s (fluid cells); -> s.As at the cell
template <int H = 0>
__device__ __forceinline__ float k1_cell(const float* z_, const float* s_old, float beta, const float* diag,
                                         const float* dfl, float* s_new, float* As, Grid g, int i) {
  const int z = i % g.Z, y = (i / g.Z) % g.Y, x = i / (g.Y * g.Z);
  const int e = ext_index<H>(g, i);
  const float si = z_[e] + beta * s_old[e];
  float acc = diag[e] * si;
  const int dx[3] = {1, 0, 0}, dy[3] = {0, 1, 0}, dz[3] = {0, 0, 1};
  for (int a = 0; a < 3; ++a) {
    const int xs[2] = {x + dx[a], x - dx[a]}, ys[2] = {y + dy[a], y - dy[a]}, zs[2] = {z + dz[a], z - dz[a]};
    for (int h = 0; h < 2; ++h)
      acc = acc - (at<H>(z_, g, xs[h], ys[h], zs[h]) + beta * at<H>(s_old, g, xs[h], ys[h], zs[h]));
  }
  const float as = dfl[e] > 0.f ? acc : 0.f;
  s_new[e] = si;
  As[e] = as;
  return si * as;
}

// r after the update at cell (x,y,z); 0 beyond the grid and its halo
template <int H = 0>
__device__ __forceinline__ float r_at(const float* r_old, const float* As, float alpha, Grid g, int x, int y,
                                      int z) {
  if (x < -H || x >= g.X + H || y < 0 || y >= g.Y || z < 0 || z >= g.Z) return 0.f;
  const int j = ((x + H) * g.Y + y) * g.Z + z;
  return r_old[j] - alpha * As[j];
}

// t = K^T r at (x,y,z): r + (sum of upper neighbours' r) / dsafe, 0 off fluid
template <int H = 0>
__device__ __forceinline__ float t_at(const float* r_old, const float* As, const float* dfl, float alpha, Grid g,
                                      int x, int y, int z) {
  if (x < -H || x >= g.X + H || y < 0 || y >= g.Y || z < 0 || z >= g.Z) return 0.f;
  const float d = dfl[((x + H) * g.Y + y) * g.Z + z];
  if (!(d > 0.f)) return 0.f;
  float up = 0.f;
  up = up + r_at<H>(r_old, As, alpha, g, x + 1, y, z);
  up = up + r_at<H>(r_old, As, alpha, g, x, y + 1, z);
  up = up + r_at<H>(r_old, As, alpha, g, x, y, z + 1);
  return r_at<H>(r_old, As, alpha, g, x, y, z) + up / d;
}

// p += alpha s; r = r_old - alpha As; z = K K^T r; -> (z.r, |r|) at the cell
template <int H = 0>
__device__ __forceinline__ void k2_cell(float* p, const float* r_old, const float* s, const float* As, float alpha,
                                        const float* dfl, float* r_new, float* z_out, Grid g, int i, float& zr,
                                        float& rabs) {
  const int z = i % g.Z, y = (i / g.Z) % g.Y, x = i / (g.Y * g.Z);
  const int e = ext_index<H>(g, i);
  p[e] = p[e] + alpha * s[e];
  const float ri = r_old[e] - alpha * As[e];
  const float d = dfl[e];
  float zi = 0.f;
  if (d > 0.f) {
    const float t = t_at<H>(r_old, As, dfl, alpha, g, x, y, z);
    float lo = 0.f;
    lo = lo + t_at<H>(r_old, As, dfl, alpha, g, x - 1, y, z) / fmaxf(at<H>(dfl, g, x - 1, y, z), 1.f);
    lo = lo + t_at<H>(r_old, As, dfl, alpha, g, x, y - 1, z) / fmaxf(at<H>(dfl, g, x, y - 1, z), 1.f);
    lo = lo + t_at<H>(r_old, As, dfl, alpha, g, x, y, z - 1) / fmaxf(at<H>(dfl, g, x, y, z - 1), 1.f);
    zi = t + lo;
  }
  r_new[e] = ri;
  z_out[e] = zi;
  zr = zi * ri;
  rabs = fabsf(ri);
}

// The chunk partials of one pass of the persistent solve. Chunk c is the
// THREADS cells of pass-kernel block c; this block walks chunks blockIdx.x +
// k gridDim.x, CHUNK_BATCH at a time: each warp folds its 32 terms of a chunk
// (warp_reduce) and runs on to its next chunk with no block barrier; then the
// block folds each chunk's WARPS values (fold_warps) into partial[c], the
// order of block_reduce over the chunk. term(i) is cell i's term and does the
// cell's work.
template <typename Term>
__device__ __forceinline__ void chunk_sums(int n, float* partial, float* wsum, Term term) {
  const int nchunks = (n + THREADS - 1) / THREADS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = blockIdx.x; base < nchunks; base += CHUNK_BATCH * gridDim.x) {
    for (int k = 0; k < CHUNK_BATCH; ++k) {
      const int c = base + k * gridDim.x;
      if (c >= nchunks) break;
      const int i = c * THREADS + threadIdx.x;
      const float v = warp_reduce(i < n ? term(i) : 0.f, AddOp());
      if (lane == 0) wsum[k * WARPS + warp] = v;
    }
    __syncthreads();
    for (int k = warp; k < CHUNK_BATCH; k += WARPS) {
      const int c = base + k * gridDim.x;
      if (c >= nchunks) break;
      const float v = fold_warps(wsum + k * WARPS, WARPS, AddOp());
      if (lane == 0) partial[c] = v;
    }
    __syncthreads();
  }
}

// The sum (or max) of partial[0, nparts) in one fixed order, whatever the
// block size (THREADS, 2 THREADS or RTHREADS): that of block_reduce in a block
// of RTHREADS threads, thread v of which first folds partial[v], partial[v +
// RTHREADS], ... in turn. Each warp plays the virtual warps warp, warp + nw,
// ... and loads ROUNDS rounds of all of them at once (the loads do not wait
// on the sums); warp 0 folds the 32 warp values. Returned to every thread.
// Plain loads: after a grid barrier they see the other blocks' partials.
template <typename Op>
__device__ __forceinline__ float ordered_reduce(const float* partial, int nparts, Op op, float* smem) {
  constexpr int KMAX = RTHREADS / THREADS, VWARPS = RTHREADS / 32, ROUNDS = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  float acc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) acc[k] = 0.f;
  for (int m = 0; m * RTHREADS < nparts; m += ROUNDS) {
    float x[KMAX][ROUNDS];
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
#pragma unroll
      for (int u = 0; u < ROUNDS; ++u) {
        const int vw = warp + k * nw, j = vw * 32 + lane + (m + u) * RTHREADS;
        x[k][u] = vw < VWARPS && j < nparts ? partial[j] : 0.f;
      }
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
#pragma unroll
      for (int u = 0; u < ROUNDS; ++u) {
        const int vw = warp + k * nw, j = vw * 32 + lane + (m + u) * RTHREADS;
        if (vw < VWARPS && j < nparts) acc[k] = op(acc[k], x[k][u]);
      }
  }
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int vw = warp + k * nw;
    if (vw < VWARPS) {  // the same in the whole warp
      const float v = warp_reduce(acc[k], op);
      if (lane == 0) smem[vw] = v;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const float v = fold_warps(smem, VWARPS, op);
    if (lane == 0) smem[VWARPS] = v;
  }
  __syncthreads();
  return smem[VWARPS];
}

// ordered_reduce in two halves, for the pass kernels: ordered_loads issues
// the loads of its first rounds early, to overlap other work (the copies of
// k2's first tile, the tail's second sum), and ordered_reduce_from sums them
// (and any later rounds) in ordered_reduce's order. pcg_solve_kernel keeps
// the one-piece ordered_reduce, whose code PR 4 tuned.
#define OR_KMAX (RTHREADS / THREADS)  // virtual warps a warp plays at most
#define OR_ROUNDS 4                   // rounds of RTHREADS partials loaded at once

__device__ __forceinline__ void ordered_loads(const float* partial, int nparts, int m,
                                              float (&x)[OR_KMAX][OR_ROUNDS]) {
  constexpr int VWARPS = RTHREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < OR_KMAX; ++k)
#pragma unroll
    for (int u = 0; u < OR_ROUNDS; ++u) {
      const int vw = warp + k * nw, j = vw * 32 + lane + (m + u) * RTHREADS;
      x[k][u] = vw < VWARPS && j < nparts ? partial[j] : 0.f;
    }
}

template <typename Op>
__device__ __forceinline__ float ordered_reduce_from(const float* partial, int nparts, Op op, float* smem,
                                                     float (&x)[OR_KMAX][OR_ROUNDS]) {
  constexpr int VWARPS = RTHREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  float acc[OR_KMAX];
#pragma unroll
  for (int k = 0; k < OR_KMAX; ++k) acc[k] = 0.f;
  for (int m = 0; m * RTHREADS < nparts; m += OR_ROUNDS) {
    if (m > 0) ordered_loads(partial, nparts, m, x);
#pragma unroll
    for (int k = 0; k < OR_KMAX; ++k)
#pragma unroll
      for (int u = 0; u < OR_ROUNDS; ++u) {
        const int vw = warp + k * nw, j = vw * 32 + lane + (m + u) * RTHREADS;
        if (vw < VWARPS && j < nparts) acc[k] = op(acc[k], x[k][u]);
      }
  }
#pragma unroll
  for (int k = 0; k < OR_KMAX; ++k) {
    const int vw = warp + k * nw;
    if (vw < VWARPS) {  // the same in the whole warp
      const float v = warp_reduce(acc[k], op);
      if (lane == 0) smem[vw] = v;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const float v = fold_warps(smem, VWARPS, op);
    if (lane == 0) smem[VWARPS] = v;
  }
  __syncthreads();
  return smem[VWARPS];
}

// ---------------------------------------------------------------------------
// the persistent solve

struct Scratch {  // shared memory of a block of the persistent solve
  float red[RED_SLOTS];
  float wsum[CHUNK_BATCH * WARPS];
};

// k1 over this block's chunks: s_new, As and the chunk partials of s.As
__device__ __forceinline__ void k1_phase(const float* z_, const float* s_old, float beta, const float* diag,
                                         const float* dfl, float* s_new, float* As, float* partial, Grid g,
                                         Scratch& sh) {
  chunk_sums(g.n(), partial, sh.wsum, [&](int i) { return k1_cell(z_, s_old, beta, diag, dfl, s_new, As, g, i); });
}

// k2 over this block's chunks: p, r_new, z and the chunk partials of z.r.
// -> the block's max|r| (valid in thread 0; a max does not depend on the
// grouping, so it takes one partial per block)
__device__ __forceinline__ float k2_phase(float* p, const float* r_old, const float* s, const float* As, float alpha,
                                          const float* dfl, float* r_new, float* z_out, float* partial, Grid g,
                                          Scratch& sh) {
  float rmax = 0.f;
  chunk_sums(g.n(), partial, sh.wsum, [&](int i) {
    float zr, rabs;
    k2_cell(p, r_old, s, As, alpha, dfl, r_new, z_out, g, i, zr, rabs);
    rmax = fmaxf(rmax, rabs);
    return zr;
  });
  return block_reduce(rmax, MaxOp(), sh.red);
}

struct SolveArgs {
  const int8_t* marker;
  const float* pinit;
  const float* rhs;
  float* p;
  // scratch grids, written and read within the launch (no __restrict__)
  float *diag, *dfl, *z, *As, *r0, *r1, *s0, *s1;
  float *part_sAs, *part_zr;            // one partial per chunk
  float* part_max;                       // one per block
  float* scal;                           // out: [sigma, alpha, beta, err]
  int* iters;                            // out: iterations run
  float* history;                        // out (HISTORY): max|r| of each iteration run
  float tol;
  int max_iter, freq;
  Grid g;
};

// MIN_BLOCKS blocks per SM: 792 on an H100
template <bool HISTORY>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) pcg_solve_kernel(SolveArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Scratch sh;
  const Grid g = a.g;
  const int n = g.n();
  const int nchunks = (n + THREADS - 1) / THREADS;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;

  for (int i = first; i < n; i += stride) {
    setup_cell(a.marker, a.diag, a.dfl, g, i);
    a.s0[i] = 0.f;  // the first direction is z0 (beta = 0 times a finite s)
    a.As[i] = 0.f;  // the z0 pass subtracts 0 * As
  }
  grid.sync();  // init reads dfl at the neighbours
  for (int i = first; i < n; i += stride) init_cell(a.pinit, a.rhs, a.diag, a.dfl, a.p, a.r0, g, i);
  grid.sync();  // z0 reads r0 at the neighbours

  // z0 = K K^T r0 and sigma0 = z0.r0: the k2 body with alpha = 0 (p and r0
  // pass through unchanged; r1 = r0)
  float rmax = k2_phase(a.p, a.r0, a.s0, a.As, 0.f, a.dfl, a.r1, a.z, a.part_zr, g, sh);
  if (threadIdx.x == 0) a.part_max[blockIdx.x] = rmax;
  grid.sync();
  float sigma = ordered_reduce(a.part_zr, nchunks, AddOp(), sh.red);
  float err = ordered_reduce(a.part_max, gridDim.x, MaxOp(), sh.red);
  float alpha = 0.f, beta = 0.f;

  float *r_old = a.r1, *r_new = a.r0, *s_old = a.s0, *s_new = a.s1;
  const int freq = a.freq > 1 ? a.freq : 1;
  int it = 0;
  // it, err and every scalar are the same in every block, so every block
  // runs the same iterations and meets every barrier
  while (it < a.max_iter) {
    k1_phase(a.z, s_old, beta, a.diag, a.dfl, s_new, a.As, a.part_sAs, g, sh);
    grid.sync();  // k2 reads As at the neighbours; every block reads the s.As partials
    alpha = guarded_div(sigma, ordered_reduce(a.part_sAs, nchunks, AddOp(), sh.red));

    rmax = k2_phase(a.p, r_old, s_new, a.As, alpha, a.dfl, r_new, a.z, a.part_zr, g, sh);
    if (threadIdx.x == 0) a.part_max[blockIdx.x] = rmax;
    grid.sync();  // the next k1 reads z at the neighbours; every block reads the partials
    const float sigma_new = ordered_reduce(a.part_zr, nchunks, AddOp(), sh.red);
    err = ordered_reduce(a.part_max, gridDim.x, MaxOp(), sh.red);
    if (HISTORY && blockIdx.x == 0 && threadIdx.x == 0) a.history[it] = err;
    beta = guarded_div(sigma_new, sigma);
    sigma = sigma_new;

    const bool check = it % freq == 0 || it == a.max_iter - 1;
    ++it;
    float* t = r_old;
    r_old = r_new;
    r_new = t;
    t = s_old;
    s_old = s_new;
    s_new = t;
    if (check && err < a.tol) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.scal[SIGMA] = sigma;
    a.scal[ALPHA] = alpha;
    a.scal[BETA] = beta;
    a.scal[ERR] = err;
    *a.iters = it;
  }
}

static int chunks(int X, int Y, int Z) { return (X * Y * Z + THREADS - 1) / THREADS; }

// Blocks of the cooperative solve at X x Y x Z: as many as the card holds at
// once (occupancy x SMs), but no fewer than MIN_CHUNKS chunks per block. Below
// that the grid barrier, which costs more with more blocks, outweighs the
// latency the extra blocks hide (on an H100: 512 blocks at the dam shape, 792
// at highres). The count sets only which block walks which chunks, never the
// result.
// history != 0 sizes the history instantiation. Negative: minus the CUDA
// error (cudaErrorNotSupported if the card has no cooperative launch).
BLUB_EXPORT int pcg_solve_blocks(int X, int Y, int Z, int history) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = history ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_solve_kernel<true>, THREADS, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_solve_kernel<false>, THREADS, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int want = (chunks(X, Y, Z) + MIN_CHUNKS - 1) / MIN_CHUNKS;
  const int nb = per_sm * sms < want ? per_sm * sms : want;
  return nb >= 1 ? nb : -static_cast<int>(cudaErrorInvalidConfiguration);
}

// One solve on nblocks blocks (pcg_solve_blocks, or fewer).
// work: 8 grids of X*Y*Z floats (diag, dfl, z, As, r0, r1, s0, s1); partial:
// pcg_solve_partials floats. history: null (the production solve) or
// max_iter floats, of which the solve writes the iterations it runs.
BLUB_EXPORT int pcg_solve_launch(const int8_t* marker, const float* pinit, const float* rhs, float* p, float* work,
                                 float* partial, float* scal, int* iters, float* history, float tol, int max_iter,
                                 int freq, int nblocks, int X, int Y, int Z, cudaStream_t st) {
  if (nblocks < 1 || nblocks > chunks(X, Y, Z)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = (size_t)X * Y * Z;
  SolveArgs a;
  a.marker = marker;
  a.pinit = pinit;
  a.rhs = rhs;
  a.p = p;
  a.diag = work;
  a.dfl = work + n;
  a.z = work + 2 * n;
  a.As = work + 3 * n;
  a.r0 = work + 4 * n;
  a.r1 = work + 5 * n;
  a.s0 = work + 6 * n;
  a.s1 = work + 7 * n;
  const int nc = chunks(X, Y, Z);
  a.part_sAs = partial;
  a.part_zr = partial + nc;
  a.part_max = partial + 2 * nc;
  a.scal = scal;
  a.iters = iters;
  a.history = history;
  a.tol = tol;
  a.max_iter = max_iter;
  a.freq = freq;
  a.g = Grid{X, Y, Z};
  void* args[] = {&a};
  const void* kernel = history ? reinterpret_cast<const void*>(pcg_solve_kernel<true>)
                               : reinterpret_cast<const void*>(pcg_solve_kernel<false>);
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(nblocks), dim3(THREADS), args, 0, st);
  if (e != cudaSuccess) cudaGetLastError();  // clear it: the wrapper raises
  return static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// the passes one launch at a time: the probes' (probes/pcg_passes.py, H = 0)
// and the mesh's (parallel/sharded_sm.py, H = 1, on an x slab).
//
// A whole-grid kernel cannot exchange halos inside its loop, so the mesh runs
// an iteration as three launches with the exchanges and all-reduces between
// them (every grid [X+2, Y, Z], the slab's planes between two halo planes):
//
//   z's x halo from the neighbours
//   k1    s = z + beta s_old, also on the halo planes (so s_old's halo is
//         always held); As = A s; partials of s.As          | all-reduce
//   As's x halo from the neighbours
//   k2    alpha = sigma / (the ordered sum of the partials +- 1e-10), in
//         every block; p += alpha s; r = r_old - alpha As, also on the halo
//         planes; z = K K^T r; partials of z.r and max|r|   | all-reduce
//   tail  the ordered sums; beta, sigma, err; it += 1 and go, the loop
//         predicate that a CUDA WHILE node reads (ops/csrc/graph.cu)
//
// r and s are pairs of grids: the parity of the device iteration count it
// says which of a pair is the old one, so the same three launches serve every
// iteration of a WHILE node and nothing is copied. The solve starts with
// setup (then dfl's halo), init (p0, r0; then r0's halo) and a k2 with alpha
// = 0 and a tail without the predicate (z0, sigma0, beta = 0), as the
// persistent solve. The all-reduces add the ranks' partials chunk by chunk,
// so every rank sums the same values in the same order and holds the same
// scalars; at world size 1 (zero halos) the mesh's solve gives
// pcg_solve_kernel's bits.
//
// What held the passes back (PR 1's design): one thread per cell, every
// neighbour re-read through at() (k2's four t_at calls make ~40 bounds-checked
// loads a cell), the integer div/mod of (x, y, z) per cell, one partial per
// 256-cell block, two single-block kernels reducing them between the passes
// and a copy of r and s after them. What this design does: a tile is 2
// chunks, 512 cells contiguous in (x, y, z) order. For a tile a block stages
// with cp.async (16 bytes a copy when Y Z % 4 == 0) the windows of each grid
// read at the neighbours in the plane below, the tile's plane and the plane
// above (each window the tile's cells padded by P >= Z + 1 cells on both
// sides: the y and z neighbours, and k2's t at a lower neighbour reaches r
// one step beyond), and the tile's own cells of the grids read only there.
// It computes s (k1) or r (k2) once per staged cell in shared memory, k2
// also t = K^T r and u = t / max(dfl, 1) once per cell of a plane, and then
// each cell of the tile reads its neighbours there. When Y Z is a whole
// number of tiles and the card holds fewer blocks than tiles, a block
// marches up a column of tiles, one x plane at a time (plan_runs: 2 planes
// at the dam shape, 16 at highres): each plane's windows are staged once and
// serve the three tiles around them, k2 carries u of the plane below, and
// the next tile's windows and cells are in flight while a tile computes. A
// window cell outside the ext grid is staged as 0; a neighbour outside the
// grid (a y or z neighbour wraps into the next row in the flat order) is
// read as at() reads it. The cell arithmetic is k1_cell's, t_at's and
// k2_cell's term by term (the library builds with -fmad=false), so the
// passes keep their bits. (y, z) of a fluid cell come from a multiply-high
// division (FastDiv); off fluid k1 and k2 skip the stencil, as k1_cell's
// mask and k2_cell's branch make its result 0.
//
// What bounds them on an H100: at highres (256x128x128, 16.8 MB grids) the
// bytes from HBM; at the dam shape (2 MB grids, in L2) the launch and the
// latency of a block's dependent steps (the staged windows' round trip, the
// barriers between computing r, t and the cells), not bytes. PERF.md holds
// the times.
//
// The order of the sums is the spec: chunk c is cells [256 c, 256 c + 256);
// thread t holds cell 256 c + t and the partial is warp_reduce then
// fold_warps, as chunk_sums writes it. max|r| takes one partial per block.
// In k2 every block sums the all-reduced s.As partials itself in
// ordered_reduce's order, as pcg_solve_kernel does, while its first copies
// land: 8 KB a block at the dam shape, 64 KB at highres.

#define TILE_CHUNKS 2                 // chunks per tile of the pass kernels
#define TILE (TILE_CHUNKS * THREADS)  // cells per tile
#define PASS_MIN_BLOCKS 4             // blocks per SM that k1's and k2's registers allow (<= 64 each)

template <int H>
__global__ void setup_kernel(const int8_t* __restrict__ marker, float* __restrict__ diag,
                             float* __restrict__ dfl, Grid g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < g.n()) setup_cell<H>(marker, diag, dfl, g, i);
}

template <int H>
__global__ void init_kernel(const float* __restrict__ pinit, const float* __restrict__ rhs,
                            const float* __restrict__ diag, const float* __restrict__ dfl, float* __restrict__ p,
                            float* __restrict__ r, Grid g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < g.n()) init_cell<H>(pinit, rhs, diag, dfl, p, r, g, i);
}

// element j of the halo planes (j < 2 H Y Z) of an ext grid
template <int H>
__device__ __forceinline__ int halo_index(Grid g, int j) {
  const int hp = H * g.Y * g.Z;
  return j < hp ? j : j + g.X * g.Y * g.Z;
}

// n / d for 0 <= n < 2^31, d >= 1: a multiply-high and a shift by magic
// numbers made on the host (the method of CUTLASS's FastDivmod)
struct FastDiv {
  int d;
  unsigned mul, shr;
};

static FastDiv fast_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    unsigned l = 0;
    while ((1u << l) < static_cast<unsigned>(d)) ++l;  // ceil(log2 d)
    const unsigned p = 31 + l;
    f.mul = static_cast<unsigned>(((1ull << p) + static_cast<unsigned>(d) - 1) / static_cast<unsigned>(d));
    f.shr = p - 32;
  }
  return f;
}

__device__ __forceinline__ int fdiv(FastDiv f, int n) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), f.mul) >> f.shr);
}

struct Pass {
  Grid g;
  int yz, next, n;  // Y Z; cells of the ext grid [X + 2H, Y, Z]; cells of the X planes between
  int nchunks, ntiles;
  int vec;          // copies of 16 bytes: Y Z % 4 == 0 and every staged grid 16-byte aligned
  int P, W;         // a window's pad on each side (Z + 1, rounded up to 4 with vec) and its cells, TILE + 2 P
  int tpp, march;   // tiles per plane (Y Z % TILE == 0, else 0); planes a run of tiles marches (1: one tile)
  int nruns;        // runs of tiles
  FastDiv fz, fy;   // by Z, by Y
};

// Run k of tiles: its first tile and how many it walks. A march walks
// q.march tiles of one column, each one plane above the last (so each
// plane's windows are staged once and serve three tiles); else a run is
// one tile.
__device__ __forceinline__ void run_of(const Pass& q, int k, int& t0, int& len) {
  if (q.march > 1) {
    const int col = k % q.tpp, x0 = k / q.tpp * q.march;
    t0 = x0 * q.tpp + col;
    len = q.g.X - x0 < q.march ? q.g.X - x0 : q.march;
  } else {
    t0 = k;
    len = 1;
  }
}

// y and z of ext element f >= 0
__device__ __forceinline__ void yz_of(const Pass& q, int f, int& y, int& z) {
  const int row = fdiv(q.fz, f);
  z = f - row * q.g.Z;
  y = row - fdiv(q.fy, row) * q.g.Y;
}

// r and s: which grid of a pair is the old one, by the parity of *it (+ flip)
struct Pair {
  float* a;
  float* b;
  __device__ float* older(int par) const { return par ? b : a; }
  __device__ float* newer(int par) const { return par ? a : b; }
};

__device__ __forceinline__ int parity(const int* it, int flip) { return ((it ? *it : 0) + flip) & 1; }

// 4-byte cp.async of src[f] into shared dst; 0 for f outside [0, next)
__device__ __forceinline__ void stage4(float* dst, const float* src, int f, int next) {
  const bool in = f >= 0 && f < next;
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src + (in ? f : 0)), "r"(in ? 4 : 0)
               : "memory");
}

// 16-byte cp.async of src[f, f + 4) into shared dst (f and next multiples
// of 4: the four cells are all inside or all outside); 0 outside
__device__ __forceinline__ void stage16(float* dst, const float* src, int f, int next) {
  const bool in = f >= 0 && f < next;
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src + (in ? f : 0)), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
__device__ __forceinline__ void stage_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// all but the last committed group of this thread's copies have landed
__device__ __forceinline__ void stage_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// ext cells f0 + [0, n) of grid u into su, 16 bytes a copy with q.vec
__device__ __forceinline__ void stage_run(const Pass& q, float* su, const float* u, int f0, int n) {
  if (q.vec)
    for (int k = 4 * threadIdx.x; k < n; k += 4 * THREADS) stage16(su + k, u, f0 + k, q.next);
  else
    for (int k = threadIdx.x; k < n; k += THREADS) stage4(su + k, u, f0 + k, q.next);
}

// a[k] = op(a[k], b[k]) over the cells [0, n) of a run that this thread
// staged (stage_run's mapping): its own copies have landed after stage_wait
template <typename Op>
__device__ __forceinline__ void combine_run(const Pass& q, float* a, const float* b, int n, Op op) {
  if (q.vec) {
    for (int k = 4 * threadIdx.x; k < n; k += 4 * THREADS) {
      float4 x = *reinterpret_cast<float4*>(a + k);
      const float4 y = *reinterpret_cast<const float4*>(b + k);
      x.x = op(x.x, y.x);
      x.y = op(x.y, y.y);
      x.z = op(x.z, y.z);
      x.w = op(x.w, y.w);
      *reinterpret_cast<float4*>(a + k) = x;
    }
  } else {
    for (int k = threadIdx.x; k < n; k += THREADS) a[k] = op(a[k], b[k]);
  }
}

// the window of grid u in plane rel of a run whose first tile starts at
// ext cell a0 (rel -1: the plane below it) into su: ext cells a0 + rel Y Z -
// P + [0, W)
__device__ __forceinline__ void stage_window(const Pass& q, int a0, int rel, const float* u, float* su) {
  stage_run(q, su, u, a0 + rel * q.yz - q.P, q.W);
}

// ring slots of the windows of plane rel of a run (rel >= -1)
__device__ __forceinline__ int slot2(int rel) { return (rel + 2) & 1; }
__device__ __forceinline__ int slot3(int rel) { return (rel + 3) % 3; }
__device__ __forceinline__ int slot4(int rel) { return (rel + 4) & 3; }

// The chunk partials of tile t: term(j) is cell j of the tile (the cell
// t TILE + j exists); chunk c's partial is block_reduce's order over it.
template <typename Term>
__device__ __forceinline__ void tile_sums(const Pass& q, int t, float* partial, float* wsum, Term term) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < TILE_CHUNKS; ++k) {
    const int c = t * TILE_CHUNKS + k;
    if (c >= q.nchunks) break;
    const int j = k * THREADS + threadIdx.x;
    const float v = warp_reduce(t * TILE + j < q.n ? term(j) : 0.f, AddOp());
    if (lane == 0) wsum[k * WARPS + warp] = v;
  }
  __syncthreads();
  for (int k = warp; k < TILE_CHUNKS; k += WARPS) {
    const int c = t * TILE_CHUNKS + k;
    if (c >= q.nchunks) break;
    const float v = fold_warps(wsum + k * WARPS, WARPS, AddOp());
    if (lane == 0) partial[c] = v;
  }
  __syncthreads();  // the next tile restages shared memory
}

// k1: s = z + beta s_old into the newer s; As = A s; the chunk partials of
// s.As. Shared memory: four slots of z's windows, where s is computed in
// place (the planes below, of and above the tile, and the next plane in
// flight), three of s_old's, and two of diag and dfl at the tile's cells.
template <int H>
__global__ void __launch_bounds__(THREADS, PASS_MIN_BLOCKS)
    k1_kernel(const float* __restrict__ z_, Pair s, const int* it, int flip, const float* __restrict__ scal,
              const float* __restrict__ diag, const float* __restrict__ dfl, float* __restrict__ As,
              float* __restrict__ partial, Pass q) {
  extern __shared__ float sm[];
  __shared__ float wsum[TILE_CHUNKS * WARPS];
  const int par = parity(it, flip);
  const float* s_old = s.older(par);
  float* s_new = s.newer(par);
  const float beta = scal[BETA];
  const float s_out = 0.f + beta * 0.f;  // k1_cell's term at a neighbour outside the grid
  const int Z = q.g.Z, yz = q.yz, P = q.P, W = q.W;
  if (H > 0)
    for (int j = blockIdx.x * THREADS + threadIdx.x; j < 2 * H * yz; j += gridDim.x * THREADS) {
      const int e = halo_index<H>(q.g, j);
      s_new[e] = z_[e] + beta * s_old[e];
    }
  float* sw = sm;
  float* so = sm + 4 * W;
  float* dgf = sm + 7 * W;  // two slots of [diag | dfl]
  auto stage_plane = [&](int a0, int rel) {
    stage_window(q, a0, rel, z_, sw + slot4(rel) * W);
    stage_window(q, a0, rel, s_old, so + slot3(rel) * W);
  };
  auto stage_own = [&](int a, int i) {
    stage_run(q, dgf + (i & 1) * 2 * TILE, diag, a, TILE);
    stage_run(q, dgf + (i & 1) * 2 * TILE + TILE, dfl, a, TILE);
  };
  auto make_s = [&](int rel) {  // the cells of the window this thread staged
    combine_run(q, sw + slot4(rel) * W, so + slot3(rel) * W, W, [beta](float zv, float sv) { return zv + beta * sv; });
  };
  for (int k = blockIdx.x; k < q.nruns; k += gridDim.x) {
    int t0, len;
    run_of(q, k, t0, len);
    const int a0 = t0 * TILE + H * yz;
    stage_plane(a0, -1);
    stage_plane(a0, 0);
    stage_plane(a0, 1);
    stage_own(a0, 0);
    stage_wait();
    make_s(-1);
    make_s(0);
    for (int i = 0; i < len; ++i) {
      // in flight while this tile computes: the next tile's cells, the plane above it
      const int a = a0 + i * yz, t = t0 + i * q.tpp;
      if (i + 1 < len) stage_own(a + yz, i + 1);
      if (i + 2 <= len) stage_plane(a0, i + 2);
      stage_commit();
      stage_wait_prior();
      make_s(i + 1);
      __syncthreads();
      const float *dg = dgf + (i & 1) * 2 * TILE, *df = dg + TILE;
      const float *lo = sw + slot4(i - 1) * W + P, *mid = sw + slot4(i) * W + P, *hi = sw + slot4(i + 1) * W + P;
      tile_sums(q, t, partial, wsum, [&](int j) {
        const int e = a + j;
        const float si = mid[j];
        float as = 0.f;  // A s off fluid
        if (df[j] > 0.f) {
          int y, z;
          yz_of(q, e, y, z);
          float acc = dg[j] * si;
          acc = acc - (e + yz < q.next ? hi[j] : s_out);
          acc = acc - (e >= yz ? lo[j] : s_out);
          acc = acc - (y + 1 < q.g.Y ? mid[j + Z] : s_out);
          acc = acc - (y > 0 ? mid[j - Z] : s_out);
          acc = acc - (z + 1 < Z ? mid[j + 1] : s_out);
          acc = acc - (z > 0 ? mid[j - 1] : s_out);
          as = acc;
        }
        s_new[e] = si;
        As[e] = as;
        return si * as;
      });
    }
  }
}

// k2: alpha from the s.As partials (0 without them: the z0 pass); p += alpha
// s; r = r_old - alpha As into the newer r; z = K K^T r; the chunk partials
// of z.r and the block's max|r| (0 in the slots past the blocks). Shared
// memory: three slots of r_old's
// windows, where r is computed in place (the tile's plane, the plane above,
// the next in flight), three of As's and of dfl's, two of u = t / max(dfl,
// 1) (the plane below and the tile's), t of the tile's plane, and two of p
// and s at the tile's cells. A march carries r and u from plane to plane:
// each plane's t is computed once.
template <int H>
__global__ void __launch_bounds__(THREADS, PASS_MIN_BLOCKS)
    k2_kernel(float* __restrict__ p, Pair r, Pair s, const int* it, int flip, const float* __restrict__ As,
              const float* __restrict__ part_sAs, int nparts, float* __restrict__ scal,
              const float* __restrict__ dfl, float* __restrict__ z_out, float* __restrict__ partial_zr,
              float* __restrict__ partial_max, Pass q) {
  extern __shared__ float sm[];
  __shared__ float red[RED_SLOTS];
  __shared__ float wsum[TILE_CHUNKS * WARPS];
  const int par = parity(it, flip);
  const float* r_old = r.older(par);
  float* r_new = r.newer(par);
  const float* s_new = s.newer(par);
  const int Z = q.g.Z, yz = q.yz, P = q.P, W = q.W;
  float* rw = sm;
  float* aw = rw + 3 * W;
  float* dw = aw + 3 * W;
  float* uw = dw + 3 * W;
  float* tw = uw + 2 * W + P;
  float* pss = uw + 3 * W;  // two slots of [p | s]
  auto stage_plane = [&](int a0, int rel) {
    stage_window(q, a0, rel, r_old, rw + slot3(rel) * W);
    stage_window(q, a0, rel, As, aw + slot3(rel) * W);
    stage_window(q, a0, rel, dfl, dw + slot3(rel) * W);
  };
  auto stage_own = [&](int a, int i) {
    stage_run(q, pss + (i & 1) * 2 * TILE, p, a, TILE);
    stage_run(q, pss + (i & 1) * 2 * TILE + TILE, s_new, a, TILE);
  };
  float alpha = 0.f;
  auto make_r = [&](int rel) {  // the cells of the window this thread staged
    combine_run(q, rw + slot3(rel) * W, aw + slot3(rel) * W, W,
                [alpha](float rv, float av) { return rv - alpha * av; });
  };
  // t_at and the lower-neighbour terms of k2_cell in plane rel of the run at
  // window offsets [j0, TILE): u, and t with tv. Off fluid (dfl 0, also
  // outside the ext grid) t = 0 and u = 0 / max(0, 1) = 0.
  auto make_tu = [&](int a0, int rel, int j0, bool tv_too) {
    const float *rr = rw + slot3(rel) * W + P, *ru = rw + slot3(rel + 1) * W + P, *dd = dw + slot3(rel) * W + P;
    float* uu = uw + slot2(rel) * W + P;
    for (int j = j0 + static_cast<int>(threadIdx.x); j < TILE; j += THREADS) {
      const float d = dd[j];
      float tv = 0.f, uv = 0.f;
      if (d > 0.f) {
        const int f = a0 + rel * yz + j;
        int y, z;
        yz_of(q, f, y, z);
        float up = 0.f;
        up = up + (f + yz < q.next ? ru[j] : 0.f);
        up = up + (y + 1 < q.g.Y ? rr[j + Z] : 0.f);
        up = up + (z + 1 < Z ? rr[j + 1] : 0.f);
        tv = rr[j] + up / d;
        uv = tv / fmaxf(d, 1.f);
      }
      uu[j] = uv;
      if (tv_too) tw[j] = tv;
    }
  };
  float rmax = 0.f;
  for (int k = blockIdx.x; k < q.nruns; k += gridDim.x) {
    int t0, len;
    run_of(q, k, t0, len);
    const int a0 = t0 * TILE + H * yz;
    float x[OR_KMAX][OR_ROUNDS];
    if (k == blockIdx.x && part_sAs) ordered_loads(part_sAs, nparts, 0, x);  // ahead of the copies
    stage_plane(a0, -1);
    stage_plane(a0, 0);
    stage_plane(a0, 1);
    stage_own(a0, 0);
    if (k == blockIdx.x) {
      // every block sums the partials in the one order while its first copies land
      alpha = part_sAs ? guarded_div(scal[SIGMA], ordered_reduce_from(part_sAs, nparts, AddOp(), red, x)) : 0.f;
      if (blockIdx.x == 0 && threadIdx.x == 0) scal[ALPHA] = alpha;
      if (H > 0)
        for (int j = blockIdx.x * THREADS + threadIdx.x; j < 2 * H * yz; j += gridDim.x * THREADS) {
          const int e = halo_index<H>(q.g, j);
          r_new[e] = r_old[e] - alpha * As[e];
        }
    }
    stage_wait();
    make_r(-1);
    make_r(0);
    __syncthreads();
    make_tu(a0, -1, 0, false);  // u of the plane below the run's first tile
    __syncthreads();            // the next copies go to its slots
    for (int i = 0; i < len; ++i) {
      // in flight while this tile computes: the next tile's cells, the plane above it
      const int a = a0 + i * yz, t = t0 + i * q.tpp;
      if (i + 1 < len) stage_own(a + yz, i + 1);
      if (i + 2 <= len) stage_plane(a0, i + 2);
      stage_commit();
      stage_wait_prior();
      make_r(i + 1);
      __syncthreads();
      make_tu(a0, i, -Z, true);
      __syncthreads();
      const float *rm = rw + slot3(i) * W + P, *dm = dw + slot3(i) * W + P;
      const float *u0 = uw + slot2(i - 1) * W + P, *u1 = uw + slot2(i) * W + P;
      const float *ps = pss + (i & 1) * 2 * TILE, *ss = ps + TILE;
      tile_sums(q, t, partial_zr, wsum, [&](int j) {
        const int e = a + j;
        p[e] = ps[j] + alpha * ss[j];
        const float ri = rm[j];
        float zi = 0.f;
        if (dm[j] > 0.f) {
          int y, z;
          yz_of(q, e, y, z);
          float lo = 0.f;
          lo = lo + (e >= yz ? u0[j] : 0.f);
          lo = lo + (y > 0 ? u1[j - Z] : 0.f);
          lo = lo + (z > 0 ? u1[j - 1] : 0.f);
          zi = tw[j] + lo;
        }
        r_new[e] = ri;
        z_out[e] = zi;
        rmax = fmaxf(rmax, fabsf(ri));
        return zi * ri;
      });
    }
  }
  const float m = block_reduce(rmax, MaxOp(), red);
  if (threadIdx.x == 0) partial_max[blockIdx.x] = m;
  if (blockIdx.x == 0)  // the tail reduces one max per chunk: 0 past the blocks
    for (int j = gridDim.x + threadIdx.x; j < q.nchunks; j += THREADS) partial_max[j] = 0.f;
}

// After k2's all-reduces, one block of THREADS: sigma' = z.r and err =
// max|r| as the ordered sums of the partials; beta = sigma' / (sigma +-
// 1e-10) (0 if first), sigma = sigma'. With it (the mesh's loop) also the predicate after
// iteration *it, JAX's cond after its body (blub_tpu/sim/pressure.py:147-163):
// the iteration checks at i % freq == 0 or i == max_iter - 1 and converges
// there if err < tol; go = not converged and i + 1 < max_iter; *it = i + 1.
__global__ void tail_kernel(const float* __restrict__ partial_zr, int nzr, const float* __restrict__ partial_max,
                            int nmax, float* __restrict__ scal, int first, int* it, int* go, float tol, int max_iter,
                            int freq) {
  __shared__ float smem[RED_SLOTS];
  float xz[OR_KMAX][OR_ROUNDS], xm[OR_KMAX][OR_ROUNDS];
  ordered_loads(partial_zr, nzr, 0, xz);  // both sums' loads in flight at once
  ordered_loads(partial_max, nmax, 0, xm);
  const float sigma_new = ordered_reduce_from(partial_zr, nzr, AddOp(), smem, xz);
  const float err = ordered_reduce_from(partial_max, nmax, MaxOp(), smem, xm);
  if (threadIdx.x == 0) {
    scal[BETA] = first ? 0.f : guarded_div(sigma_new, scal[SIGMA]);
    scal[SIGMA] = sigma_new;
    scal[ERR] = err;
    if (it) {
      const int i = *it;
      const bool converged = (i % freq == 0 || i == max_iter - 1) && err < tol;
      *it = i + 1;
      *go = !converged && i + 1 < max_iter;
    }
  }
}

static int blocks(Grid g) { return chunks(g.X, g.Y, g.Z); }

// halo: 0 (the whole grid) or 1 (an x slab between two halo planes); every
// window index of the ext grid must take a 32-bit int
static int grid_check(int halo, int X, int Y, int Z) {
  return (halo == 0 || halo == 1) && X >= 1 && Y >= 1 && Z >= 1 &&
                 (long long)(X + 2 * halo + 2) * Y * Z + 2LL * (TILE_CHUNKS * THREADS + Z + 4) <= INT32_MAX
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
}

static bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// vec: the staged grids are 16-byte aligned (aligned16)
static Pass pass_geom(int halo, int X, int Y, int Z, bool vec) {
  Pass q;
  q.g = Grid{X, Y, Z};
  q.yz = Y * Z;
  q.next = (X + 2 * halo) * Y * Z;
  q.n = X * Y * Z;
  q.nchunks = chunks(X, Y, Z);
  q.ntiles = (q.nchunks + TILE_CHUNKS - 1) / TILE_CHUNKS;
  q.vec = vec && (Y * Z) % 4 == 0;
  q.P = q.vec ? (Z + 4) / 4 * 4 : Z + 1;
  q.W = TILE + 2 * q.P;
  q.fz = fast_div(Z);
  q.fy = fast_div(Y);
  return q;
}

// dynamic shared memory of k1 (seven windows, four tile arrays) and k2
// (twelve windows, four tile arrays)
static size_t k1_smem(const Pass& q) { return (7 * static_cast<size_t>(q.W) + 4 * TILE) * sizeof(float); }
static size_t k2_smem(const Pass& q) { return (12 * static_cast<size_t>(q.W) + 4 * TILE) * sizeof(float); }

// Blocks of a pass kernel that the card holds at once (occupancy x SMs at
// this shared memory), cached per kernel, card and size.
template <typename K>
static int pass_fit(K kernel, size_t smem, int& fit) {
  struct Entry {
    const void* k;
    int dev;
    size_t smem;
    int fit;
  };
  static Entry cache[16];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int i = 0; i < used; ++i)
    if (cache[i].k == reinterpret_cast<const void*>(kernel) && cache[i].dev == dev && cache[i].smem == smem) {
      fit = cache[i].fit;
      return 0;
    }
  int sms = 0, per_sm = 0;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  fit = per_sm * sms;
  if (used < 16) cache[used++] = Entry{reinterpret_cast<const void*>(kernel), dev, smem, fit};
  return 0;
}

// The runs of tiles for a card that holds fit blocks at once: single tiles
// while they fit or when tiles do not make up whole planes (Y Z % TILE != 0),
// else marches of as few planes as bring the runs within fit. -> the blocks:
// one per run, at most fit (then blocks walk runs). Which block walks which
// tiles never changes the result.
static int plan_runs(Pass& q, int fit) {
  q.tpp = q.yz % TILE == 0 ? q.yz / TILE : 0;
  q.march = 1;
  q.nruns = q.ntiles;
  while (q.tpp && q.nruns > fit && q.march < q.g.X) {
    ++q.march;
    q.nruns = q.tpp * ((q.g.X + q.march - 1) / q.march);
  }
  return q.nruns < fit ? q.nruns : fit;
}

BLUB_EXPORT int pcg_setup_launch(const int8_t* marker, float* diag, float* dfl, int halo, int X, int Y, int Z,
                                 cudaStream_t st) {
  if (int e = grid_check(halo, X, Y, Z)) return e;
  Grid g{X, Y, Z};
  if (halo)
    setup_kernel<1><<<blocks(g), THREADS, 0, st>>>(marker, diag, dfl, g);
  else
    setup_kernel<0><<<blocks(g), THREADS, 0, st>>>(marker, diag, dfl, g);
  return static_cast<int>(cudaGetLastError());
}

// the mesh's start (the persistent solve runs init_cell inline)
BLUB_EXPORT int pcg_init_launch(const float* pinit, const float* rhs, const float* diag, const float* dfl, float* p,
                                float* r, int X, int Y, int Z, cudaStream_t st) {
  if (int e = grid_check(1, X, Y, Z)) return e;
  Grid g{X, Y, Z};
  init_kernel<1><<<blocks(g), THREADS, 0, st>>>(pinit, rhs, diag, dfl, p, r, g);
  return static_cast<int>(cudaGetLastError());
}

// k1 with s = (s0, s1): the older is s0 when the parity of (it ? *it : 0) +
// flip is even, else s1
BLUB_EXPORT int pcg_k1_launch(const float* z, float* s0, float* s1, const int* it, int flip, const float* scal,
                              const float* diag, const float* dfl, float* As, float* partial, int halo, int X, int Y,
                              int Z, cudaStream_t st) {
  if (int e = grid_check(halo, X, Y, Z)) return e;
  Pass q = pass_geom(halo, X, Y, Z, aligned16({z, s0, s1, diag, dfl}));
  const size_t smem = k1_smem(q);
  const Pair s{s0, s1};
  int fit = 0;
  if (int e = halo ? pass_fit(k1_kernel<1>, smem, fit) : pass_fit(k1_kernel<0>, smem, fit)) return e;
  const int nb = plan_runs(q, fit);
  if (halo)
    k1_kernel<1><<<nb, THREADS, smem, st>>>(z, s, it, flip, scal, diag, dfl, As, partial, q);
  else
    k1_kernel<0><<<nb, THREADS, smem, st>>>(z, s, it, flip, scal, diag, dfl, As, partial, q);
  return static_cast<int>(cudaGetLastError());
}

// k2 with r = (r0, r1) and s = (s0, s1) as k1's pairs; part_sAs: the nparts
// (all-reduced) partials of k1, or null for alpha = 0
BLUB_EXPORT int pcg_k2_launch(float* p, float* r0, float* r1, float* s0, float* s1, const int* it, int flip,
                              const float* As, const float* part_sAs, int nparts, float* scal, const float* dfl,
                              float* z, float* partial_zr, float* partial_max, int halo, int X, int Y, int Z,
                              cudaStream_t st) {
  if (int e = grid_check(halo, X, Y, Z)) return e;
  Pass q = pass_geom(halo, X, Y, Z, aligned16({p, r0, r1, s0, s1, As, dfl}));
  const size_t smem = k2_smem(q);
  const Pair r{r0, r1}, s{s0, s1};
  int fit = 0;
  if (int e = halo ? pass_fit(k2_kernel<1>, smem, fit) : pass_fit(k2_kernel<0>, smem, fit)) return e;
  const int nb = plan_runs(q, fit);
  if (halo)
    k2_kernel<1><<<nb, THREADS, smem, st>>>(p, r, s, it, flip, As, part_sAs, nparts, scal, dfl, z, partial_zr,
                                             partial_max, q);
  else
    k2_kernel<0><<<nb, THREADS, smem, st>>>(p, r, s, it, flip, As, part_sAs, nparts, scal, dfl, z, partial_zr,
                                             partial_max, q);
  return static_cast<int>(cudaGetLastError());
}

// the tail; it and go null: the scalars only (the start's z0 pass, the probe)
BLUB_EXPORT int pcg_tail_launch(const float* partial_zr, int nzr, const float* partial_max, int nmax, float* scal,
                                int first, int* it, int* go, float tol, int max_iter, int freq, cudaStream_t st) {
  if (freq < 1 || (it == nullptr) != (go == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  tail_kernel<<<1, THREADS, 0, st>>>(partial_zr, nzr, partial_max, nmax, scal, first, it, go, tol, max_iter, freq);
  return static_cast<int>(cudaGetLastError());
}

// the launch of the pass kernels at a shape: out = [k1 blocks, k2 blocks,
// k1's and k2's dynamic shared memory bytes per block, tiles, k1's and k2's
// planes per run]
BLUB_EXPORT int pcg_pass_config(int halo, int X, int Y, int Z, int* out) {
  if (int e = grid_check(halo, X, Y, Z)) return e;
  // as the wrappers' aligned tensors launch
  Pass q1 = pass_geom(halo, X, Y, Z, true), q2 = q1;
  int fit1 = 0, fit2 = 0;
  if (int e = halo ? pass_fit(k1_kernel<1>, k1_smem(q1), fit1) : pass_fit(k1_kernel<0>, k1_smem(q1), fit1)) return e;
  if (int e = halo ? pass_fit(k2_kernel<1>, k2_smem(q2), fit2) : pass_fit(k2_kernel<0>, k2_smem(q2), fit2)) return e;
  out[0] = plan_runs(q1, fit1);
  out[1] = plan_runs(q2, fit2);
  out[2] = static_cast<int>(k1_smem(q1));
  out[3] = static_cast<int>(k2_smem(q2));
  out[4] = q2.ntiles;
  out[5] = q1.march;
  out[6] = q2.march;
  return 0;
}

// floats of a solve's partials: two sums per chunk and a max per block (at
// most one block per chunk)
BLUB_EXPORT int pcg_solve_partials(int X, int Y, int Z) { return 3 * chunks(X, Y, Z); }
