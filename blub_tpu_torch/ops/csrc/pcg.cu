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
// The pass kernels (setup_kernel, k1_kernel + alpha_kernel, k2_kernel +
// beta_kernel) run the same cell bodies and the same ordered sum one launch
// at a time; the probe blub_tpu_torch/probes/pcg_passes.py times them alone,
// and the mesh (parallel/sharded_sm.py) runs their x-slab instantiation (H =
// 1) with the halo exchanges and all-reduces between them, and continue_kernel
// after each iteration: the loop predicate on the device, which a CUDA WHILE
// node reads (ops/csrc/graph.cu).
#include <cooperative_groups.h>

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
// the passes one launch at a time: the probes' (probes/pcg_passes.py, H = 0,
// each pass with its reduction) and the mesh's (parallel/sharded_sm.py, H =
// 1, on an x slab).
//
// A whole-grid kernel cannot exchange halos inside its loop, so the mesh runs
// an iteration as these passes with the exchanges and all-reduces between
// them (every grid [X+2, Y, Z], the slab's planes between two halo planes):
//
//   z's x halo from the neighbours
//   k1     s = z + beta s_old, also on the halo planes (so s_old's halo is
//          always held); As = A s; partials of s.As       | all-reduce partials
//   alpha  the ordered sum of the partials; alpha         |
//   As's x halo from the neighbours
//   k2     p += alpha s; r = r_old - alpha As, also on the halo planes;
//          z = K K^T r; partials of z.r and max|r|        | all-reduce partials
//   beta   the ordered sums; beta, sigma, err             | (MAX: check iterations)
//
// The solve starts with setup (then dfl's halo), init (p0, r0; then r0's
// halo) and a k2 + beta with alpha = 0 (z0, sigma0), as the persistent
// solve. The all-reduces add the ranks' partials chunk by chunk, so every
// rank sums the same values in the same order and holds the same scalars; at
// world size 1 (zero halos) the mesh's solve gives pcg_solve_kernel's bits.

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

template <int H>
__global__ void k1_kernel(const float* __restrict__ z_, const float* __restrict__ s_old,
                          const float* __restrict__ scal, const float* __restrict__ diag,
                          const float* __restrict__ dfl, float* __restrict__ s_new,
                          float* __restrict__ As, float* __restrict__ partial, Grid g) {
  __shared__ float smem[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float prod = i < g.n() ? k1_cell<H>(z_, s_old, scal[BETA], diag, dfl, s_new, As, g, i) : 0.f;
  if (H > 0)
    for (int j = i; j < 2 * H * g.Y * g.Z; j += gridDim.x * blockDim.x) {
      const int e = halo_index<H>(g, j);
      s_new[e] = z_[e] + scal[BETA] * s_old[e];
    }
  const float tot = block_reduce(prod, AddOp(), smem);
  if (threadIdx.x == 0) partial[blockIdx.x] = tot;
}

__global__ void alpha_kernel(const float* __restrict__ partial, int nparts, float* __restrict__ scal) {
  __shared__ float smem[RED_SLOTS];
  const float sAs = ordered_reduce(partial, nparts, AddOp(), smem);
  if (threadIdx.x == 0) scal[ALPHA] = guarded_div(scal[SIGMA], sAs);
}

template <int H>
__global__ void k2_kernel(float* __restrict__ p, const float* __restrict__ r_old,
                          const float* __restrict__ s, const float* __restrict__ As,
                          const float* __restrict__ scal, const float* __restrict__ dfl,
                          float* __restrict__ r_new, float* __restrict__ z_out,
                          float* __restrict__ partial_zr, float* __restrict__ partial_max, Grid g) {
  __shared__ float smem[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float zr = 0.f, rabs = 0.f;
  if (i < g.n()) k2_cell<H>(p, r_old, s, As, scal[ALPHA], dfl, r_new, z_out, g, i, zr, rabs);
  if (H > 0)
    for (int j = i; j < 2 * H * g.Y * g.Z; j += gridDim.x * blockDim.x) {
      const int e = halo_index<H>(g, j);
      r_new[e] = r_old[e] - scal[ALPHA] * As[e];
    }
  const float tot = block_reduce(zr, AddOp(), smem);
  if (threadIdx.x == 0) partial_zr[blockIdx.x] = tot;
  const float mx = block_reduce(rabs, MaxOp(), smem);
  if (threadIdx.x == 0) partial_max[blockIdx.x] = mx;
}

__global__ void beta_kernel(const float* __restrict__ partial_zr, const float* __restrict__ partial_max,
                            int nparts, float* __restrict__ scal, int first) {
  __shared__ float smem[RED_SLOTS];
  const float sigma_new = ordered_reduce(partial_zr, nparts, AddOp(), smem);
  const float m = ordered_reduce(partial_max, nparts, MaxOp(), smem);
  if (threadIdx.x == 0) {
    scal[BETA] = first ? 0.f : guarded_div(sigma_new, scal[SIGMA]);
    scal[SIGMA] = sigma_new;
    scal[ERR] = m;
  }
}

// The mesh solve's loop predicate after iteration *it (JAX's cond after its
// body, blub_tpu/sim/pressure.py:147-163): the iteration checks at i % freq
// == 0 or i == max_iter - 1, converges there if err < tol; go = not converged
// and i + 1 < max_iter. One thread: glue, as the frame graph's handle kernels.
__global__ void continue_kernel(int* it, int* go, const float* __restrict__ scal, float tol, int max_iter,
                                int freq) {
  const int i = *it;
  const bool converged = (i % freq == 0 || i == max_iter - 1) && scal[ERR] < tol;
  *it = i + 1;
  *go = !converged && i + 1 < max_iter;
}

static int blocks(Grid g) { return chunks(g.X, g.Y, g.Z); }

// halo: 0 (the whole grid) or 1 (an x slab between two halo planes); the
// ext grid's words must take 32-bit indices
static int grid_check(int halo, int X, int Y, int Z) {
  return (halo == 0 || halo == 1) && X >= 1 && Y >= 1 && Z >= 1 && (long long)(X + 2 * halo) * Y * Z <= INT32_MAX
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
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

// k1, then (reduce != 0) alpha from its partials; the mesh passes reduce = 0
// and launches alpha (pcg_alpha_launch) after the all-reduce
BLUB_EXPORT int pcg_k1_launch(const float* z, const float* s_old, float* scal, const float* diag,
                              const float* dfl, float* s_new, float* As, float* partial, int halo, int reduce, int X,
                              int Y, int Z, cudaStream_t st) {
  if (int e = grid_check(halo, X, Y, Z)) return e;
  Grid g{X, Y, Z};
  if (halo)
    k1_kernel<1><<<blocks(g), THREADS, 0, st>>>(z, s_old, scal, diag, dfl, s_new, As, partial, g);
  else
    k1_kernel<0><<<blocks(g), THREADS, 0, st>>>(z, s_old, scal, diag, dfl, s_new, As, partial, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !reduce) return static_cast<int>(e);
  alpha_kernel<<<1, RTHREADS, 0, st>>>(partial, blocks(g), scal);
  return static_cast<int>(cudaGetLastError());
}

BLUB_EXPORT int pcg_alpha_launch(const float* partial, int nparts, float* scal, cudaStream_t st) {
  alpha_kernel<<<1, RTHREADS, 0, st>>>(partial, nparts, scal);
  return static_cast<int>(cudaGetLastError());
}

// k2, then (reduce != 0) beta from its partials (beta = 0 if first)
BLUB_EXPORT int pcg_k2_launch(float* p, const float* r_old, const float* s, const float* As, float* scal,
                              const float* dfl, float* r_new, float* z, float* partial_zr, float* partial_max,
                              int first, int halo, int reduce, int X, int Y, int Z, cudaStream_t st) {
  if (int e = grid_check(halo, X, Y, Z)) return e;
  Grid g{X, Y, Z};
  if (halo)
    k2_kernel<1><<<blocks(g), THREADS, 0, st>>>(p, r_old, s, As, scal, dfl, r_new, z, partial_zr, partial_max, g);
  else
    k2_kernel<0><<<blocks(g), THREADS, 0, st>>>(p, r_old, s, As, scal, dfl, r_new, z, partial_zr, partial_max, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !reduce) return static_cast<int>(e);
  beta_kernel<<<1, RTHREADS, 0, st>>>(partial_zr, partial_max, blocks(g), scal, first);
  return static_cast<int>(cudaGetLastError());
}

BLUB_EXPORT int pcg_beta_launch(const float* partial_zr, const float* partial_max, int nparts, float* scal, int first,
                                cudaStream_t st) {
  beta_kernel<<<1, RTHREADS, 0, st>>>(partial_zr, partial_max, nparts, scal, first);
  return static_cast<int>(cudaGetLastError());
}

BLUB_EXPORT int pcg_continue_launch(int* it, int* go, const float* scal, float tol, int max_iter, int freq,
                                    cudaStream_t st) {
  if (freq < 1) return static_cast<int>(cudaErrorInvalidValue);
  continue_kernel<<<1, 1, 0, st>>>(it, go, scal, tol, max_iter, freq);
  return static_cast<int>(cudaGetLastError());
}

BLUB_EXPORT int pcg_num_partials(int X, int Y, int Z) { return blocks(Grid{X, Y, Z}); }

// floats of a solve's partials: two sums per chunk and a max per block (at
// most one block per chunk)
BLUB_EXPORT int pcg_solve_partials(int X, int Y, int Z) { return 3 * chunks(X, Y, Z); }
