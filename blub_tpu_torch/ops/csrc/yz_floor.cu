// Floor of a y+z rebin sweep for Hopper. Replaces the TPU kernel
// scripts/tpu_bench_yz_floor.py::_variant_kernel (def :60, pallas_call :174),
// which streamed the y-stage pack's windows in and wrote zeros, a core copy
// or a small tile, to price the pack's copy-through floor apart from its
// placement logic.
//
// Table: posq int32 [k_in, 2, X, Y, Z], dyn int32 [k_in, 6, X, Y, Z] (the
// slot-major layout; invalid slots are all zero). One block per (x, 4-row y
// tile); a thread per cell of the tile (Z contiguous, so loads coalesce).
// What a cell of a y-stage pack reads, its "window":
//   gated   the valid word of each of its k_in slots, the other 7 words of
//           its valid slots, and the valid word of each slot of the cells
//           at y-s..y+s (y != 0 offsets, inside the grid) with the rel word
//           of the valid ones;
//   ungated every word of every slot of the cell, and the valid and rel
//           words of every neighbour slot.
// Modes:
//   READ           gated window; one int32 per block: the wrapping sum of
//                  every word it read (the loads must feed a result, or the
//                  compiler drops them)
//   ZEROS          gated window, then the k_out-slot output as exact zeros
//   ZEROS_UNGATED  ungated window, then zeros
//   COPY           output slot q = input slot q for q < k_out (the valid
//                  word, and the other 7 words where it is valid; zeros
//                  elsewhere)
// In the zeros modes the window's sum is folded into the first word under a
// mask the caller passes as 0, so the loads stay and the output is zeros.
//
// What bounds it on the card: bytes, by design (no arithmetic to speak of).
// The window's neighbour words are read again from L1/L2, as the pack reads
// them; device memory sees each table word at most once.
#include "common.cuh"

#define TILE_Y 4
#define THREADS 256

enum { READ = 0, ZEROS = 1, ZEROS_UNGATED = 2, COPY = 3 };

struct Table {
  const int* posq;
  const int* dyn;
  int k_in, X, Y, Z;
  size_t n;  // cells
  __device__ size_t p(int q, int c, size_t cell) const { return (size_t)(q * NUM_POSQ + c) * n + cell; }
  __device__ size_t d(int q, int c, size_t cell) const { return (size_t)(q * NUM_DYN + c) * n + cell; }
};

template <bool GATED>
__device__ __forceinline__ unsigned window_sum(const Table& t, int x, int y, int z, int s) {
  const size_t cell = ((size_t)x * t.Y + y) * t.Z + z;
  unsigned acc = 0u;
  for (int q = 0; q < t.k_in; ++q) {
    const int v = t.posq[t.p(q, CH_ZV, cell)];
    acc += (unsigned)v;
    if (!GATED || (v & 1)) {
      acc += (unsigned)t.posq[t.p(q, CH_XY, cell)];
      for (int c = 0; c < NUM_DYN; ++c) acc += (unsigned)t.dyn[t.d(q, c, cell)];
    }
  }
  for (int o = -s; o <= s; ++o) {
    const int yy = y + o;
    if (o == 0 || yy < 0 || yy >= t.Y) continue;
    const size_t nb = ((size_t)x * t.Y + yy) * t.Z + z;
    for (int q = 0; q < t.k_in; ++q) {
      const int v = t.posq[t.p(q, CH_ZV, nb)];
      acc += (unsigned)v;
      if (!GATED || (v & 1)) acc += (unsigned)t.posq[t.p(q, CH_XY, nb)];
    }
  }
  return acc;
}

template <int MODE>
__global__ void yz_floor_kernel(Table t, int s, int k_out, unsigned mask, int* __restrict__ out_sum,
                                int* __restrict__ out_p, int* __restrict__ out_d) {
  __shared__ unsigned smem[32];
  const int x = blockIdx.x, y0 = blockIdx.y * TILE_Y;
  const int m = TILE_Y * t.Z;
  unsigned tot = 0u;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int y = y0 + i / t.Z, z = i % t.Z;
    const size_t cell = ((size_t)x * t.Y + y) * t.Z + z;
    if constexpr (MODE == COPY) {
      for (int q = 0; q < k_out; ++q) {
        const int v = t.posq[t.p(q, CH_ZV, cell)];
        if (v & 1) {
          out_p[t.p(q, CH_ZV, cell)] = v;
          out_p[t.p(q, CH_XY, cell)] = t.posq[t.p(q, CH_XY, cell)];
          for (int c = 0; c < NUM_DYN; ++c) out_d[t.d(q, c, cell)] = t.dyn[t.d(q, c, cell)];
        } else {
          out_p[t.p(q, CH_ZV, cell)] = 0;
          out_p[t.p(q, CH_XY, cell)] = 0;
          for (int c = 0; c < NUM_DYN; ++c) out_d[t.d(q, c, cell)] = 0;
        }
      }
    } else {
      const unsigned w = window_sum<MODE != ZEROS_UNGATED>(t, x, y, z, s);
      if constexpr (MODE == READ) {
        tot += w;
      } else {
        for (int q = 0; q < k_out; ++q) {
          out_p[t.p(q, CH_XY, cell)] = q == 0 ? (int)(w & mask) : 0;
          out_p[t.p(q, CH_ZV, cell)] = 0;
          for (int c = 0; c < NUM_DYN; ++c) out_d[t.d(q, c, cell)] = 0;
        }
      }
    }
  }
  if constexpr (MODE == READ) {
    tot = block_reduce(tot, AddOp(), smem);
    if (threadIdx.x == 0) out_sum[blockIdx.x * gridDim.y + blockIdx.y] = (int)tot;
  }
}

// posq/dyn: the k_in-slot input; READ writes out_sum int32 [X, Y / 4], the
// other modes out_p int32 [k_out, 2, X, Y, Z] and out_d int32 [k_out, 6, X, Y, Z]
BLUB_EXPORT int yz_floor_launch(const int* posq, const int* dyn, int* out_sum, int* out_p, int* out_d, int k_in,
                                int k_out, int X, int Y, int Z, int s, int mode, unsigned mask, cudaStream_t st) {
  if (Y % TILE_Y != 0 || k_out < 1 || k_out > k_in || s < 0) return static_cast<int>(cudaErrorInvalidValue);
  Table t{posq, dyn, k_in, X, Y, Z, (size_t)X * Y * Z};
  dim3 grid((unsigned)X, (unsigned)(Y / TILE_Y));
  switch (mode) {
    case READ: yz_floor_kernel<READ><<<grid, THREADS, 0, st>>>(t, s, k_out, mask, out_sum, out_p, out_d); break;
    case ZEROS: yz_floor_kernel<ZEROS><<<grid, THREADS, 0, st>>>(t, s, k_out, mask, out_sum, out_p, out_d); break;
    case ZEROS_UNGATED:
      yz_floor_kernel<ZEROS_UNGATED><<<grid, THREADS, 0, st>>>(t, s, k_out, mask, out_sum, out_p, out_d);
      break;
    case COPY: yz_floor_kernel<COPY><<<grid, THREADS, 0, st>>>(t, s, k_out, mask, out_sum, out_p, out_d); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
