// Floor of a y+z rebin sweep for Hopper. Replaces the TPU kernel
// scripts/tpu_bench_yz_floor.py::_variant_kernel (def :60, pallas_call :174),
// which streamed the y-stage pack's windows in and wrote zeros, a core copy
// or a small tile, to price the pack's copy-through floor apart from its
// placement logic.
//
// Table: posq int32 [k_in, 2, X, Y, Z], dyn int32 [k_in, 6, X, Y, Z] (the
// slot-major layout; invalid slots are all zero). What a cell of a y-stage
// pack reads, its "window":
//   gated   the valid word of each of its k_in slots, the other 7 words of
//           its valid slots, and the valid word of each slot of the cells
//           at y-s..y+s (y != 0 offsets, inside the grid) with the rel word
//           of the valid ones;
//   ungated every word of every slot of the cell, and the valid and rel
//           words of every neighbour slot.
// Modes:
//   READ           gated window; one int32 per (x, 4-row y tile): the
//                  wrapping sum of every word it read (the loads must feed a
//                  result, or the compiler drops them); read_kernel
//   ZEROS          gated window, then the k_out-slot output as exact zeros
//   ZEROS_UNGATED  ungated window, then zeros
//   COPY           output slot q = input slot q for q < k_out (the valid
//                  word, and the other 7 words where it is valid; zeros
//                  elsewhere)
// In the zeros modes the window's sum is folded into the first word under a
// mask the caller passes as 0, so the loads stay and the output is zeros.
//
// What bounds it on the card: bytes, by design (no arithmetic to speak of).
//
// ZEROS, ZEROS_UNGATED and COPY (yz_floor_kernel): one block per (x, 4-row y
// tile), a thread per cell; the window's neighbour words are read again from
// L1/L2, as the pack reads them.
//
// READ (read_kernel) streams the table once at the byte floor. A cell's
// window sum is pay(y) + the sum of nb(y + o) over |o| <= s inside the grid,
// where nb = the valid words of its slots plus the rel words of the valid
// ones (the neighbour term) and pay = the dyn words of its valid slots. A
// wrapping sum is the same in any order, so a tile's output is the sum of
// its cells' pay plus each row's sum of nb times the number of the tile's
// rows within s of it. A thread per cell, as the other modes have, is bound
// by latency here (one 4-byte load in flight, each behind the branch on the
// slot before; 3.2x the byte bound) and reads the +-s halo rows again for
// every 4-row tile. So
//   - every table word is read from device memory once, and no halo row at
//     all: each cell's neighbour term is computed once, summed per row in
//     shared memory, and enters the tiles within s of its row with its
//     multiplicity;
//   - a thread owns 4 consecutive cells (a quad: 16-byte loads along z,
//     coalesced across the warp) and every SUBSETS-th slot of them; per
//     slot it loads the valid words, then the 7 payload words of the slot
//     together as predicated loads (no branch);
//   - a block takes a chunk of CHUNK consecutive cells of the flattened
//     [X, Y, Z] range (the hardware balances the fluid-heavy and empty
//     chunks over the SMs) and adds its rows' parts to out_sum with
//     unsigned atomicAdd, which is order-free and exact for a wrapping sum
//     (the caller zeroes out_sum).
// Measured variants (PERF.md, section 6): a thread per quad with all its slots,
// the valid words of 2-16 slots loaded together before their payloads, and
// persistent grids were all slower: the registers that hold more loads in
// flight cost occupancy or spill.
#include "common.cuh"

#include <algorithm>

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
__global__ void yz_floor_kernel(Table t, int s, int k_out, unsigned mask, int* __restrict__ out_p,
                                int* __restrict__ out_d) {
  const int x = blockIdx.x, y0 = blockIdx.y * TILE_Y;
  const int m = TILE_Y * t.Z;
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
      for (int q = 0; q < k_out; ++q) {
        out_p[t.p(q, CH_XY, cell)] = q == 0 ? (int)(w & mask) : 0;
        out_p[t.p(q, CH_ZV, cell)] = 0;
        for (int c = 0; c < NUM_DYN; ++c) out_d[t.d(q, c, cell)] = 0;
      }
    }
  }
}

// 16 bytes at p if pred, else zeros: predicated rather than branched, with
// the streaming hint (evict first). volatile keeps the loads in program
// order, so a thread holds one slot's words at a time (few registers, four
// blocks per SM: the variants that hoisted more loads spilled).
__device__ __forceinline__ uint4 load_if(const uint4* p, bool pred) {
  uint4 r;
  asm volatile(
      "{\n\t.reg .pred q;\n\t"
      "setp.ne.u32 q, %5, 0;\n\t"
      "@q ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];\n\t"
      "@!q mov.b32 %0, 0;\n\t@!q mov.b32 %1, 0;\n\t@!q mov.b32 %2, 0;\n\t@!q mov.b32 %3, 0;\n\t}"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p), "r"((unsigned)pred));
  return r;
}

__device__ __forceinline__ unsigned gate(unsigned v, unsigned w) { return (v & 1u) ? w : 0u; }

#define SUBSETS 2                          // threads per quad; each takes every SUBSETS-th slot
#define QUADS (THREADS / SUBSETS)          // quads per block
#define CHUNK (4 * QUADS)                  // cells per block
#define CHUNK_ROWS (CHUNK + 1)             // rows a chunk can touch (Z = 1)
#define CHUNK_TILES (CHUNK / 4 + 2)

// posq, dyn as uint4 over the flattened cells (n4 = X Y Z / 4 quads per
// plane); one block per chunk of CHUNK cells; out_sum unsigned [X Y / 4],
// zeroed by the caller.
__global__ void __launch_bounds__(THREADS, 4) read_kernel(const uint4* __restrict__ posq,
                                                          const uint4* __restrict__ dyn, int k_in, int Y, int Z,
                                                          int s, unsigned n4, unsigned* __restrict__ out_sum) {
  __shared__ unsigned rowN[CHUNK_ROWS];    // per row: the sum of its cells' nb
  __shared__ unsigned tileP[CHUNK_TILES];  // per tile: the sum of its cells' pay
  __shared__ uint4 nbS[SUBSETS][QUADS];    // per thread: its slots' nb of each cell of its quad
  __shared__ unsigned payS[SUBSETS][QUADS];
  const size_t plane = n4;
  const unsigned ql = threadIdx.x % QUADS, sub = threadIdx.x / QUADS;
  const unsigned c0 = blockIdx.x * CHUNK, c1 = min(c0 + CHUNK, n4 * 4u);  // cells [c0, c1)
  const unsigned g0 = c0 / Z, g1 = (c1 - 1) / Z;  // rows [g0, g1] (x Y + y)
  const unsigned t0 = g0 / 4u;                     // first tile (x Y / 4 + y / 4)
  for (unsigned i = threadIdx.x; i <= g1 - g0; i += THREADS) rowN[i] = 0u;
  for (unsigned i = threadIdx.x; i <= g1 / 4u - t0; i += THREADS) tileP[i] = 0u;
  const unsigned qd = c0 / 4u + ql;  // this thread's quad: 4 cells along z
  uint4 nb = make_uint4(0u, 0u, 0u, 0u);
  unsigned pay = 0u;
  if (qd * 4u < c1) {
    for (int q = sub; q < k_in; q += SUBSETS) {  // the slot's valid word, then its 7 words where valid
      const uint4 v = load_if(posq + (size_t)(q * NUM_POSQ + CH_ZV) * plane + qd, true);
      const bool any = ((v.x | v.y | v.z | v.w) & 1u) != 0u;
      const uint4 r = load_if(posq + (size_t)(q * NUM_POSQ + CH_XY) * plane + qd, any);
      uint4 d[NUM_DYN];
#pragma unroll
      for (int c = 0; c < NUM_DYN; ++c) d[c] = load_if(dyn + (size_t)(q * NUM_DYN + c) * plane + qd, any);
      unsigned dx = 0u, dy = 0u, dz = 0u, dw = 0u;
#pragma unroll
      for (int c = 0; c < NUM_DYN; ++c) {
        dx += d[c].x;
        dy += d[c].y;
        dz += d[c].z;
        dw += d[c].w;
      }
      nb.x += v.x + gate(v.x, r.x);
      nb.y += v.y + gate(v.y, r.y);
      nb.z += v.z + gate(v.z, r.z);
      nb.w += v.w + gate(v.w, r.w);
      pay += gate(v.x, dx) + gate(v.y, dy) + gate(v.z, dz) + gate(v.w, dw);
    }
  }
  nbS[sub][ql] = nb;
  payS[sub][ql] = pay;
  __syncthreads();
  if (threadIdx.x < QUADS && qd * 4u < c1) {  // the quad's sums into its row(s) and its tile
#pragma unroll
    for (int k = 1; k < SUBSETS; ++k) {
      const uint4 m = nbS[k][ql];
      nb.x += m.x;
      nb.y += m.y;
      nb.z += m.z;
      nb.w += m.w;
      pay += payS[k][ql];
    }
    const unsigned g = qd * 4u / Z, gl = (qd * 4u + 3u) / Z;
    if (g == gl) {
      atomicAdd(&rowN[g - g0], nb.x + nb.y + nb.z + nb.w);
    } else {  // Z % 4 != 0: the quad spans rows
      atomicAdd(&rowN[(qd * 4u) / Z - g0], nb.x);
      atomicAdd(&rowN[(qd * 4u + 1u) / Z - g0], nb.y);
      atomicAdd(&rowN[(qd * 4u + 2u) / Z - g0], nb.z);
      atomicAdd(&rowN[(qd * 4u + 3u) / Z - g0], nb.w);
    }
    atomicAdd(&tileP[g / 4u - t0], pay);  // a quad lies in one tile (4 Z cells)
  }
  __syncthreads();
  // the tiles this chunk's rows reach: within s rows, in the same x plane
  const unsigned tiles_per_x = (unsigned)Y / 4u;
  const unsigned lo = (g0 - min((unsigned)s, g0 % (unsigned)Y)) / 4u;
  const unsigned hi = (g1 + min((unsigned)s, (unsigned)Y - 1u - g1 % (unsigned)Y)) / 4u;
  for (unsigned t = lo + threadIdx.x; t <= hi; t += THREADS) {
    unsigned acc = (t >= t0 && t <= g1 / 4u) ? tileP[t - t0] : 0u;
    const unsigned x = t / tiles_per_x, r0 = 4u * t, r3 = r0 + 3u;  // the tile's rows [r0, r3]
    const unsigned ga = max(g0, r0 > (unsigned)s ? r0 - (unsigned)s : 0u), gb = min(g1, r3 + (unsigned)s);
    for (unsigned g = ga; g <= gb; ++g) {
      if (g / (unsigned)Y != x) continue;
      const unsigned m = min(r3, g + (unsigned)s) - max(r0, g > (unsigned)s ? g - (unsigned)s : 0u) + 1u;
      acc += m * rowN[g - g0];  // row g's nb counts once for each of the tile's rows within s of it
    }
    if (acc) atomicAdd(out_sum + t, acc);
  }
}

// READ: one block per chunk of CHUNK cells
static int launch_read(const int* posq, const int* dyn, int* out_sum, int k_in, int X, int Y, int Z, int s,
                       cudaStream_t st) {
  const size_t cells = (size_t)X * Y * Z;
  if (cells >= (1ull << 31)) return static_cast<int>(cudaErrorInvalidValue);
  s = std::min(s, Y);  // a wider window reaches no further row of the plane
  const unsigned blocks = (unsigned)((cells + CHUNK - 1) / CHUNK);
  read_kernel<<<blocks, THREADS, 0, st>>>(reinterpret_cast<const uint4*>(posq), reinterpret_cast<const uint4*>(dyn),
                                          k_in, Y, Z, s, (unsigned)(cells / 4), reinterpret_cast<unsigned*>(out_sum));
  return static_cast<int>(cudaGetLastError());
}

// posq/dyn: the k_in-slot input; READ adds to out_sum int32 [X, Y / 4] (zeroed
// by the caller), the other modes write out_p int32 [k_out, 2, X, Y, Z] and
// out_d int32 [k_out, 6, X, Y, Z]
BLUB_EXPORT int yz_floor_launch(const int* posq, const int* dyn, int* out_sum, int* out_p, int* out_d, int k_in,
                                int k_out, int X, int Y, int Z, int s, int mode, unsigned mask, cudaStream_t st) {
  if (Y % TILE_Y != 0 || k_out < 1 || k_out > k_in || s < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == READ) return launch_read(posq, dyn, out_sum, k_in, X, Y, Z, s, st);
  Table t{posq, dyn, k_in, X, Y, Z, (size_t)X * Y * Z};
  dim3 grid((unsigned)X, (unsigned)(Y / TILE_Y));
  switch (mode) {
    case ZEROS: yz_floor_kernel<ZEROS><<<grid, THREADS, 0, st>>>(t, s, k_out, mask, out_p, out_d); break;
    case ZEROS_UNGATED: yz_floor_kernel<ZEROS_UNGATED><<<grid, THREADS, 0, st>>>(t, s, k_out, mask, out_p, out_d); break;
    case COPY: yz_floor_kernel<COPY><<<grid, THREADS, 0, st>>>(t, s, k_out, mask, out_p, out_d); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
