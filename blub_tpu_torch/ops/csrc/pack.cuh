// The stayers-keep-slots pack's device core (masks, decide, stream) and its
// tiling, shared by pack.cu's kernels and advect_pack.cu's fused kernels.
#pragma once

#include <algorithm>

#include "common.cuh"

#define PACK_THREADS 256
#define PACK_CELLS 512  // cells per block of pack_kernel; pack_yz_kernel's blocks hold PACK_THREADS
#define MAX_S 3          // a code holds the offset index (0..2s) in the 3 bits above the slot
#define MAX_W (2 * MAX_S + 1)
#define SMEM_MAX (227 * 1024)

// placement codes per mask word: (offset index << BITS) | slot, or EMPTY
template <typename M>
struct Codes;
template <>
struct Codes<uint32_t> {
  typedef uint8_t T;
  static constexpr int BITS = 5;
};
template <>
struct Codes<uint64_t> {
  typedef uint16_t T;
  static constexpr int BITS = 6;
};
template <typename M>
constexpr uint32_t EMPTY = (typename Codes<M>::T)~0u;
template <typename M>
constexpr uint32_t SLOT = (1u << Codes<M>::BITS) - 1u;

struct Table {
  const int* pin;
  const int* din;
  int* pout;
  int* dout;
  size_t n;  // cells
};

template <typename M>
__device__ __forceinline__ M low_bits(int k) {
  return k >= (int)(8 * sizeof(M)) ? ~(M)0u : (((M)1u << k) - 1u);
}

// offset of a slot's target bin along an axis: clip(g + ((rel + 4096) >> 13), 0, dim - 1) - g
__device__ __forceinline__ int bin_shift(int rel, int g, int dim) {
  return min(max(g + ((rel + 4096) >> 13), 0), dim - 1) - g;
}

// Source cell `cell` (coordinate g along `axis`): mask j = d + s of its valid
// slots whose target is the cell at offset d, |d| <= s, to m[j * stride].
template <typename M>
__device__ __forceinline__ void source_masks(const Table& t, size_t cell, int k_in, int axis, int g, int dim,
                                             int s, M* m, int stride) {
  M w[MAX_W] = {};
  const int* p = t.pin + cell;
  const int n = (int)t.n;
  for (int q0 = 0; q0 < k_in; q0 += 8) {  // 8 valid words in flight, then the rel words of the valid
    int b1[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) b1[u] = q0 + u < k_in ? p[((q0 + u) * NUM_POSQ + CH_ZV) * n] : 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (!(b1[u] & 1)) continue;
      int rel = hi16(b1[u]);
      if (axis != 2) {
        const int b0 = p[((q0 + u) * NUM_POSQ + CH_XY) * n];
        rel = axis == 0 ? hi16(b0) : sext16(b0);
      }
      const int j = bin_shift(rel, g, dim) + s;
#pragma unroll
      for (int i = 0; i < MAX_W; ++i)
        if (i == j) w[i] |= (M)1u << (q0 + u);
    }
  }
#pragma unroll
  for (int i = 0; i < MAX_W; ++i)
    if (i <= 2 * s) m[i * stride] = w[i];
}

// The set bits of m (ascending) fill the lowest empty output slots; each
// placed slot o gets the code (oi << BITS) | q. What does not fit is dropped.
template <typename M>
__device__ __forceinline__ void place(M m, int oi, M& empty, typename Codes<M>::T* code, int cstride,
                                      int& dropped) {
  while (m && empty) {
    const int q = lowest_slot(m), o = lowest_slot(empty);
    code[o * cstride] = (typename Codes<M>::T)((oi << Codes<M>::BITS) | q);
    m &= m - 1u;
    empty &= empty - 1u;
  }
  dropped += slot_count(m);
}

// Placement of one output cell from the masks of its source cells: mask j of
// the cell at index h + off * hst is masks[j * mstride + h + off * hst]; g is
// the cell's coordinate along the axis. Writes code[o * cstride] for every
// o < k_out; returns the filled output slots.
template <typename M>
__device__ __forceinline__ M decide(const M* masks, int mstride, int h, int hst, int g, int dim, int s, int k_out,
                                    typename Codes<M>::T* code, int cstride, int& dropped) {
  typedef typename Codes<M>::T C;
  const M full = low_bits<M>(k_out);
  const M stay = masks[s * mstride + h];
  M empty = full & ~stay;
  for (int o = 0; o < k_out; ++o)
    code[o * cstride] = ((stay >> o) & 1u) ? (C)((s << Codes<M>::BITS) | o) : (C)EMPTY<M>;
  place(stay & ~full, s, empty, code, cstride, dropped);  // tail stayers
  for (int off = -s; off <= s; ++off) {
    if (off == 0 || g + off < 0 || g + off >= dim) continue;
    place(masks[(s - off) * mstride + h + off * hst], s + off, empty, code, cstride, dropped);
  }
  return full & ~empty;
}

// The 8 words w of output slot o of cell dst.
__device__ __forceinline__ void store_slot(const Table& t, size_t dst, int o, const int w[NUM_POSQ + NUM_DYN]) {
#pragma unroll
  for (int c = 0; c < NUM_POSQ; ++c) t.pout[(size_t)(o * NUM_POSQ + c) * t.n + dst] = w[c];
#pragma unroll
  for (int c = 0; c < NUM_DYN; ++c) t.dout[(size_t)(o * NUM_DYN + c) * t.n + dst] = w[NUM_POSQ + c];
}

// Output slot o of cell dst: the 8 words of input slot q of cell src with the
// rel16 fields rebased (x_add and z_add on the high halves, y_add on the low
// half of the xy word), or zeros when !has.
__device__ __forceinline__ void stream_slot(const Table& t, size_t dst, int o, bool has, size_t src, int q,
                                            uint32_t x_add, uint32_t y_add, uint32_t z_add) {
  int w[NUM_POSQ + NUM_DYN];
  if (has) {
    uint32_t p0 = (uint32_t)t.pin[(size_t)(q * NUM_POSQ + CH_XY) * t.n + src];
    uint32_t p1 = (uint32_t)t.pin[(size_t)(q * NUM_POSQ + CH_ZV) * t.n + src];
    p0 = ((p0 & 0xFFFF0000u) | ((p0 + y_add) & 0xFFFFu)) + x_add;
    w[0] = (int)p0;
    w[1] = (int)(p1 + z_add);
#pragma unroll
    for (int c = 0; c < NUM_DYN; ++c) w[NUM_POSQ + c] = t.din[(size_t)(q * NUM_DYN + c) * t.n + src];
  } else {
#pragma unroll
    for (int c = 0; c < NUM_POSQ + NUM_DYN; ++c) w[c] = 0;
  }
  store_slot(t, dst, o, w);
}

__device__ __forceinline__ void add_counts(int* counts, const int* v, int nv) {
  __shared__ int red[32];
#pragma unroll
  for (int i = 0; i < nv; ++i) {
    const int r = block_reduce(v[i], AddOp(), red);
    if (threadIdx.x == 0 && r) atomicAdd(&counts[i], r);
  }
}

static int threads_for(int cells) { return std::min(PACK_THREADS, (cells + 31) / 32 * 32); }

// tile of pack_kernel: 32 cells along z where Z allows (a warp stores one
// 128-byte row), 16 along x for an x pack (8 along y for a y or z pack),
// the rest of PACK_CELLS across
static void pack_tile(int X, int Y, int Z, int axis, int* tx, int* ty, int* tz) {
  *tz = std::min(Z, 32);
  if (axis == 0) {
    *tx = std::min(X, 16);
    *ty = std::min(Y, std::max(1, PACK_CELLS / (*tz * *tx)));
  } else {
    *ty = std::min(Y, 8);
    *tx = std::min(X, std::max(1, PACK_CELLS / (*tz * *ty)));
  }
}

static int yz_rows(int Y, int Z) { return std::min(Y, std::max(1, PACK_THREADS / Z)); }

static bool wide(int k_in, int k_out) { return k_in > 32 || k_out > 32; }  // the 64-bit instantiation

static int pack_smem(int k_in, int k_out, int X, int Y, int Z, int axis, int s) {
  const int mb = wide(k_in, k_out) ? 8 : 4, cb = mb / 4;  // mask and code bytes
  if (axis == 3) {  // the fused y + z kernel; k_in is k_mid
    const int rows = yz_rows(Y, Z), nt = rows * Z;
    return mb * (2 * s + 1) * ((rows + 2 * s) * Z + nt) + cb * (k_in + k_out) * nt;
  }
  int tx, ty, tz;
  pack_tile(X, Y, Z, axis, &tx, &ty, &tz);
  const int nh = (tx + (axis == 0 ? 2 * s : 0)) * (ty + (axis == 1 ? 2 * s : 0)) * (tz + (axis == 2 ? 2 * s : 0));
  return mb * (2 * s + 1) * nh + cb * k_out * tx * ty * tz;
}

template <typename K>
static int set_smem(K kernel, int bytes) {
  if (bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  return 0;
}
