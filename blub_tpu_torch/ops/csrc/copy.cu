// Table round-trip probe for Hopper: posq + 1 and dyn + 1 over the two int32
// tables of a slot-major table, in one launch. Replaces the TPU probe kernels
// of scripts/tpu_bench_copy_bw.py: pallas_step (pallas_call :74, an
// identity+1 kernel over both tables with auto-pipelined blocks) and
// halo_step (pallas_call :105, the same with the lead/trail 8-row y-halo
// blocks of posq as extra inputs, clamped at the edges).
//
// What bounds it on the card: bytes, by construction. Each word is read once
// and written once (the halo adds 16 rows of posq reads per 32-row y tile,
// mostly from L2); no arithmetic to speak of. So the design is about keeping
// loads in flight with as little launch and block overhead as possible:
//   - one launch covers both tables: one flat range of 16-byte words, posq's
//     first, so the round trip has one launch and one tail (the TPU kernel
//     is one pallas_call over both tables too);
//   - a block moves one contiguous 16 KB chunk of that range (twice the old
//     kernel's 32-row tile), each thread UNROLL coalesced 16-byte loads
//     issued before its first store.
// Tried on the card and dropped (PERF.md, section 6): a persistent grid with a
// grid-stride walk (slower: the blocks' streams lie far apart), streaming
// cache hints on the loads, and TMA bulk copies through a shared-memory ring.
// With HALO a thread whose word lies in the first 8 rows of a 32-row y tile
// of posq also loads the matching words of the tile's lead and trail rows
// (y0 - 8 and y0 + 32, clamped into the grid, as the TPU index maps clamp)
// and folds them into its word under a runtime mask that is 0: the loads
// stay and the result is still in + 1. Every tile reads its 16 halo rows
// once, as the TPU kernel's two halo blocks do.
#include "common.cuh"

#define TILE_Y 32
#define HALO_Y 8
#define THREADS 256
#define UNROLL 4

// unsigned adds: the +1 wraps like PyTorch's int32 add, without signed overflow
__device__ __forceinline__ uint4 plus1(uint4 v, unsigned extra) {
  return make_uint4(v.x + 1u + extra, v.y + 1u, v.z + 1u, v.w + 1u);
}

template <bool HALO>
__global__ void __launch_bounds__(THREADS) copy_kernel(const uint4* __restrict__ p_in, uint4* __restrict__ p_out,
                                                       unsigned np, const uint4* __restrict__ d_in,
                                                       uint4* __restrict__ d_out, unsigned n, unsigned Y,
                                                       unsigned Zv, unsigned mask) {
  const unsigned base = blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
  uint4 v[UNROLL];
  unsigned h[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned i = base + u * THREADS;
    v[u] = make_uint4(0u, 0u, 0u, 0u);
    h[u] = 0u;
    if (i < n) v[u] = i < np ? p_in[i] : d_in[i - np];
    if constexpr (HALO) {
      if (i < np) {
        const unsigned y = (i / Zv) % Y, r = y % TILE_Y;  // the row (plane, x, y) of posq
        if (r < HALO_Y) {
          const unsigned y0 = y - r;
          const unsigned at = i - y * Zv;  // the same word in row y = 0 of this (plane, x)
          const unsigned lead = (y0 >= HALO_Y ? y0 - HALO_Y : 0u) + r;
          const unsigned trail = min(y0 + TILE_Y, Y - HALO_Y) + r;
          const uint4 a = p_in[at + lead * Zv], b = p_in[at + trail * Zv];
          h[u] = (a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w) & mask;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned i = base + u * THREADS;
    if (i < np)
      p_out[i] = plus1(v[u], h[u]);
    else if (i < n)
      d_out[i - np] = plus1(v[u], 0u);
  }
}

// posq int32 [planes_p, Y, Z] and dyn int32 [planes_d, Y, Z] (planes: slots x
// channels x X) -> posq + 1, dyn + 1; Y % 32 == 0, Z % 4 == 0, 16-byte
// aligned, both tables together under 2^31 16-byte words. One launch.
BLUB_EXPORT int copy_launch(const int* posq, int* posq_out, const int* dyn, int* dyn_out, int planes_p,
                            int planes_d, int Y, int Z, int halo, unsigned mask, cudaStream_t st) {
  const int Zv = Z / 4;
  const size_t np = (size_t)planes_p * Y * Zv, n = np + (size_t)planes_d * Y * Zv;
  if (Y % TILE_Y != 0 || Z % 4 != 0 || Y < HALO_Y || planes_p < 1 || planes_d < 0 || n >= (1ull << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint4* pi = reinterpret_cast<const uint4*>(posq);
  const uint4* di = reinterpret_cast<const uint4*>(dyn);
  uint4* po = reinterpret_cast<uint4*>(posq_out);
  uint4* dout = reinterpret_cast<uint4*>(dyn_out);
  auto kernel = halo ? copy_kernel<true> : copy_kernel<false>;
  const unsigned blocks = (unsigned)((n + THREADS * UNROLL - 1) / (THREADS * UNROLL));
  kernel<<<blocks, THREADS, 0, st>>>(pi, po, (unsigned)np, di, dout, (unsigned)n, Y, Zv, mask);
  return static_cast<int>(cudaGetLastError());
}
