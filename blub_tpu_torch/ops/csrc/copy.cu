// Table round-trip probe for Hopper: out = in + 1 over an int32 table
// viewed as planes [P, X, Y, Z]. Replaces the TPU probe kernels of
// scripts/tpu_bench_copy_bw.py: pallas_step (pallas_call :74, an identity+1
// kernel with auto-pipelined blocks) and halo_step (pallas_call :105, the
// same with the lead/trail 8-row y-halo blocks of posq as extra inputs,
// clamped at the edges).
//
// One block per (plane, x, 32-row y tile): 32 x Z ints moved as int4, two
// per thread. With HALO the block also reads the 8 rows before and after its
// tile (clamped into the grid, as the TPU index maps clamp) and folds them
// into its first word under a runtime mask that is 0, so the loads stay and
// the result is still in + 1.
//
// What bounds it on the card: bytes, by construction. Each word is read once
// and written once (the halo adds 16 rows per 32-row tile of reads, mostly
// from L2); no arithmetic to speak of.
#include "common.cuh"

#define TILE_Y 32
#define HALO_Y 8
#define THREADS 256

// unsigned adds: the +1 wraps like PyTorch's int32 add, without signed overflow
template <bool HALO>
__global__ void copy_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, int Y, int Zv, unsigned mask) {
  const int px = blockIdx.x;  // plane * X + x
  const int y0 = blockIdx.y * TILE_Y;
  const size_t row0 = ((size_t)px * Y + y0) * Zv;
  const int n = TILE_Y * Zv;
  unsigned h = 0u;
  if constexpr (HALO) {
    const int lead = max(y0 - HALO_Y, 0), trail = min(y0 + TILE_Y, Y - HALO_Y);
    const int m = HALO_Y * Zv;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const uint4 a = in[((size_t)px * Y + lead) * Zv + i];
      const uint4 b = in[((size_t)px * Y + trail) * Zv + i];
      h ^= a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w;
    }
    h &= mask;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint4 v = in[row0 + i];
    v.x += 1u + (i == threadIdx.x ? h : 0u);
    v.y += 1u;
    v.z += 1u;
    v.w += 1u;
    out[row0 + i] = v;
  }
}

// in/out int32 [planes, X, Y, Z], Y % 32 == 0, Z % 4 == 0, 16-byte aligned
BLUB_EXPORT int copy_launch(const int* in, int* out, int planes, int X, int Y, int Z, int halo, unsigned mask,
                            cudaStream_t st) {
  if (Y % TILE_Y != 0 || Z % 4 != 0 || Y < HALO_Y) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((unsigned)(planes * X), (unsigned)(Y / TILE_Y));
  const uint4* i4 = reinterpret_cast<const uint4*>(in);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  if (halo)
    copy_kernel<true><<<grid, THREADS, 0, st>>>(i4, o4, Y, Z / 4, mask);
  else
    copy_kernel<false><<<grid, THREADS, 0, st>>>(i4, o4, Y, Z / 4, mask);
  return static_cast<int>(cudaGetLastError());
}
