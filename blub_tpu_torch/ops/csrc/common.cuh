// Shared helpers of the hand-written Hopper kernels (built for sm_90a by
// blub_tpu_torch/ops/cuda.py into one shared library per source, with a
// plain C interface loaded through ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BLUB_EXPORT extern "C" __attribute__((visibility("default")))

// rel16 table layout (blub_tpu_torch/sim/slot_major.py): posq channel 0 =
// rx << 16 | (ry & 0xFFFF), channel 1 = rz << 16 | valid.
#define CH_XY 0
#define CH_ZV 1
#define NUM_POSQ 2
#define NUM_DYN 6
#define POS_INV 0.0001220703125f  // 2^-13
#define POS_SCALE 8192.0f

#define CELL_SOLID 0
#define CELL_FLUID 1
#define CELL_AIR (-1)

BLUB_EXPORT const char* blub_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

__device__ __forceinline__ int hi16(int b) { return b >> 16; }  // arithmetic shift
__device__ __forceinline__ int sext16(int b) { return ((b & 0xFFFF) ^ 0x8000) - 0x8000; }

// (hi << 16) | (lo & 0xFFFF) without shifting a negative int
__device__ __forceinline__ int pack16(int hi, int lo) {
  return static_cast<int>((static_cast<uint32_t>(hi) << 16) | (static_cast<uint32_t>(lo) & 0xFFFFu));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// bf16 pair (slot_major.pack_pair): round-to-nearest-even, -0.0 -> +0.0
__device__ __forceinline__ int pack_pair(float hi, float lo) {
  uint32_t hb = __float_as_uint(__bfloat162float(__float2bfloat16_rn(hi)) + 0.0f);
  uint32_t lb = __float_as_uint(__bfloat162float(__float2bfloat16_rn(lo)) + 0.0f);
  return static_cast<int>((hb & 0xFFFF0000u) | (lb >> 16));
}
__device__ __forceinline__ float unpack_hi(int p) {
  return __uint_as_float(static_cast<uint32_t>(p) & 0xFFFF0000u);
}
__device__ __forceinline__ float unpack_lo(int p) {
  return __uint_as_float(static_cast<uint32_t>(p) << 16);
}

__device__ __forceinline__ int wrap(int v, int n) {  // v in [-n, 2n)
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// Slot masks (bit q: slot q) are 32-bit words up to 32 slots and 64-bit
// words up to 64; the kernels that keep them are templates on the word.
__device__ __forceinline__ int lowest_slot(uint32_t m) { return __ffs((int)m) - 1; }
__device__ __forceinline__ int lowest_slot(uint64_t m) { return __ffsll((long long)m) - 1; }
__device__ __forceinline__ int slot_count(uint32_t m) { return __popc(m); }
__device__ __forceinline__ int slot_count(uint64_t m) { return __popcll(m); }
__device__ __forceinline__ uint32_t warp_or(uint32_t m) { return __reduce_or_sync(0xFFFFFFFFu, m); }
__device__ __forceinline__ uint64_t warp_or(uint64_t m) {  // __reduce_or_sync is 32-bit: the halves apart
  const uint32_t lo = __reduce_or_sync(0xFFFFFFFFu, (uint32_t)m);
  const uint32_t hi = __reduce_or_sync(0xFFFFFFFFu, (uint32_t)(m >> 32));
  return ((uint64_t)hi << 32) | lo;
}

// Warp-wide sum / max by a fixed shuffle tree; every lane must call it.
// Valid in lane 0.
template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// The nw (<= 32) warp values w[0, nw) folded by a fixed shuffle tree; called
// by a whole warp, valid in its lane 0.
template <typename T, typename Op>
__device__ __forceinline__ T fold_warps(const T* w, int nw, Op op) {
  const int lane = threadIdx.x & 31;
  T v = lane < nw ? w[lane] : w[0];
  for (int o = 16; o > 0; o >>= 1) {
    T u = __shfl_down_sync(0xffffffffu, v, o);
    v = (lane + o < nw) ? op(v, u) : v;
  }
  return v;
}

// Block-wide sum / max for blockDim.x a multiple of 32 (<= 1024); every
// thread of the block must call it. Fixed shuffle tree: repeatable.
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T* smem) {
  v = warp_reduce(v, op);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) v = fold_warps(smem, static_cast<int>(blockDim.x >> 5), op);
  __syncthreads();
  return v;  // valid in thread 0
}

struct AddOp {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
