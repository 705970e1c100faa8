// rel16 fixed-point op smoke for Hopper. Replaces the TPU kernel
// scripts/tpu_smoke_relops.py::kern (def :32, pallas_call :55), which checked
// that the integer ops of the rel16 position layout lower and round as the
// table kernels need them.
//
// Per element of two f32 arrays pos and cell:
//   r   = round_half_even((pos - cell - 1) * 8192)      (rintf, as g2p.cu)
//   b   = pack16(r, r), carried through a float select on pos > -1e9
//   rx  = hi16(b) as f32;  rt = cell + 1 + sext16(b) * 2^-13
// It uses the very helpers of common.cuh that the table kernels use
// (pack16, hi16, sext16), so a change to them shows here first. Built with
// -fmad=false and no fast math (ops/cuda.py): flush-to-zero or a fused
// multiply-add would change the decode's bits.
//
// What bounds it on the card: nothing of note. At the probe's [8, 128] it is
// one launch over 16 KB, so its time is the launch itself.
#include "common.cuh"

#define THREADS 256

__global__ void relops_kernel(const float* __restrict__ pos, const float* __restrict__ cell,
                              float* __restrict__ rx, float* __restrict__ rt, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float p = pos[i], c = cell[i];
  const int r = static_cast<int>(rintf(((p - c) - 1.0f) * POS_SCALE));
  const float pf = p > -1e9f ? __int_as_float(pack16(r, r)) : 0.0f;
  const int b = __float_as_int(pf);
  rx[i] = static_cast<float>(hi16(b));
  rt[i] = (c + 1.0f) + static_cast<float>(sext16(b)) * POS_INV;
}

// pos, cell, rx, rt: f32 [n]
BLUB_EXPORT int relops_launch(const float* pos, const float* cell, float* rx, float* rt, int n, cudaStream_t st) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  relops_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(pos, cell, rx, rt, n);
  return static_cast<int>(cudaGetLastError());
}
