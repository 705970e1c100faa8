// P2G gather for Hopper. Replaces the TPU kernel
// blub_tpu/ops/pallas_p2g.py::_kernel (def :82, pallas_call :396; entries
// p2g_raw_accumulators :458 and p2g_density_pallas :432).
//
// Each cell sums over the 20 union-window offsets (8 in density mode) and,
// within each, the valid slots of the neighbouring dual bin in ascending
// order: the sums are deterministic with no atomics. Positions downstream
// are quantized, so summation order would show; the order and every
// expression are the plain version's (ops/p2g.py::p2g_plain), and with
// -fmad=false the result is bit for bit the same.
//
// What bounds it on the card: bytes at the bound (at the dam shape, 128x64x64,
// K=14, about 13% of the slots valid, a call must read the valid word of
// every slot, 29 MB, the rest of each valid slot, 28 B in velocity mode and
// 4 B in density mode for ~0.97M particles, and write 7 (2) f32 grids). In
// practice it is the traffic from L2: each particle's words are read once
// for every cell whose window holds it (20 in velocity mode), and the lines
// of the slot-major table (one slot plane, 32 cells of one channel) do not
// stay in L1 between those reads. A walk over 20 offsets x K slots per
// cell with a gated global load of each slot's valid word (280 loads a
// cell at K=14, ~87 % of them empty) before the particle's loads adds two
// round trips a slot, and a warp runs the whole decode for nearly every
// slot.
//
// This design: a block owns a ty x tz tile of one x plane (tz up to 64, z
// contiguous) and builds the K-bit valid mask of every cell of the tile and
// its one-cell halo in the three planes x-1..x+1 once, from coalesced reads
// of the K valid words, in shared memory: about 3 K valid-word loads a cell
// instead of 20 K. The masks are 32-bit words up to 32 slots and 64-bit ones
// up to 64 (a second instantiation, picked at launch only for K > 32). Each
// cell then visits, for each window offset in order, its neighbour's valid
// slots in ascending order, loading posq and dyn only for them. The warp walks the union of its lanes' masks in lockstep (a
// warp-wide OR), so every load reads one slot plane of consecutive cells;
// a lane whose neighbour lacks the slot skips it. Measured on the H100, a
// walk of each lane's own slots (uncoalesced), a split of the channels over
// three threads, several slots loaded at once in velocity mode, x runs of
// more than one plane per block and source rows staged in shared memory
// were all slower.
#include <algorithm>

#include "common.cuh"

#define P2G_THREADS 256

struct Terms {
  float w[3], val[3];  // velocity mode: Shepard weights and APIC values; density mode: w[0]
  float prim;          // primal-cell fluid count
};

// p2g_plain's clamp(1 - |d|, 0, 1) for the finite d here (decoded from
// rel16 integers): the upper clamp never binds, so one max gives its bits
__device__ __forceinline__ float tent(float d) { return fmaxf(1.f - fabsf(d), 0.f); }

// The terms one particle adds to the cell's sums, at window offset ox, oy,
// oz; p and d point at its slot's first posq and dyn words (channels n
// apart). The expressions of p2g_plain. Nothing is loaded when !has (the
// terms are then not added).
template <bool DENSITY>
__device__ __forceinline__ Terms particle_terms(const int* __restrict__ p, const int* __restrict__ dp, int n,
                                                bool has, int ox, int oy, int oz) {
  Terms t;
  int b0 = 0, b1 = 0, d[NUM_DYN] = {};
  if (has) {
    b0 = p[CH_XY * n];
    b1 = p[CH_ZV * n];
    if (!DENSITY) {
#pragma unroll
      for (int c = 0; c < NUM_DYN; ++c) d[c] = dp[c * n];
    }
  }
  const int rx = hi16(b0), ry = sext16(b0), rz = hi16(b1);
  const float dx5 = (-0.5f - (float)ox) - (float)rx * POS_INV;
  const float dy5 = (-0.5f - (float)oy) - (float)ry * POS_INV;
  const float dz5 = (-0.5f - (float)oz) - (float)rz * POS_INV;
  const float fx5 = tent(dx5);
  const float fy5 = tent(dy5);
  const float fz5 = tent(dz5);
  if (DENSITY) {
    t.w[0] = fx5 * fy5 * fz5;
  } else {
    const float dx1 = dx5 + 0.5f, dy1 = dy5 + 0.5f, dz1 = dz5 + 0.5f;
    const float fx1 = tent(dx1);
    const float fy1 = tent(dy1);
    const float fz1 = tent(dz1);
    t.w[0] = fx1 * (fy5 * fz5);
    t.w[1] = fx5 * (fy1 * fz5);
    t.w[2] = (fx5 * fy5) * fz1;
    const float vel[3] = {unpack_hi(d[0]), unpack_lo(d[0]), unpack_hi(d[1])};
    const float aff[9] = {unpack_lo(d[1]), unpack_hi(d[2]), unpack_lo(d[2]),
                          unpack_hi(d[3]), unpack_lo(d[3]), unpack_hi(d[4]),
                          unpack_lo(d[4]), unpack_hi(d[5]), unpack_lo(d[5])};
    const float ds[3][3] = {{dx1, dy5, dz5}, {dx5, dy1, dz5}, {dx5, dy5, dz1}};
#pragma unroll
    for (int c = 0; c < 3; ++c)
      t.val[c] = t.w[c] * (vel[c] + aff[3 * c] * ds[c][0] + aff[3 * c + 1] * ds[c][1] + aff[3 * c + 2] * ds[c][2]);
  }
  const bool prim = (ox ? rx >= 0 : rx < 0) && (oy ? ry >= 0 : ry < 0) && (oz ? rz >= 0 : rz < 0);
  t.prim = prim ? 1.f : 0.f;
  return t;
}

template <bool DENSITY>
__device__ __forceinline__ void add_terms(float* acc, const Terms& t, bool nonpos) {
  if (DENSITY) {
    acc[0] = acc[0] + t.w[0];
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[c] = acc[c] + t.w[c];
      acc[3 + c] = acc[3 + c] + t.val[c];
    }
  }
  if (nonpos) acc[DENSITY ? 1 : 6] = acc[DENSITY ? 1 : 6] + t.prim;
}

// One thread per cell of the tile (blockDim.x = the tile's cells rounded up
// to a warp; every lane runs the walk, lanes outside the grid with empty
// masks, so the warp-wide mask OR sees all 32). B: slots loaded together
// before their terms are added, in order. M: the mask word, uint32_t up to
// 32 slots, uint64_t up to 64.
template <bool DENSITY, int B, typename M>
__global__ void __launch_bounds__(P2G_THREADS) p2g_kernel(const int* __restrict__ posq, const int* __restrict__ dyn,
                                                          float* __restrict__ out, int K, int X, int Y, int Z,
                                                          int ty, int tz) {
  extern __shared__ __align__(16) unsigned char smem[];
  M* masks = reinterpret_cast<M*>(smem);  // planes x-1, x, x+1 of (ty + 2) x (tz + 2) cells
  const int ez = tz + 2, np = (ty + 2) * ez;
  const int nz = (Z + tz - 1) / tz;
  const int x = blockIdx.x % X, z0 = (blockIdx.x / X) % nz * tz, y0 = blockIdx.x / (X * nz) * ty;
  const int n = X * Y * Z;
  const int i = threadIdx.x, y = y0 + i / tz, z = z0 + i % tz;
  const bool in = i < ty * tz && y < Y && z < Z;
  const int h = np + (i / tz + 1) * ez + i % tz + 1;  // the cell's mask in plane x

  for (int j = threadIdx.x; j < 3 * np; j += blockDim.x) {
    const int gx = x - 1 + j / np, gy = y0 - 1 + (j % np) / ez, gz = z0 - 1 + j % ez;
    M v = 0u;
    if (gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z) {
      const int* p = posq + (gx * Y + gy) * Z + gz + CH_ZV * n;
      for (int q = 0; q < K; ++q) v |= (M)(p[q * NUM_POSQ * n] & 1) << q;
    }
    masks[j] = v;
  }
  __syncthreads();

  const int cell = (x * Y + y) * Z + z;
  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ox = -1; ox <= 1; ++ox)
#pragma unroll
    for (int oy = -1; oy <= 1; ++oy)
#pragma unroll
      for (int oz = -1; oz <= 1; ++oz) {
        if ((ox == 1) + (oy == 1) + (oz == 1) > 1) continue;  // union window
        const bool nonpos = ox <= 0 && oy <= 0 && oz <= 0;
        if (DENSITY && !nonpos) continue;  // density window {-1,0}^3
        const M m = in ? masks[h + ox * np + oy * ez + oz] : (M)0u;
        const int src = cell + (ox * Y + oy) * Z + oz;
        const int* pq = posq + src;
        const int* dq = dyn + src;
        // the warp walks the union of its lanes' slots in lockstep, so a
        // load touches one slot plane; each lane adds its own, ascending
        M u = warp_or(m);
        while (u) {
          int q[B];
          bool has[B];
          Terms t[B];
#pragma unroll
          for (int b = 0; b < B; ++b) {
            q[b] = u ? lowest_slot(u) : 0;
            has[b] = u && ((m >> q[b]) & 1u);
            u &= u - 1u;
          }
#pragma unroll
          for (int b = 0; b < B; ++b)
            t[b] = particle_terms<DENSITY>(pq + q[b] * (NUM_POSQ * n), dq + q[b] * (NUM_DYN * n), n, has[b], ox, oy,
                                           oz);
#pragma unroll
          for (int b = 0; b < B; ++b)
            if (has[b]) add_terms<DENSITY>(acc, t[b], nonpos);
        }
      }
  if (in) {
#pragma unroll
    for (int c = 0; c < (DENSITY ? 2 : 7); ++c) out[c * n + cell] = acc[c];
  }
}

static void p2g_tile(int Y, int Z, int* ty, int* tz) {
  *tz = std::min(Z, 64);
  *ty = std::min(Y, std::max(1, P2G_THREADS / *tz));
}

BLUB_EXPORT int p2g_smem_bytes(int K, int Y, int Z) {
  int ty, tz;
  p2g_tile(Y, Z, &ty, &tz);
  return 3 * (ty + 2) * (tz + 2) * (K > 32 ? 8 : 4);
}

template <typename M>
static void p2g_run(const int* posq, const int* dyn, float* out, int K, int X, int Y, int Z, int density,
                    cudaStream_t stream) {
  int ty, tz;
  p2g_tile(Y, Z, &ty, &tz);
  const int blocks = X * ((Y + ty - 1) / ty) * ((Z + tz - 1) / tz);
  const int threads = (ty * tz + 31) / 32 * 32;
  const int bytes = p2g_smem_bytes(K, Y, Z);
  if (density)
    p2g_kernel<true, 2, M><<<blocks, threads, bytes, stream>>>(posq, dyn, out, K, X, Y, Z, ty, tz);
  else
    p2g_kernel<false, 1, M><<<blocks, threads, bytes, stream>>>(posq, dyn, out, K, X, Y, Z, ty, tz);
}

// 32-bit masks up to 32 slots; the 64-bit instantiation only beyond
BLUB_EXPORT int p2g_launch(const int* posq, const int* dyn, float* out, int K, int X, int Y, int Z,
                           int density, cudaStream_t stream) {
  // 32-bit offsets: every word of the table must be addressable by an int
  if (K < 1 || K > 64 || (long long)K * (NUM_POSQ + NUM_DYN) * X * Y * Z > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K > 32)
    p2g_run<uint64_t>(posq, dyn, out, K, X, Y, Z, density, stream);
  else
    p2g_run<uint32_t>(posq, dyn, out, K, X, Y, Z, density, stream);
  return static_cast<int>(cudaGetLastError());
}
