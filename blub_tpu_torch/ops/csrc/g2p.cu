// G2P for Hopper: APIC advection and density position correction per slot.
// Replaces the G2P half of the TPU kernels
// blub_tpu/ops/pallas_advect.py::_advect_pack_kernel (def :927, pallas_call
// :1042) and _correct_pack_kernel (:1060 / :1159); their x-pack is the pack
// kernel along x (pack.cu). Also covers _advect_kernel (:294 / :667) and
// _correct_kernel (:514 / :706), the unfused variants. Advect comes in both
// with_solids specialisations of the TPU kernels (template WITH_SOLIDS).
// Template XS is the with_xs variant of all four (pallas_advect.py:308-310,
// :516-518, :1067-1070): the grid is an x-window of the domain (a mesh
// shard extended by its halo, parallel/sharded_sm.py) whose column 0 is
// global x plane xs. Positions and cell coordinates are then global
// (:363-368, :560-562), the wall clamps and the out-of-domain test take the
// domain's dims, the new rel16 cell is the slot's own window cell (the rel
// field does not depend on the frame), and x reads stay cyclic over the
// window, whose halo planes the caller fills from the neighbours (wrapping
// at the domain's ends, as the whole grid's cyclic reads do). XS false
// compiles to the code the kernel had before the flag.
//
// Math as in sim/sm_phases.advect_slot_major / correct_slot_major. Grid
// reads, occupancy included, follow its rolls (jnp.roll): cyclic along x
// and y, and along z over the lane-padded extent Zp = max(128, 128k) >= Z
// of the JAX table, whose planes past Z read 0 (slot_major.zpad); so z = -1
// and z = Z read 0 unless Z is a multiple of 128, where z is cyclic. With
// solids a particle whose primal cell is occupied first escapes one cell
// along the dominant axis of the solid velocity there, in its sign; a
// target cell (offset clipped to +-2) that is occupied counts as
// penetration like leaving the domain; and a particle that penetrates
// without leaving its cell also takes the push
// dt*50 * trilinear(0.5*(occ[g-e_a] - occ[g+e_a])) at its escaped xi
// (pallas_advect.py:417-478, _push_force :257). Positions store with rintf
// (round half to even, as quantize_pos); velocities and affine rows as bf16
// pairs with __float2bfloat16_rn, -0.0 turned into +0.0 before packing.
// Built with -fmad=false so every product and sum rounds as in the plain
// version. max |v|^2 is reduced per block and folded with atomicMax on the
// int bits of a non-negative float: deterministic.
//
// What bounds it on the card: bytes. At the dam shape (about 13% of the
// slots valid) advect must read the valid word of every slot (29 MB) and the
// other posq word of the valid ones (4 MB), and write posq + dyn in full (235
// MB); the face grids (6 MB) stay in L2. Correct reads the same 33 MB and
// writes posq (59 MB). The arithmetic is about 600 (advect) and 200
// (correct) f32 operations per valid slot, a small fraction of the card's
// rate, but with the address and clamp work some 1000 instructions a valid
// slot, issued while the stores stream. The solids specialisation adds the
// occupancy and 3 solid-velocity grids (8 MB, in L2) and about 130
// operations per valid slot.
//
// The design, after the TPU kernel's blocks: a block owns a tile of 128
// cells (one x plane, rows of up to 64 z columns; one thread per cell, the
// index from blockIdx and threadIdx) and every slot plane of it. In chunks
// of 32 slots each thread reads its cell's valid words (16 in flight) into
// a mask, and the block ORs the masks: a slot valid nowhere in the tile is
// a zero plane row, stored by the whole block (16-byte stores when the tile
// is whole z rows), so a tile with no particle (the TPU's has_particles)
// only writes zeros. The slots valid somewhere are walked in ascending
// order, each thread computing its cell's slot or storing its zeros: one
// coalesced row per plane. The posq words of a thread's next valid slot are
// loaded while it computes one (the xy word of an empty slot is never read).
// The 24 face corners of a slot are read through L1 and L2 at offsets
// wrapped once per cell (the three wrapped coordinates of each axis), so a
// corner costs two adds and a select; windows staged in shared memory per
// tile measured slower on the H100 (their loads cost more than the L1 hits
// they save), and so did fewer registers forced by launch bounds (spills).
// 32-bit offsets keep the advect at 95 registers, the occupancy it needs.
#include "g2p.cuh"

// ADVECT: posq + dyn out and max |v|^2; else correct: posq out. XS: the
// grid is an x-window whose column 0 is global x plane xs, and gm holds the
// domain's wall clamps.
template <bool ADVECT, bool WITH_SOLIDS, bool XS>
__global__ void __launch_bounds__(G2P_THREADS) g2p_kernel(const int* __restrict__ posq, Src src,
                                                          int* __restrict__ out_p, int* __restrict__ out_d,
                                                          int* __restrict__ max_sq, float dt, int K, Grid d, Gmax gm,
                                                          int ty, int tz, int xs) {
  __shared__ uint32_t tile_or;
  __shared__ float red[32];
  const Tile t = tile_of(d, ty, tz);
  const bool vec = tz == d.Z && d.Z % 4 == 0;
  float vsq = 0.f;
  for (int q0 = 0; q0 < K; q0 += 32) {
    const int kq = min(32, K - q0);
    const uint32_t m = chunk_mask(posq, t, q0, kq);
    if (threadIdx.x == 0) tile_or = 0u;
    __syncthreads();
    const uint32_t tor = block_or(m, &tile_or);
    // slots valid nowhere in the tile: zero plane rows, by the whole block
    for (int u = 0; u < kq; ++u) {
      if ((tor >> u) & 1u) continue;
      zero_planes(out_p + (q0 + u) * NUM_POSQ * t.n, NUM_POSQ, t, vec);
      if (ADVECT) zero_planes(out_d + (q0 + u) * NUM_DYN * t.n, NUM_DYN, t, vec);
    }
    // the slots valid somewhere in the tile, ascending: each thread computes
    // its cell's slot (or takes zeros), then the block stores one coalesced
    // row per plane; the posq words of a thread's next valid slot are loaded
    // while it computes one
    uint32_t mine = m;
    int nb[2] = {0, 0};
    if (mine) next_words(posq, t, q0 + lowest_slot(mine), nb);
    for (uint32_t r = tor; r; r &= r - 1u) {
      const int u = lowest_slot(r), q = q0 + u;
      if (!t.in) continue;
      int w[NUM_POSQ + NUM_DYN] = {};
      if ((m >> u) & 1u) {
        const int b0 = nb[0], b1 = nb[1];
        mine &= mine - 1u;  // u was its lowest
        if (mine) next_words(posq, t, q0 + lowest_slot(mine), nb);
        if constexpr (ADVECT)
          vsq = fmaxf(vsq, advect_slot<WITH_SOLIDS, XS>(src, t, b0, b1, dt, gm.v, xs, w));
        else
          correct_slot<XS>(src, t, b0, b1, gm.v, xs, w);
      }
      for (int c = 0; c < NUM_POSQ; ++c) out_p[(q * NUM_POSQ + c) * t.n + t.cell] = w[c];
      if (ADVECT)
        for (int c = 0; c < NUM_DYN; ++c) out_d[(q * NUM_DYN + c) * t.n + t.cell] = w[NUM_POSQ + c];
    }
    __syncthreads();  // tile_or is reset for the next chunk
  }
  if (ADVECT) {
    const float mx = block_reduce(vsq, MaxOp(), red);
    if (threadIdx.x == 0 && mx > 0.f) atomicMax(max_sq, __float_as_int(mx));
  }
}

// tile: up to 64 z columns, rows to G2P_THREADS cells
static void g2p_tile(int Y, int Z, int* ty, int* tz) {
  *tz = Z < 64 ? Z : 64;
  *ty = G2P_THREADS / *tz < Y ? G2P_THREADS / *tz : Y;
}

// The window (X, Y, Z) of the domain (DX, DY, DZ) whose column 0 is global x
// plane xs; the whole grid when XS is false (xs 0, the domain the window).
template <bool ADVECT, bool WITH_SOLIDS, bool XS>
static int g2p_run(const int* posq, const Src& src, int* out_p, int* out_d, int* max_sq, float dt, int K, int X, int Y,
                   int Z, int xs, int DX, int DY, int DZ, cudaStream_t st) {
  int ty, tz;
  g2p_tile(Y, Z, &ty, &tz);
  const Grid d{X, Y, Z, Z < 128 ? 128 : (Z + 127) / 128 * 128};  // slot_major.zpad
  const Gmax gm{{(float)((double)DX - 1.001), (float)((double)DY - 1.001), (float)((double)DZ - 1.001)}};
  const int blocks = X * ((Y + ty - 1) / ty) * ((Z + tz - 1) / tz);
  g2p_kernel<ADVECT, WITH_SOLIDS, XS><<<blocks, (ty * tz + 31) / 32 * 32, 0, st>>>(posq, src, out_p, out_d, max_sq, dt,
                                                                                K, d, gm, ty, tz, xs);
  return static_cast<int>(cudaGetLastError());
}

// 32-bit offsets: every word of the tables must be addressable by an int;
// a cyclic read wraps by at most one grid length (z by one padded length).
// A window lies inside its domain along x and spans it along y and z.
static bool g2p_args_ok(int K, int X, int Y, int Z, int window, int xs, int DX, int DY, int DZ) {
  if (window && (DY != Y || DZ != Z || DX < 2 || xs + X <= 0 || xs >= DX)) return false;
  return K >= 1 && X >= 2 && Y >= 2 && Z >= 2 && (long long)K * (NUM_POSQ + NUM_DYN) * X * Y * Z <= INT32_MAX;
}

// occ == nullptr selects the specialisation without solids; window != 0 the
// x-window variant (column 0 at global x plane xs of a DX x DY x DZ domain)
BLUB_EXPORT int g2p_advect_launch(const int* posq, const float* v0, const float* v1, const float* v2,
                                  const float* occ, const float* sv0, const float* sv1, const float* sv2,
                                  int* out_p, int* out_d, int* max_sq, float dt, int K, int X, int Y, int Z,
                                  int window, int xs, int DX, int DY, int DZ, cudaStream_t st) {
  if (!g2p_args_ok(K, X, Y, Z, window, xs, DX, DY, DZ)) return static_cast<int>(cudaErrorInvalidValue);
  const Src src{{v0, v1, v2}, occ, {sv0, sv1, sv2}, nullptr};
  if (window)
    return occ != nullptr
               ? g2p_run<true, true, true>(posq, src, out_p, out_d, max_sq, dt, K, X, Y, Z, xs, DX, DY, DZ, st)
               : g2p_run<true, false, true>(posq, src, out_p, out_d, max_sq, dt, K, X, Y, Z, xs, DX, DY, DZ, st);
  return occ != nullptr ? g2p_run<true, true, false>(posq, src, out_p, out_d, max_sq, dt, K, X, Y, Z, 0, X, Y, Z, st)
                        : g2p_run<true, false, false>(posq, src, out_p, out_d, max_sq, dt, K, X, Y, Z, 0, X, Y, Z, st);
}

BLUB_EXPORT int g2p_correct_launch(const int* posq, const float* c0, const float* c1, const float* c2,
                                   const int8_t* marker, int* out_p, int K, int X, int Y, int Z, int window, int xs,
                                   int DX, int DY, int DZ, cudaStream_t st) {
  if (!g2p_args_ok(K, X, Y, Z, window, xs, DX, DY, DZ)) return static_cast<int>(cudaErrorInvalidValue);
  const Src src{{c0, c1, c2}, nullptr, {nullptr, nullptr, nullptr}, marker};
  if (window)
    return g2p_run<false, false, true>(posq, src, out_p, nullptr, nullptr, 0.f, K, X, Y, Z, xs, DX, DY, DZ, st);
  return g2p_run<false, false, false>(posq, src, out_p, nullptr, nullptr, 0.f, K, X, Y, Z, 0, X, Y, Z, st);
}
