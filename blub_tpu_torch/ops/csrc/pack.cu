// Rebin pack for Hopper: the stayers-keep-slots pack, decided then streamed.
//
// Two kernels, both counterparts of blub_tpu/ops/pallas_rebin.py::_pack_core
// (:132):
//   pack_kernel     one axis. Replaces _stage_x_kernel (def :662,
//                   pallas_call :798) and the x pack of the fused
//                   _advect_pack_kernel / _correct_pack_kernel
//                   (pallas_advect.py:927 / :1060); also packs y or z alone.
//                   Its XS instantiation is the with_xs variant of
//                   _stage_x_kernel (:662-668, through _rebin_stage_x
//                   :779-797): an x pack on a halo-extended x-window of the
//                   domain (parallel/sharded_sm.py).
//   pack_yz_kernel  y then z in one launch. Replaces _stage_yz_kernel (def
//                   :688, pallas_call :864): the y stage's output (the
//                   k_mid-slot intermediate) lives in shared memory as one
//                   source byte per slot, and never reaches device memory.
//
// Placement follows the spec (pallas_rebin.py:21-32,
// tests/test_rebin_overflow_spec.py:9-15): stayers with slot q < k_out keep
// slot q; the queue holds the tail stayers, then the slots of offsets
// -s..-1, +1..+s (slots ascending), and fills the empty slots in ascending
// order; the rest is dropped. Target bins are exact integer shifts of the
// rel16 field; movers rebase that field by the offset with unsigned adds on
// the packed channel. Payload moves as int32; empty slots are written as
// exact zeros. Dropped and kept particles are summed per block and added
// with int32 atomicAdd: exact.
//
// What bounds it on the card: bytes. At the dam shape (about 13% of the
// slots valid) an x pack must read the valid word of every input slot
// (K x 4 B a cell, 29 MB) and the other 28 B of the ~0.97M valid slots
// (27 MB), and write the output table once (K_out x 32 B a cell, 252 MB);
// the fused y + z pack reads 31 + 27 MB and writes 235 MB. The stores
// dominate. A pack that decides each output slot inside the loads that
// find it (up to K_in x (2s+1) gated valid/rel loads per thread) and stores
// it from whichever branch placed it writes each output plane in several
// partly masked instructions; y and z as two launches write a 15-slot
// table that the z stage reads straight back.
//
// What this design does about it, per block of cells:
//   1. masks: each source cell of the tile and its +-s halo along the axis
//      reads its K valid words once (coalesced along z, 8 in flight) and
//      the rel word of its valid slots, and keeps 2s+1 slot masks in shared
//      memory: bit q of mask d is set when slot q targets the cell at
//      offset d;
//   2. decide: a thread per output cell places its slots from those masks
//      (bit scans: no loads), writing one code per output slot,
//      (offset index << 5) | source slot in a byte, or EMPTY;
//   3. stream: for every output slot and channel in a fixed order, every
//      thread stores its cell's word (the rebased source word, or 0): one
//      coalesced store per plane row, with no divergent store branches.
// The fused kernel owns whole z rows (all Z cells of `rows` consecutive y
// rows at one x, a contiguous range of cells), so its z stage needs no
// halo: phase 1 places y against the input's y masks and records, for each
// intermediate slot, where it came from and the z masks of the intermediate
// cell (a y rebase leaves rz and the valid bit alone); phase 2 places z
// over shared memory and streams the output, reading each source word from
// the input table with both rebases applied.
//
// Both kernels are templates on the mask word M: uint32_t masks and one-byte
// codes up to 32 slots; uint64_t masks and two-byte codes ((offset index <<
// 6) | slot) up to 64, an instantiation picked at launch only when k_in or
// k_out exceeds 32. Shared memory then grows (up to ~100 KB a block at 64
// slots and s 2), past the 48 KB default: the launch raises the opt-in limit.
#include "pack.cuh"

// One axis. A block owns a tile of tx x ty x tz cells (tiles along x
// vary fastest between consecutive blocks) and keeps the masks of the tile
// and its +-s halo along the axis. counts: dropped, kept. XS (axis x only):
// the table is an x-window whose column 0 is global x plane xs of a domain
// dx planes wide, and target bins clip at the domain's walls
// (_stage_x_kernel's x_off, pallas_rebin.py:191-193, :223-224).
template <typename M, bool XS>
__global__ void __launch_bounds__(PACK_THREADS) pack_kernel(Table t, int k_in, int k_out, int X, int Y, int Z,
                                                            int axis, int s, int tx, int ty, int tz,
                                                            int* __restrict__ counts, int xs, int dx) {
  typedef typename Codes<M>::T C;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nx = (X + tx - 1) / tx, nz = (Z + tz - 1) / tz;
  const int bx = blockIdx.x % nx, bz = (blockIdx.x / nx) % nz, by = blockIdx.x / (nx * nz);
  const int ox = bx * tx, oy = by * ty, oz = bz * tz;
  const int sx = axis == 0 ? s : 0, sy = axis == 1 ? s : 0, sz = axis == 2 ? s : 0;
  const int ey = ty + 2 * sy, ez = tz + 2 * sz;
  const int nh = (tx + 2 * sx) * ey * ez, nt = tx * ty * tz;
  const int dim = axis == 0 ? X : (axis == 1 ? Y : Z);
  M* masks = reinterpret_cast<M*>(smem);
  C* code = reinterpret_cast<C*>(masks + (2 * s + 1) * nh);

  for (int h = threadIdx.x; h < nh; h += blockDim.x) {
    const int gx = ox - sx + h / (ey * ez), gy = oy - sy + (h / ez) % ey, gz = oz - sz + h % ez;
    if (gx < 0 || gx >= X || gy < 0 || gy >= Y || gz < 0 || gz >= Z) {
      for (int j = 0; j <= 2 * s; ++j) masks[j * nh + h] = 0u;
    } else {
      const int g = axis == 0 ? gx : (axis == 1 ? gy : gz);
      if (XS)
        source_masks(t, ((size_t)gx * Y + gy) * Z + gz, k_in, axis, g + xs, dx, s, masks + h, nh);
      else
        source_masks(t, ((size_t)gx * Y + gy) * Z + gz, k_in, axis, g, dim, s, masks + h, nh);
    }
  }
  __syncthreads();

  const int hst = axis == 0 ? ey * ez : (axis == 1 ? ez : 1);
  const long long gst = axis == 0 ? (long long)Y * Z : (axis == 1 ? Z : 1);
  int c[2] = {0, 0};  // dropped, kept
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    const int lx = i / (ty * tz), ly = (i / tz) % ty, lz = i % tz;
    const int gx = ox + lx, gy = oy + ly, gz = oz + lz;
    if (gx >= X || gy >= Y || gz >= Z) continue;
    const int h = ((lx + sx) * ey + ly + sy) * ez + lz + sz;
    const int g = axis == 0 ? gx : (axis == 1 ? gy : gz);
    c[1] += slot_count(decide(masks, nh, h, hst, g, dim, s, k_out, code + i, nt, c[0]));
    const size_t dst = ((size_t)gx * Y + gy) * Z + gz;
    for (int o = 0; o < k_out; ++o) {
      const uint32_t k = code[o * nt + i];
      const int off = (int)(k >> Codes<M>::BITS) - s;
      const uint32_t v = (uint32_t)(off * 8192);
      stream_slot(t, dst, o, k != EMPTY<M>, (size_t)((long long)dst + off * gst), (int)(k & SLOT<M>),
                  axis == 0 ? v << 16 : 0u, axis == 1 ? v : 0u, axis == 2 ? v << 16 : 0u);
    }
  }
  add_counts(counts, c, 2);
}

// y then z. A block owns `rows` consecutive y rows of one x, all Z cells
// each. counts: y dropped, y kept, z dropped, z kept.
template <typename M>
__global__ void __launch_bounds__(PACK_THREADS) pack_yz_kernel(Table t, int k_mid, int k_out, int X, int Y, int Z,
                                                               int s, int rows, int* __restrict__ counts) {
  typedef typename Codes<M>::T C;
  constexpr int BITS = Codes<M>::BITS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nyt = (Y + rows - 1) / rows;
  const int x = blockIdx.x / nyt, y0 = (blockIdx.x % nyt) * rows;
  const int w = 2 * s + 1, nh = (rows + 2 * s) * Z, nt = rows * Z;
  M* ymask = reinterpret_cast<M*>(smem);           // w x nh: the input's y masks, rows y0-s ..
  M* zmask = ymask + w * nh;                       // w x nt: the intermediate's z masks
  C* mid = reinterpret_cast<C*>(zmask + w * nt);  // k_mid x nt: the intermediate, as codes
  C* code = mid + k_mid * nt;                      // k_out x nt: the output, as codes
  const size_t base = ((size_t)x * Y + y0) * Z;                // the tile's first cell

  for (int h = threadIdx.x; h < nh; h += blockDim.x) {
    const int gy = y0 - s + h / Z;
    if (gy < 0 || gy >= Y) {
      for (int j = 0; j < w; ++j) ymask[j * nh + h] = 0u;
    } else {
      source_masks(t, ((size_t)x * Y + gy) * Z + h % Z, k_mid, 1, gy, Y, s, ymask + h, nh);
    }
  }
  __syncthreads();

  int c[4] = {0, 0, 0, 0};  // y dropped, y kept, z dropped, z kept
  // phase 1: the y stage into `mid`, then the z masks of each intermediate cell
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    const int y = y0 + i / Z, z = i % Z;
    if (y >= Y) continue;
    const M filled = decide(ymask, nh, i + s * Z, Z, y, Y, s, k_mid, mid + i, nt, c[0]);
    c[1] += slot_count(filled);
    M zm[MAX_W] = {};
    for (M f = filled; f; f &= f - 1u) {
      const int o = lowest_slot(f);
      const uint32_t k = mid[o * nt + i];
      const int q = (int)(k & SLOT<M>), dy = (int)(k >> BITS) - s;
      const int b1 = t.pin[(size_t)(q * NUM_POSQ + CH_ZV) * t.n + base + i + (long long)dy * Z];
      const int j = bin_shift(hi16(b1), z, Z) + s;
#pragma unroll
      for (int u = 0; u < MAX_W; ++u)
        if (u == j) zm[u] |= (M)1u << o;
    }
#pragma unroll
    for (int u = 0; u < MAX_W; ++u)
      if (u < w) zmask[u * nt + i] = zm[u];
  }
  __syncthreads();

  // phase 2: the z stage, streamed
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    const int y = y0 + i / Z, z = i % Z;
    if (y >= Y) continue;
    c[3] += slot_count(decide(zmask, nt, i, 1, z, Z, s, k_out, code + i, nt, c[2]));
    const size_t dst = base + i;
    for (int o = 0; o < k_out; ++o) {
      const uint32_t k = code[o * nt + i];
      const bool has = k != EMPTY<M>;
      const int dz = (int)(k >> BITS) - s;
      const uint32_t m = has ? mid[(k & SLOT<M>) * nt + i + dz] : 0u;
      const int dy = (int)(m >> BITS) - s;
      stream_slot(t, dst, o, has, (size_t)((long long)dst + dz + (long long)dy * Z), (int)(m & SLOT<M>), 0u,
                  (uint32_t)(dy * 8192), (uint32_t)(dz * 8192) << 16);
    }
  }
  add_counts(counts, c, 4);
}

BLUB_EXPORT int pack_smem_bytes(int k_in, int k_out, int X, int Y, int Z, int axis, int s) {
  return pack_smem(k_in, k_out, X, Y, Z, axis, s);
}

template <typename M, bool XS>
static int pack_run(const Table& t, int* counts, int k_in, int k_out, int X, int Y, int Z, int axis, int s, int xs,
                    int dx, cudaStream_t st) {
  int tx, ty, tz;
  pack_tile(X, Y, Z, axis, &tx, &ty, &tz);
  const int bytes = pack_smem(k_in, k_out, X, Y, Z, axis, s);
  const int err = set_smem(pack_kernel<M, XS>, bytes);
  if (err) return err;
  const int blocks = ((X + tx - 1) / tx) * ((Y + ty - 1) / ty) * ((Z + tz - 1) / tz);
  pack_kernel<M, XS><<<blocks, threads_for(tx * ty * tz), bytes, st>>>(t, k_in, k_out, X, Y, Z, axis, s, tx, ty, tz,
                                                                       counts, xs, dx);
  return static_cast<int>(cudaGetLastError());
}

// 32-bit masks up to 32 slots; the 64-bit instantiation only beyond.
// window != 0 (axis x only): the x-window variant, column 0 at global x
// plane xs of a domain dx planes wide.
BLUB_EXPORT int pack_launch(const int* pin, const int* din, int* pout, int* dout, int* counts, int k_in, int k_out,
                            int X, int Y, int Z, int axis, int s, int window, int xs, int dx, cudaStream_t st) {
  if (k_out < 1 || k_out > 64 || k_in < 1 || k_in > 64 || axis < 0 || axis > 2 || s < 0 || s > MAX_S ||
      (long long)k_in * NUM_POSQ * X * Y * Z > INT32_MAX ||  // the masks' 32-bit offsets
      (window && (axis != 0 || dx < 1 || xs + X <= 0 || xs >= dx)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Table t{pin, din, pout, dout, (size_t)X * Y * Z};
  if (window)
    return wide(k_in, k_out) ? pack_run<uint64_t, true>(t, counts, k_in, k_out, X, Y, Z, axis, s, xs, dx, st)
                             : pack_run<uint32_t, true>(t, counts, k_in, k_out, X, Y, Z, axis, s, xs, dx, st);
  return wide(k_in, k_out) ? pack_run<uint64_t, false>(t, counts, k_in, k_out, X, Y, Z, axis, s, 0, X, st)
                           : pack_run<uint32_t, false>(t, counts, k_in, k_out, X, Y, Z, axis, s, 0, X, st);
}

template <typename M>
static int pack_yz_run(const Table& t, int* counts, int k_mid, int k_out, int X, int Y, int Z, int s,
                       cudaStream_t st) {
  const int rows = yz_rows(Y, Z);
  const int bytes = pack_smem(k_mid, k_out, X, Y, Z, 3, s);
  const int err = set_smem(pack_yz_kernel<M>, bytes);
  if (err) return err;
  pack_yz_kernel<M><<<X * ((Y + rows - 1) / rows), threads_for(rows * Z), bytes, st>>>(t, k_mid, k_out, X, Y, Z,
                                                                                        s, rows, counts);
  return static_cast<int>(cudaGetLastError());
}

BLUB_EXPORT int pack_yz_launch(const int* pin, const int* din, int* pout, int* dout, int* counts, int k_mid,
                               int k_out, int X, int Y, int Z, int s, cudaStream_t st) {
  if (k_out < 1 || k_out > 64 || k_mid < 1 || k_mid > 64 || s < 0 || s > MAX_S ||
      (long long)k_mid * NUM_POSQ * X * Y * Z > INT32_MAX)  // the masks' 32-bit offsets
    return static_cast<int>(cudaErrorInvalidValue);
  const Table t{pin, din, pout, dout, (size_t)X * Y * Z};
  return wide(k_mid, k_out) ? pack_yz_run<uint64_t>(t, counts, k_mid, k_out, X, Y, Z, s, st)
                            : pack_yz_run<uint32_t>(t, counts, k_mid, k_out, X, Y, Z, s, st);
}
