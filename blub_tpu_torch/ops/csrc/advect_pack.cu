// Fused G2P + x pack for Hopper: advection (or density position correction)
// and the x stage of the rebin in one kernel, the moved table never written.
//
// Replaces blub_tpu/ops/pallas_advect.py::_advect_pack_kernel (def :927,
// pallas_call :1042) with both with_solids specialisations (template
// WITH_SOLIDS), and _correct_pack_kernel (:1060 / :1159); template XS is the
// with_xs variant of both (:1067-1070, through the x_start of _advect_block
// and _correct_block): the table is an x-window of the domain whose column 0
// is global x plane xs (a mesh slab extended by its halo,
// parallel/sharded_sm.py). Each computes what G2P (g2p.cu's kernel) followed
// by the x pack (pack.cu's pack_kernel along x) computes, bit for bit: the
// same per-slot math (g2p.cuh) and the same masks, decisions and stream
// (pack.cuh), so the moved posq, dyn and x bins are those of the two
// launches, and so are the placement (stayers keep slots; the queue of tail
// stayers, then offsets -s..-1, +1..+s, fills the empty slots in order),
// the dropped and kept counts and, for advect, max |v|^2 (f32 bits, folded
// with atomicMax on the int bits). Built with -fmad=false like every source.
//
// What bounds it on the card: bytes. At the dam shape (K 14, k_out 15,
// 524,288 cells, about 13 % of the slots valid) advect + x pack must read the
// valid word of every input slot (29 MB) and the other posq word of the
// valid ones (4 MB), and write the k_out-slot table once (252 MB); the face
// grids (6 MB) stay in L2. Correct + x pack reads the same posq words and the
// dyn words of the valid slots (23 MB) and writes the same 252 MB. The two
// launches it replaces also write the moved K-slot table (posq + dyn: 235
// MB) and read it back (56 MB): the fused bound is about 0.18 ms a dam
// substep for both phases against 0.29 for the pairs.
//
// The design: a block owns pack_kernel's x tile (16 x planes, rows of 32 z
// cells, 512 cells) and its +-s halo planes, and keeps only what the pack
// keeps in shared memory: 2s+1 slot masks per cell of the extended tile and
// one placement code per output slot of the tile.
//   1. masks: a thread per cell of the extended tile evaluates G2P on each
//      valid slot of its cell (the valid words 16 in flight, g2p.cuh's
//      chunk_mask) and sets the slot's bit in the mask of its moved x bin;
//      advect folds |v|^2 of these slots into the block's max (the halo's
//      slots are some other block's core: max is idempotent);
//   2. decide: a thread per output cell places its slots (pack.cuh's
//      decide: bit scans over the masks, no loads);
//   3. stream: the same thread writes each output slot, evaluating G2P again
//      for a placed slot at its source cell (advect: its posq and dyn words;
//      correct: its posq words, dyn read from the input table) and rebasing
//      its x rel16 field by the offset, or writing zeros: one coalesced store
//      per plane row.
// This is JAX's choice (a), the G2P recomputed on the halo planes, taken one
// step further: the moved slots are not kept, so G2P runs (16 + 2s) / 16 + 1
// times per valid slot (2.25 for advect, 2.125 for correct). Writing the
// tile's stayers from pass 1 instead (the warp walking its lanes' valid
// slots in lockstep, so that only the movers run G2P again) measured slower
// on the H100 at the dam shape: 0.261 against 0.234 ms device for advect,
// 0.248 against 0.197 for correct (106 registers against 80; the pass-1
// stores land a few lanes at a time). Keeping the moved slots does not fit
// where it must (32 bytes a slot; KiB below are 1024 bytes):
// the extended tile's moved slots take 280 KiB at K 14 and 480 KiB at K 24
// (a 4-plane tile still 112 and 192 KiB, one block per SM and half its G2P
// on halo planes); choice (b), a (y, z) tile of one warp's 32 cells marching
// along x with a ring of 2s+1 planes of moved slots, takes 70 KiB at K 14
// (dam, highres), 120 KiB at K 24 (wave) and 320 KiB at 64 slots, which fits
// no block, and leaves 1-3 blocks per SM each waiting on a barrier per
// plane. Masks and codes take pack x's shared memory: 20 KiB at K 14 and
// 24 (32-bit masks, s 2), 66 KiB at 40 slots, 89 KiB at 64 (64-bit masks,
// two-byte codes), 102.5 KiB at 64 slots and s 3: every table the card's
// packs take fits in the 227 KiB a block may hold, so the step needs no
// shape gate (JAX's fused_supports) and no unfused branch. G2P's arithmetic
// is a small share of the card's rate (g2p.cu); its second evaluation is
// issued while the stores stream.
#include "g2p.cuh"
#include "pack.cuh"

// What a fused kernel reads and writes: the input table (posq; correct also
// dyn, the payload it moves unchanged), the grids G2P reads, the k_out-slot
// output table; the window d (the whole grid when XS is false) with the
// domain's wall clamps gm, and, XS, the window's x origin xs in a domain dx
// planes wide.
struct Fused {
  const int* posq;
  const int* dyn;
  Table out;  // out.pout / out.dout / out.n: the output table (pin, din unused)
  Src src;
  Grid d;
  Gmax gm;
  float dt;
  int xs, dx;
};

// The moved words of the slot (posq words b) of t's cell: advect its posq and
// dyn words, correct its posq words; -> |v|^2 (advect), else 0.
template <bool ADVECT, bool WITH_SOLIDS, bool XS>
__device__ __forceinline__ float moved(const Fused& f, const Tile& t, const int b[2], int w[NUM_POSQ + NUM_DYN]) {
  if constexpr (ADVECT) {
    return advect_slot<WITH_SOLIDS, XS>(f.src, t, b[0], b[1], f.dt, f.gm.v, f.xs, w);
  } else {
    correct_slot<XS>(f.src, t, b[0], b[1], f.gm.v, f.xs, w);
    return 0.f;
  }
}

// G2P on the tile (tx x ty x tz cells of the window, tiles along x fastest)
// then the x pack of its cells (k_in -> k_out slots, reach s). counts:
// dropped, kept; max_sq: max |v|^2 (advect).
template <typename M, bool ADVECT, bool WITH_SOLIDS, bool XS>
__global__ void __launch_bounds__(PACK_THREADS) fused_kernel(Fused f, int k_in, int k_out, int s, int tx, int ty,
                                                             int tz, int* __restrict__ counts,
                                                             int* __restrict__ max_sq) {
  typedef typename Codes<M>::T C;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  const int X = f.d.X, Y = f.d.Y, Z = f.d.Z;
  const int nx = (X + tx - 1) / tx, nz = (Z + tz - 1) / tz;
  const int bx = blockIdx.x % nx, bz = (blockIdx.x / nx) % nz, by = blockIdx.x / (nx * nz);
  const int ox = bx * tx, oy = by * ty, oz = bz * tz;
  const int plane = ty * tz, nh = (tx + 2 * s) * plane, nt = tx * plane;
  M* masks = reinterpret_cast<M*>(smem);
  C* code = reinterpret_cast<C*>(masks + (2 * s + 1) * nh);
  Tile t;
  t.d = f.d;

  // 1. masks of the tile and its +-s planes, from the moved x bins
  float vsq = 0.f;
  for (int h = threadIdx.x; h < nh; h += blockDim.x) {
    const int gx = ox - s + h / plane, gy = oy + (h / tz) % ty, gz = oz + h % tz;
    M w[MAX_W] = {};
    if (gx >= 0 && gx < X && gy < Y && gz < Z) {
      locate(t, gx, gy, gz);
      t.in = true;
      for (int q0 = 0; q0 < k_in; q0 += 32) {
        const uint32_t vm = chunk_mask(f.posq, t, q0, min(32, k_in - q0));
        for (uint32_t r = vm; r; r &= r - 1u) {
          const int q = q0 + lowest_slot(r);
          int b[2], mw[NUM_POSQ + NUM_DYN];
          next_words(f.posq, t, q, b);
          vsq = fmaxf(vsq, moved<ADVECT, WITH_SOLIDS, XS>(f, t, b, mw));
          const int j = (XS ? bin_shift(hi16(mw[CH_XY]), gx + f.xs, f.dx) : bin_shift(hi16(mw[CH_XY]), gx, X)) + s;
#pragma unroll
          for (int i = 0; i < MAX_W; ++i)
            if (i == j) w[i] |= (M)1u << q;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_W; ++i)
      if (i <= 2 * s) masks[i * nh + h] = w[i];
  }
  __syncthreads();

  // 2. decide and 3. stream, a thread per output cell
  int c[2] = {0, 0};  // dropped, kept
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    const int lx = i / plane, ly = (i / tz) % ty, lz = i % tz;
    const int gx = ox + lx, gy = oy + ly, gz = oz + lz;
    if (gx >= X || gy >= Y || gz >= Z) continue;
    c[1] += slot_count(decide(masks, nh, i + s * plane, plane, gx, X, s, k_out, code + i, nt, c[0]));
    const size_t dst = ((size_t)gx * Y + gy) * Z + gz;
    for (int o = 0; o < k_out; ++o) {
      const uint32_t k = code[o * nt + i];
      int w[NUM_POSQ + NUM_DYN] = {};
      if (k != EMPTY<M>) {
        const int off = (int)(k >> Codes<M>::BITS) - s, q = (int)(k & SLOT<M>);
        int b[2];
        locate(t, gx + off, gy, gz);
        next_words(f.posq, t, q, b);
        moved<ADVECT, WITH_SOLIDS, XS>(f, t, b, w);
        if constexpr (!ADVECT) {
#pragma unroll
          for (int ch = 0; ch < NUM_DYN; ++ch) w[NUM_POSQ + ch] = f.dyn[(q * NUM_DYN + ch) * t.n + t.cell];
        }
        w[CH_XY] = (int)((uint32_t)w[CH_XY] + ((uint32_t)(off * 8192) << 16));
      }
      store_slot(f.out, dst, o, w);
    }
  }
  add_counts(counts, c, 2);
  if (ADVECT) {
    const float mx = block_reduce(vsq, MaxOp(), red);
    if (threadIdx.x == 0 && mx > 0.f) atomicMax(max_sq, __float_as_int(mx));
  }
}

template <typename M, bool ADVECT, bool WITH_SOLIDS, bool XS>
static int fused_run(const Fused& f, int* counts, int* max_sq, int k_in, int k_out, int s, cudaStream_t st) {
  int tx, ty, tz;
  pack_tile(f.d.X, f.d.Y, f.d.Z, 0, &tx, &ty, &tz);
  const int bytes = pack_smem(k_in, k_out, f.d.X, f.d.Y, f.d.Z, 0, s);
  const int err = set_smem(fused_kernel<M, ADVECT, WITH_SOLIDS, XS>, bytes);
  if (err) return err;
  const int blocks = ((f.d.X + tx - 1) / tx) * ((f.d.Y + ty - 1) / ty) * ((f.d.Z + tz - 1) / tz);
  fused_kernel<M, ADVECT, WITH_SOLIDS, XS><<<blocks, threads_for(tx * ty * tz), bytes, st>>>(f, k_in, k_out, s, tx, ty,
                                                                                              tz, counts, max_sq);
  return static_cast<int>(cudaGetLastError());
}

template <bool ADVECT, bool WITH_SOLIDS, bool XS>
static int fused_pick(const Fused& f, int* counts, int* max_sq, int k_in, int k_out, int s, cudaStream_t st) {
  return wide(k_in, k_out) ? fused_run<uint64_t, ADVECT, WITH_SOLIDS, XS>(f, counts, max_sq, k_in, k_out, s, st)
                           : fused_run<uint32_t, ADVECT, WITH_SOLIDS, XS>(f, counts, max_sq, k_in, k_out, s, st);
}

// The window (X, Y, Z) at global x plane xs of the domain (DX, DY, DZ) when
// window != 0, else the whole grid; slots and reach the packs' (up to 64 and
// 3); every word of the tables addressable by an int (32-bit offsets).
static int fused_setup(Fused& f, int k_in, int k_out, int s, int X, int Y, int Z, int window, int xs, int DX, int DY,
                       int DZ) {
  const int kk = k_in > k_out ? k_in : k_out;
  if (k_in < 1 || k_in > 64 || k_out < 1 || k_out > 64 || s < 0 || s > MAX_S || X < 2 || Y < 2 || Z < 2 ||
      (long long)kk * (NUM_POSQ + NUM_DYN) * X * Y * Z > INT32_MAX ||
      (window && (DY != Y || DZ != Z || DX < 2 || xs + X <= 0 || xs >= DX)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!window) {
    xs = 0;
    DX = X, DY = Y, DZ = Z;
  }
  f.d = Grid{X, Y, Z, Z < 128 ? 128 : (Z + 127) / 128 * 128};  // slot_major.zpad
  f.gm = Gmax{{(float)((double)DX - 1.001), (float)((double)DY - 1.001), (float)((double)DZ - 1.001)}};
  f.out.n = (size_t)X * Y * Z;
  f.xs = xs;
  f.dx = DX;
  return 0;
}

// occ == nullptr selects the specialisation without solids
BLUB_EXPORT int advect_pack_launch(const int* posq, const float* v0, const float* v1, const float* v2,
                                   const float* occ, const float* sv0, const float* sv1, const float* sv2,
                                   int* out_p, int* out_d, int* counts, int* max_sq, float dt, int k_in, int k_out,
                                   int s, int X, int Y, int Z, int window, int xs, int DX, int DY, int DZ,
                                   cudaStream_t st) {
  Fused f{posq, nullptr, Table{nullptr, nullptr, out_p, out_d, 0}, Src{{v0, v1, v2}, occ, {sv0, sv1, sv2}, nullptr},
          Grid{}, Gmax{}, dt, 0, 0};
  const int err = fused_setup(f, k_in, k_out, s, X, Y, Z, window, xs, DX, DY, DZ);
  if (err) return err;
  if (window)
    return occ != nullptr ? fused_pick<true, true, true>(f, counts, max_sq, k_in, k_out, s, st)
                          : fused_pick<true, false, true>(f, counts, max_sq, k_in, k_out, s, st);
  return occ != nullptr ? fused_pick<true, true, false>(f, counts, max_sq, k_in, k_out, s, st)
                        : fused_pick<true, false, false>(f, counts, max_sq, k_in, k_out, s, st);
}

BLUB_EXPORT int correct_pack_launch(const int* posq, const int* dyn, const float* c0, const float* c1,
                                    const float* c2, const int8_t* marker, int* out_p, int* out_d, int* counts,
                                    int k_in, int k_out, int s, int X, int Y, int Z, int window, int xs, int DX,
                                    int DY, int DZ, cudaStream_t st) {
  Fused f{posq, dyn, Table{nullptr, nullptr, out_p, out_d, 0}, Src{{c0, c1, c2}, nullptr, {nullptr, nullptr, nullptr},
          marker}, Grid{}, Gmax{}, 0.f, 0, 0};
  const int err = fused_setup(f, k_in, k_out, s, X, Y, Z, window, xs, DX, DY, DZ);
  if (err) return err;
  if (window) return fused_pick<false, false, true>(f, counts, nullptr, k_in, k_out, s, st);
  return fused_pick<false, false, false>(f, counts, nullptr, k_in, k_out, s, st);
}
