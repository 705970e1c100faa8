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
// Where the time goes (chip_smoke.py's fused_split, device ms at the dam's
// frame-64 inputs on an H100 at 700 W): a torch.zeros of the output takes
// 0.079; the kernel on the same table with every slot invalid (its masks'
// valid-word reads, decide and a stream of zeros) 0.116-0.125, whatever the
// design; the rest is G2P and its latency. A block holds 16 warps of an SM
// (advect's G2P takes 128 registers) and its work sits in the fluid's
// tiles, whose blocks run first, so the G2P chains of those tiles and the
// stores of the empty ones add up rather than overlap. The first design
// evaluated G2P 2.25 times per valid slot for advect and 2.125 for correct:
// on the halo planes and again while streaming. This one keeps the first
// evaluation.
//
// The design: a block owns a tile of tx x planes (tx = ceil(X / ceil(X /
// 16)), so that no tile is a sliver: a 68-plane window is 5 tiles of 14),
// rows of up to 32 z cells, 512 cells, with its +-s halo planes, 256 threads.
//   1. masks: a warp takes a z row of the extended tile at a time (lane =
//      z, rows from a block-wide counter) and reads its cells' valid words
//      (g2p.cuh's chunk_mask); the row's valid slots form a work list, slot
//      by slot and in each slot cell by cell, 32 entries a round, so no lane
//      idles on another's cell; G2P on each entry sets the slot's bit in the
//      mask of its moved x bin (a shared atomicOr: the masks are the same
//      bits in any order); advect folds |v|^2 into the block's max (the
//      halo's slots are some other block's core: max is idempotent). The
//      core rows' valid slots get consecutive cache entries (a cell's in
//      slot order, from a warp scan and a block counter), and the first cap
//      of them keep their moved words in shared memory: advect all 8 (32
//      bytes a slot), correct its 2 posq words (dyn moves unchanged);
//   2. decide: a thread per output cell places its slots (pack.cuh's
//      decide: bit scans over the masks, no loads);
//   3. stream: the same thread writes each output slot: a placed slot's
//      words from the cache (its entry from the source cell's first entry
//      and valid mask), or from G2P at its source cell where the cache does
//      not hold it (a source on a halo plane, or past cap), its x rel16 field
//      rebased by the offset; or zeros. One coalesced store per plane row,
//      marked evict-first (the output is not read again here).
// Shared memory: the masks (2s+1 per cell of the extended tile), the core's
// valid masks, first entries and codes, and the cache in what is left of a
// block's part of the SM (110 KiB with advect's 2 blocks an SM, 72 KiB with
// correct's 3): 2752 slots at the dam's shapes (a fluid tile holds about
// 3700; the rest run G2P again), 6880 for correct (every slot of K 14), 0
// where 64 slots' codes leave no room. Every table the card's packs take
// fits, so the step needs no shape gate (JAX's fused_supports) and no
// unfused branch. At the dam: advect 0.192 ms device, correct 0.171 (the
// first design 0.233 and 0.197).
//
// Tried and dropped (chip_smoke.py on this kernel's earlier forms, the same
// inputs): the warp work lists in the stream too, with each warp staging 4
// output slots of its row in shared memory and writing them as 16-byte
// stores: advect 0.240, correct 0.240, its all-invalid floor 0.132 (lanes
// of a fluid row hold about as many slots each, so the lists balance
// little, and the staging and selects cost more than the narrower stores);
// a zero fill of each row followed by the placed words written over it,
// a different block order (interleaving fluid and empty tiles: the L2 loses
// the neighbouring tiles' halos and grids), and the thread-per-cell stream
// without the cache: none faster than the first design. Stayers written
// from pass 1 were slower too: their stores land a few lanes at a time.
#include "g2p.cuh"
#include "pack.cuh"

#define FULL 0xFFFFFFFFu

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

// Position of the k-th (from 0) set bit of m (k < popc(m)).
__device__ __forceinline__ int nth_bit(uint32_t m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

__device__ __forceinline__ uint32_t shfl_mask(uint32_t m, int src) { return __shfl_sync(FULL, m, src); }
__device__ __forceinline__ uint64_t shfl_mask(uint64_t m, int src) {
  const uint32_t lo = __shfl_sync(FULL, (uint32_t)m, src), hi = __shfl_sync(FULL, (uint32_t)(m >> 32), src);
  return ((uint64_t)hi << 32) | lo;
}
__device__ __forceinline__ void or_mask(uint32_t* m, uint32_t v) { atomicOr(m, v); }
__device__ __forceinline__ void or_mask(uint64_t* m, uint64_t v) {
  atomicOr(reinterpret_cast<unsigned long long*>(m), (unsigned long long)v);
}

// The warp's work list, one round of 32 entries at a time: entry (b, lane)
// for every bit b < nb of every lane's word m, ordered by b, then by lane
// (so that a round's lanes read neighbouring cells of one slot). The round
// [e0, e0 + 32) gives lane l the entry e0 + l: -> its bit, or -1 where the
// list ends first; *src: the lane the entry belongs to. (b, base) carry the
// walk from round to round: the next bit and the entries before it.
template <typename M>
__device__ __forceinline__ int next_entry(M m, int nb, int e0, int& b, int& base, int* src) {
  const int e = e0 + (int)(threadIdx.x & 31);
  int got = -1;
  while (b < nb && base < e0 + 32) {
    const uint32_t lanes = __ballot_sync(FULL, (unsigned)((m >> b) & 1u));
    const int c = __popc(lanes);
    if (e >= base && e < base + c) {
      got = b;
      *src = nth_bit(lanes, e - base);
    }
    if (base + c > e0 + 32) break;  // bit b goes on into the next round
    base += c;
    ++b;
  }
  return got;
}

// The output word of channel ch (posq channels first) of slot o at cell dst.
__device__ __forceinline__ int* out_row(const Table& t, int o, int ch, size_t dst) {
  return ch < NUM_POSQ ? t.pout + (size_t)(o * NUM_POSQ + ch) * t.n + dst
                       : t.dout + (size_t)(o * NUM_DYN + ch - NUM_POSQ) * t.n + dst;
}

// G2P on the tile (tx x ty x tz cells of the window, tiles along x fastest)
// then the x pack of its cells (k_in -> k_out slots, reach s). cap: the
// moved slots the block's cache holds. counts: dropped, kept; max_sq: max
// |v|^2 (advect).
template <typename M, bool ADVECT, bool WITH_SOLIDS, bool XS>
__global__ void __launch_bounds__(PACK_THREADS, ADVECT ? 2 : 3)
    fused_kernel(Fused f, int k_in, int k_out, int s, int tx, int ty, int tz, int cap, int* __restrict__ counts,
                 int* __restrict__ max_sq) {
  typedef typename Codes<M>::T C;
  constexpr int W = ADVECT ? NUM_POSQ + NUM_DYN : NUM_POSQ;  // cached words a slot
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  __shared__ int next_row, next_cached;
  const int X = f.d.X, Y = f.d.Y, Z = f.d.Z;
  const int nx = (X + tx - 1) / tx, nz = (Z + tz - 1) / tz;
  const int bx = blockIdx.x % nx, bz = (blockIdx.x / nx) % nz, by = blockIdx.x / (nx * nz);
  const int ox = bx * tx, oy = by * ty, oz = bz * tz;
  const int plane = ty * tz, nh = (tx + 2 * s) * plane, nt = tx * plane;
  const int lane = threadIdx.x & 31;
  int* cache = reinterpret_cast<int*>(smem);  // [cap][W]: moved words of the core's valid slots
  M* masks = reinterpret_cast<M*>(cache + cap * W);
  M* valid = masks + (2 * s + 1) * nh;  // [nt]: the core cells' valid slots
  int* first = reinterpret_cast<int*>(valid + nt);  // [nt]: a core cell's first cache entry
  C* code = reinterpret_cast<C*>(first + nt);
  for (int i = threadIdx.x; i < (2 * s + 1) * nh; i += blockDim.x) masks[i] = 0;
  if (threadIdx.x == 0) next_row = next_cached = 0;
  __syncthreads();
  Tile t;
  t.d = f.d;

  // 1. masks of the tile and its +-s planes, from the moved x bins. A warp
  // takes a z row (lane = z) at a time: its valid slots as a work list, G2P
  // on each, the slot's bit ORed into the mask of its bin (OR is order-free:
  // the masks are the same bits). A core row's valid slots get consecutive
  // cache entries, a cell's in slot order: the first cap keep their words.
  float vsq = 0.f;
  for (;;) {
    int r = 0;
    if (lane == 0) r = atomicAdd(&next_row, 1);
    r = __shfl_sync(FULL, r, 0);
    if (r >= (tx + 2 * s) * ty) break;
    const int gx = ox - s + r / ty, gy = oy + r % ty;
    if (gx < 0 || gx >= X || gy >= Y) continue;
    const bool in_row = lane < min(tz, Z - oz);
    M vm = 0;
    if (in_row) {
      locate(t, gx, gy, oz + lane);
      t.in = true;
      for (int q0 = 0; q0 < k_in; q0 += 32) vm |= (M)chunk_mask(f.posq, t, q0, min(32, k_in - q0)) << q0;
    }
    const bool core = r / ty >= s && r / ty < s + tx;
    int entry = 0;  // the lane's cell's first cache entry (a core row)
    if (core) {
      const int n = slot_count(vm);
      int inc = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc += v;
      }
      int row0 = 0;
      if (lane == 31) row0 = atomicAdd(&next_cached, inc);
      entry = __shfl_sync(FULL, row0, 31) + inc - n;
      if (lane < tz) {
        valid[(r - s * ty) * tz + lane] = vm;
        first[(r - s * ty) * tz + lane] = entry;
      }
    }
    if (!__any_sync(FULL, vm != 0)) continue;
    int q = 0, base = 0;
    for (int e0 = 0;; e0 += 32) {
      int l = 0;
      const int my_q = next_entry(vm, k_in, e0, q, base, &l);
      if (!__any_sync(FULL, my_q >= 0)) break;
      const M src_vm = shfl_mask(vm, l);
      const int src_entry = __shfl_sync(FULL, entry, l);
      if (my_q >= 0) {
        locate(t, gx, gy, oz + l);
        int b[2], mw[NUM_POSQ + NUM_DYN];
        next_words(f.posq, t, my_q, b);
        vsq = fmaxf(vsq, moved<ADVECT, WITH_SOLIDS, XS>(f, t, b, mw));
        const int j = (XS ? bin_shift(hi16(mw[CH_XY]), gx + f.xs, f.dx) : bin_shift(hi16(mw[CH_XY]), gx, X)) + s;
        or_mask(&masks[j * nh + r * tz + l], (M)1u << my_q);
        const int e = src_entry + slot_count(src_vm & low_bits<M>(my_q));
        if (core && e < cap) {
#pragma unroll
          for (int ch = 0; ch < W; ++ch) cache[e * W + ch] = mw[ch];
        }
      }
    }
  }
  __syncthreads();

  // 2. decide and 3. stream, a thread per output cell: it places its slots
  // (pack.cuh's decide), then writes each output slot: a placed slot's
  // moved words from the cache, or from G2P again at its source cell where
  // the cache does not hold them (a source in the halo planes, or past cap),
  // its x rel16 field rebased; or zeros. One coalesced store per plane row,
  // marked for early eviction (the output is not read again here).
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
        const int off = (int)(k >> Codes<M>::BITS) - s, q = (int)(k & SLOT<M>), src = i + off * plane;
        const int e = lx + off >= 0 && lx + off < tx ? first[src] + slot_count(valid[src] & low_bits<M>(q)) : cap;
        locate(t, gx + off, gy, gz);
        if (e < cap) {
#pragma unroll
          for (int ch = 0; ch < W; ++ch) w[ch] = cache[e * W + ch];
        } else {
          int b[2];
          next_words(f.posq, t, q, b);
          moved<ADVECT, WITH_SOLIDS, XS>(f, t, b, w);
        }
        if constexpr (!ADVECT) {
#pragma unroll
          for (int ch = 0; ch < NUM_DYN; ++ch) w[NUM_POSQ + ch] = f.dyn[(q * NUM_DYN + ch) * t.n + t.cell];
        }
        w[CH_XY] = (int)((uint32_t)w[CH_XY] + ((uint32_t)(off * 8192) << 16));
      }
#pragma unroll
      for (int ch = 0; ch < NUM_POSQ + NUM_DYN; ++ch) __stcs(out_row(f.out, o, ch, dst), w[ch]);
    }
  }
  add_counts(counts, c, 2);
  if (ADVECT) {
    const float mx = block_reduce(vsq, MaxOp(), red);
    if (threadIdx.x == 0 && mx > 0.f) atomicMax(max_sq, __float_as_int(mx));
  }
}

// The fused tile: tz and ty as pack x's (pack_tile), tx from the extent so
// that no x tile is a sliver (16 planes at most: 68 planes are 5 tiles of 14)
static void fused_tile(int X, int Y, int Z, int* tx, int* ty, int* tz) {
  const int nt = (X + 15) / 16;
  *tx = (X + nt - 1) / nt;
  *tz = std::min(Z, 32);
  *ty = std::min(Y, std::max(1, PACK_CELLS / (*tz * *tx)));
}

// Shared memory a block may take: advect's 128 registers leave room for 2
// blocks of 256 threads on an SM, correct's 80 for 3; the cache takes what
// the masks, valid slots, first entries and codes leave of the block's part
// of the SM's 227 KiB.
static int fused_budget(bool advect) { return advect ? 110 * 1024 : 72 * 1024; }

// Dynamic shared memory of a block without its cache: the masks of the
// extended tile, the core's valid slots and first cache entries, its codes.
static int fused_smem(bool wide_masks, int k_out, int s, int tx, int ty, int tz) {
  const int mb = wide_masks ? 8 : 4, cb = mb / 4, nt = tx * ty * tz;
  return (2 * s + 1) * (tx + 2 * s) * ty * tz * mb + nt * (mb + 4) + k_out * nt * cb;
}

// The cache's slots (at most every slot of the core) and the block's bytes.
static void fused_cache(bool advect, bool wide_masks, int k_in, int k_out, int s, int tx, int ty, int tz, int* cap,
                        int* bytes) {
  const int rest = fused_smem(wide_masks, k_out, s, tx, ty, tz), slot = (advect ? NUM_POSQ + NUM_DYN : NUM_POSQ) * 4;
  *cap = std::max(0, std::min(k_in * tx * ty * tz, (fused_budget(advect) - rest) / slot));
  *bytes = rest + *cap * slot;
}

// The opt-in limit of the kernel's dynamic shared memory, raised whatever the
// size: the block's static arrays count against the 48 KiB default too.
template <typename K>
static int fused_smem_limit(K kernel, int bytes) {
  if (bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename M, bool ADVECT, bool WITH_SOLIDS, bool XS>
static int fused_run(const Fused& f, int* counts, int* max_sq, int k_in, int k_out, int s, cudaStream_t st) {
  int tx, ty, tz, cap, bytes;
  fused_tile(f.d.X, f.d.Y, f.d.Z, &tx, &ty, &tz);
  fused_cache(ADVECT, sizeof(M) == 8, k_in, k_out, s, tx, ty, tz, &cap, &bytes);
  const int err = fused_smem_limit(fused_kernel<M, ADVECT, WITH_SOLIDS, XS>, bytes);
  if (err) return err;
  const int blocks = ((f.d.X + tx - 1) / tx) * ((f.d.Y + ty - 1) / ty) * ((f.d.Z + tz - 1) / tz);
  fused_kernel<M, ADVECT, WITH_SOLIDS, XS><<<blocks, PACK_THREADS, bytes, st>>>(f, k_in, k_out, s, tx, ty, tz, cap,
                                                                               counts, max_sq);
  return static_cast<int>(cudaGetLastError());
}

// out: x planes of a tile, dynamic shared memory bytes, resident blocks per
// SM, registers a thread, threads a block, cached slots.
template <typename M, bool ADVECT, bool WITH_SOLIDS, bool XS>
static int fused_config_of(int k_in, int k_out, int s, int X, int Y, int Z, int* out) {
  auto kernel = fused_kernel<M, ADVECT, WITH_SOLIDS, XS>;
  int tx, ty, tz, cap, bytes;
  fused_tile(X, Y, Z, &tx, &ty, &tz);
  fused_cache(ADVECT, sizeof(M) == 8, k_in, k_out, s, tx, ty, tz, &cap, &bytes);
  int err = fused_smem_limit(kernel, bytes);
  if (err) return err;
  cudaFuncAttributes a;
  err = static_cast<int>(cudaFuncGetAttributes(&a, kernel));
  if (err) return err;
  int nb = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, PACK_THREADS, bytes));
  out[0] = tx;
  out[1] = bytes;
  out[2] = nb;
  out[3] = a.numRegs;
  out[4] = PACK_THREADS;
  out[5] = cap;
  return err;
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

// The launch configuration of a form (advect with or without solids, or
// correct; window: the x_start form) at a table's shape, for the build
// report: out[6] as fused_config_of's.
BLUB_EXPORT int advect_pack_config(int advect, int solids, int window, int k_in, int k_out, int s, int X, int Y,
                                   int Z, int* out) {
  const bool w = wide(k_in, k_out);
  if (advect && solids)
    return window ? (w ? fused_config_of<uint64_t, true, true, true>(k_in, k_out, s, X, Y, Z, out)
                       : fused_config_of<uint32_t, true, true, true>(k_in, k_out, s, X, Y, Z, out))
                  : (w ? fused_config_of<uint64_t, true, true, false>(k_in, k_out, s, X, Y, Z, out)
                       : fused_config_of<uint32_t, true, true, false>(k_in, k_out, s, X, Y, Z, out));
  if (advect)
    return window ? (w ? fused_config_of<uint64_t, true, false, true>(k_in, k_out, s, X, Y, Z, out)
                       : fused_config_of<uint32_t, true, false, true>(k_in, k_out, s, X, Y, Z, out))
                  : (w ? fused_config_of<uint64_t, true, false, false>(k_in, k_out, s, X, Y, Z, out)
                       : fused_config_of<uint32_t, true, false, false>(k_in, k_out, s, X, Y, Z, out));
  return window ? (w ? fused_config_of<uint64_t, false, false, true>(k_in, k_out, s, X, Y, Z, out)
                     : fused_config_of<uint32_t, false, false, true>(k_in, k_out, s, X, Y, Z, out))
                : (w ? fused_config_of<uint64_t, false, false, false>(k_in, k_out, s, X, Y, Z, out)
                     : fused_config_of<uint32_t, false, false, false>(k_in, k_out, s, X, Y, Z, out));
}
