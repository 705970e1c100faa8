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
#include "common.cuh"

#define G2P_THREADS 128

struct Grid {
  int X, Y, Z, Zp;  // Zp: the padded z extent the reads roll over
};

// z + dz (|dz| <= 2) rolled over the padded extent; >= d.Z reads 0
__device__ __forceinline__ int zroll(const Grid& d, int z) {
  return z < 0 ? z + d.Zp : (z >= d.Zp ? z - d.Zp : z);
}

// The block's tile: x plane x, rows y0 .. y0 + ty, columns z0 .. z0 + tz;
// the thread's cell (x, y, z) in it, with the grid offsets of the
// coordinates -1, 0, +1 of each axis, wrapped cyclically (ox[i] =
// wrap(x - 1 + i) * Y * Z, oy[i] = wrap(y - 1 + i) * Z, oz[i] =
// wrap(z - 1 + i)), and bit i of zm set where z - 1 + i rolled over the
// padded extent lies in the grid: where it is clear, the read is 0 (for an
// offset of 1 the rolled and the wrapped coordinate agree wherever the
// rolled one lies in the grid). `in`: the thread holds a cell of the grid.
struct Tile {
  Grid d;
  int x, y0, z0, ty, tz, y, z;
  int ox[3], oy[3], oz[3];
  unsigned zm;
  int n, cell;  // every index of the tables fits an int (checked at launch)
  bool in;
};

__device__ __forceinline__ Tile tile_of(Grid d, int ty, int tz) {
  Tile t;
  t.d = d;
  t.ty = ty;
  t.tz = tz;
  const int nz = (d.Z + tz - 1) / tz, b = blockIdx.x;
  t.x = b % d.X;
  t.z0 = (b / d.X) % nz * tz;
  t.y0 = b / (d.X * nz) * ty;
  const int i = threadIdx.x;
  t.y = t.y0 + i / tz;
  t.z = t.z0 + i % tz;
  t.in = i < ty * tz && t.y < d.Y && t.z < d.Z;
  t.n = d.X * d.Y * d.Z;
  t.cell = (t.x * d.Y + t.y) * d.Z + t.z;
  t.zm = 0u;
  for (int k = 0; k < 3; ++k) {
    t.ox[k] = wrap(t.x - 1 + k, d.X) * d.Y * d.Z;
    t.oy[k] = wrap(t.y - 1 + k, d.Y) * d.Z;
    t.oz[k] = wrap(t.z - 1 + k, d.Z);
    t.zm |= (zroll(d, t.z - 1 + k) < d.Z ? 1u : 0u) << k;
  }
  return t;
}

// Grid g at the thread's cell + (dx, dy, dz), |d| <= 2: x and y wrapped,
// z rolled over the padded extent (0 past Z).
template <typename T>
__device__ __forceinline__ T at(const T* g, const Tile& t, int dx, int dy, int dz) {
  const int z = zroll(t.d, t.z + dz);
  return z < t.d.Z ? g[(wrap(t.x + dx, t.d.X) * t.d.Y + wrap(t.y + dy, t.d.Y)) * t.d.Z + z] : T(0);
}

// Bit u: slot q0 + u (u < kq <= 32) of the thread's cell is valid; 16
// valid words in flight.
__device__ __forceinline__ uint32_t chunk_mask(const int* posq, const Tile& t, int q0, int kq) {
  uint32_t m = 0u;
  if (!t.in) return m;
  const int* p = posq + CH_ZV * t.n + t.cell;
  for (int u0 = 0; u0 < kq; u0 += 16) {
    int b[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) b[u] = u0 + u < kq ? p[(q0 + u0 + u) * NUM_POSQ * t.n] : 0;
#pragma unroll
    for (int u = 0; u < 16; ++u) m |= (uint32_t)(b[u] & 1) << (u0 + u);
  }
  return m;
}

// OR of the block's masks; *acc is zero and a barrier has passed since.
__device__ __forceinline__ uint32_t block_or(uint32_t m, uint32_t* acc) {
  const uint32_t w = __reduce_or_sync(0xFFFFFFFFu, m);
  if ((threadIdx.x & 31) == 0 && w) atomicOr(acc, w);
  __syncthreads();
  return *acc;
}

// Zeros into the tile's cells of the `ch` planes from `base` (n cells
// apart), by the whole block: 16-byte stores when the tile is whole z rows
// of 4k cells (its cells contiguous and 16-byte aligned in every plane),
// else one word a thread.
__device__ __forceinline__ void zero_planes(int* base, int ch, const Tile& t, bool vec) {
  if (vec) {
    const int first = (t.x * t.d.Y + t.y0) * t.d.Z;
    const int n4 = min(t.ty, t.d.Y - t.y0) * t.d.Z / 4;
    for (int j = threadIdx.x; j < ch * n4; j += blockDim.x) {
      const int c = j / n4;
      reinterpret_cast<int4*>(base + c * t.n + first)[j - c * n4] = make_int4(0, 0, 0, 0);
    }
  } else if (t.in) {
    for (int c = 0; c < ch; ++c) base[c * t.n + t.cell] = 0;
  }
}

__device__ __forceinline__ float mixf(float a, float b, float t) { return a + (b - a) * t; }

struct Stagger {
  float v[3][8];  // [component][cx*4 + cy*2 + cz]
  float it[3][3];  // [component][axis]
};

__device__ __forceinline__ float tri(const float* v, float ix, float iy, float iz) {
  return mixf(mixf(mixf(v[0], v[4], ix), mixf(v[2], v[6], ix), iy),
              mixf(mixf(v[1], v[5], ix), mixf(v[3], v[7], ix), iy), iz);
}

// sm_phases._staggered_corners_sm for one slot of the thread's cell: the
// corners of component c start one cell down along c unless xi_c >= 0.5
__device__ __forceinline__ void staggered(const float* const g[3], const Tile& t, const float pos[3],
                                          const float gf[3], Stagger& s) {
  float xi[3];
  bool sel[3];
  for (int a = 0; a < 3; ++a) {
    xi[a] = clampf(pos[a] - 0.5f - gf[a], 0.f, 0.999999f);
    sel[a] = xi[a] >= 0.5f;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int cx = 0; cx < 2; ++cx)
#pragma unroll
      for (int cy = 0; cy < 2; ++cy)
#pragma unroll
        for (int cz = 0; cz < 2; ++cz) {
          const int ix = c == 0 && !sel[0] ? t.ox[cx] : t.ox[1 + cx];
          const int iy = c == 1 && !sel[1] ? t.oy[cy] : t.oy[1 + cy];
          const int iz = c == 2 && !sel[2] ? t.oz[cz] : t.oz[1 + cz];
          s.v[c][cx * 4 + cy * 2 + cz] = g[c][ix + iy + iz];
        }
    for (int a = 0; a < 3; ++a) s.it[c][a] = a == c ? xi[c] + (sel[c] ? -0.5f : 0.5f) : xi[a];
  }
  // a cell on a z wall (Z not a multiple of 128): its corners past the wall
  // read 0; the gather above stays as on every other cell
  if (t.zm != 7u) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int cz = 0; cz < 2; ++cz) {
        const int k = c == 2 && !sel[2] ? cz : 1 + cz;
        if (!((t.zm >> k) & 1u))
#pragma unroll
          for (int cxy = 0; cxy < 4; ++cxy) s.v[c][cxy * 2 + cz] = 0.f;
      }
  }
}

// advect._clamp_step_to_cell
__device__ __forceinline__ void clamp_step(const float pos[3], const float m[3], float dir[3], float& max_step) {
  const float step_len = sqrtf(m[0] * m[0] + m[1] * m[1] + m[2] * m[2]) + 1e-10f;
  max_step = step_len;
  for (int a = 0; a < 3; ++a) {
    dir[a] = m[a] / step_len;
    const float ad = fabsf(dir[a]);
    const float pic = pos[a] - floorf(pos[a]);
    const float dist = dir[a] > 0.f ? 1.f - pic : pic;
    const float per_axis = ad > 0.f ? dist / ad - 0.001f : __int_as_float(0x7f800000);
    max_step = fminf(max_step, per_axis);
  }
}

__device__ __forceinline__ float sgnf(float v) { return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f); }

// The grids a kernel reads.
struct Src {
  const float* g[3];     // face (advect) or change (correct) grids
  const float* occ;      // occupancy (advect with solids)
  const float* sv[3];    // solid velocity (advect with solids)
  const int8_t* marker;  // (correct)
};

// One slot of the thread's cell, decoded: cell coordinates and position.
struct Slot {
  float gf[3], pos[3];
};

// XS: the tile's x plane is global x plane t.x + xs (an x-window of the
// domain); positions and cell coordinates are then global
template <bool XS>
__device__ __forceinline__ int global_x(const Tile& t, int xs) {
  return XS ? t.x + xs : t.x;
}

template <bool XS>
__device__ __forceinline__ Slot decode(const Tile& t, int b0, int b1, int xs) {
  Slot s;
  const int r[3] = {hi16(b0), sext16(b0), hi16(b1)};
  const int c[3] = {global_x<XS>(t, xs), t.y, t.z};
  for (int a = 0; a < 3; ++a) {
    s.gf[a] = (float)c[a];
    s.pos[a] = (s.gf[a] + 1.0f) + (float)r[a] * POS_INV;
  }
  return s;
}

// the posq words of position np in the slot's cell
__device__ __forceinline__ void encode(const Slot& s, const float np[3], int w[NUM_POSQ]) {
  int r[3];
  for (int a = 0; a < 3; ++a) r[a] = (int)rintf((np[a] - s.gf[a] - 1.0f) * POS_SCALE);
  w[CH_XY] = pack16(r[0], r[1]);
  w[CH_ZV] = pack16(r[2], 0) | 1;
}

// Advect a slot of the thread's cell (b0, b1: its posq words): its posq and
// dyn words to w; returns |v|^2.
template <bool WITH_SOLIDS, bool XS>
__device__ __forceinline__ float advect_slot(const Src& src, const Tile& t, int b0, int b1, float dt,
                                             const float gmax[3], int xs, int w[NUM_POSQ + NUM_DYN]) {
  const Slot s = decode<XS>(t, b0, b1, xs);
  const int cc[3] = {global_x<XS>(t, xs), t.y, t.z};
  float pos[3] = {s.pos[0], s.pos[1], s.pos[2]};
  if constexpr (WITH_SOLIDS) {
    // escape from moving solids (sm_phases.advect_slot_major :269-288)
    int pc[3];
    for (int a = 0; a < 3; ++a) pc[a] = pos[a] - 0.5f - s.gf[a] >= 0.5f ? 1 : 0;
    const float occ_here = at(src.occ, t, pc[0], pc[1], pc[2]);
    float sv[3];
    for (int a = 0; a < 3; ++a) sv[a] = at(src.sv[a], t, pc[0], pc[1], pc[2]);
    const float ax = fabsf(sv[0]), ay = fabsf(sv[1]), az = fabsf(sv[2]);
    const bool use_x = ax > ay && ax > az;
    const bool use_y = !use_x && ay > az;
    const bool use[3] = {use_x, use_y, !use_x && !use_y};
    if (occ_here > 0.f)
      for (int a = 0; a < 3; ++a)
        if (use[a]) pos[a] = pos[a] + sgnf(sv[a]);
  }
  Stagger st;
  staggered(src.g, t, pos, s.gf, st);
  float vel[3], aff[3][3];
  for (int c = 0; c < 3; ++c) {
    const float* v = st.v[c];
    const float ix = st.it[c][0], iy = st.it[c][1], iz = st.it[c][2];
    // v index: cx*4 + cy*2 + cz
    const float v_x00 = mixf(v[0], v[4], ix), v_x01 = mixf(v[1], v[5], ix);
    const float v_x10 = mixf(v[2], v[6], ix), v_x11 = mixf(v[3], v[7], ix);
    const float v_xy0 = mixf(v_x00, v_x10, iy), v_xy1 = mixf(v_x01, v_x11, iy);
    vel[c] = mixf(v_xy0, v_xy1, iz);
    aff[c][0] = mixf(mixf(v[4], v[6], iy), mixf(v[5], v[7], iy), iz) -
                mixf(mixf(v[0], v[2], iy), mixf(v[1], v[3], iy), iz);
    aff[c][1] = mixf(v_x10, v_x11, iz) - mixf(v_x00, v_x01, iz);
    aff[c][2] = v_xy1 - v_xy0;
  }
  // RK4 with cell-confined probes (advect._rk4)
  const float h = dt * 0.5f;
  const float c6 = dt * (float)(1.0 / 6.0);
  float k2[3], k3[3], k4[3];
  for (int c = 0; c < 3; ++c)
    k2[c] = tri(st.v[c], clampf(st.it[c][0] + h * vel[0], 0.f, 1.f), clampf(st.it[c][1] + h * vel[1], 0.f, 1.f),
                clampf(st.it[c][2] + h * vel[2], 0.f, 1.f));
  for (int c = 0; c < 3; ++c)
    k3[c] = tri(st.v[c], clampf(st.it[c][0] + h * k2[0], 0.f, 1.f), clampf(st.it[c][1] + h * k2[1], 0.f, 1.f),
                clampf(st.it[c][2] + h * k2[2], 0.f, 1.f));
  for (int c = 0; c < 3; ++c)
    k4[c] = tri(st.v[c], clampf(st.it[c][0] + dt * k3[0], 0.f, 1.f), clampf(st.it[c][1] + dt * k3[1], 0.f, 1.f),
                clampf(st.it[c][2] + dt * k3[2], 0.f, 1.f));
  float mv[3], np[3];
  for (int a = 0; a < 3; ++a) {
    float m = c6 * (vel[a] + 2.0f * (k2[a] + k3[a]) + k4[a]);
    m = clampf(m, -1.99f, 1.99f);
    np[a] = clampf(pos[a] + m, s.gf[a] - 1.499f, s.gf[a] + 2.499f);
    mv[a] = np[a] - pos[a];
  }
  bool pen = false;  // out of bounds, or (with solids) into an occupied cell
  for (int a = 0; a < 3; ++a) pen = pen || np[a] < 1.001f || np[a] > gmax[a];
  if constexpr (WITH_SOLIDS) {
    int o[3];
    for (int a = 0; a < 3; ++a) o[a] = min(max((int)floorf(np[a]) - cc[a], -2), 2);
    pen = pen || at(src.occ, t, o[0], o[1], o[2]) > 0.f;
  }
  float dir[3], max_step;
  clamp_step(pos, mv, dir, max_step);
  float cl[3];
  for (int a = 0; a < 3; ++a) cl[a] = dir[a] * max_step;
  if constexpr (WITH_SOLIDS) {
    bool stuck = true;
    for (int a = 0; a < 3; ++a) stuck = stuck && (int)floorf(pos[a]) == (int)floorf(np[a]);
    if (stuck && pen) {
      // occupancy-gradient push (sm_phases :309-322), summed in
      // _trilinear_center_sm's corner order at the unclipped escaped xi
      float xi[3];
      for (int a = 0; a < 3; ++a) xi[a] = pos[a] - 0.5f - s.gf[a];
      const float scale = dt * 50.0f;
      for (int a = 0; a < 3; ++a) {
        float acc = 0.f;
        const int ex = a == 0, ey = a == 1, ez = a == 2;  // e_a
        for (int ox = 0; ox < 2; ++ox)
          for (int oy = 0; oy < 2; ++oy)
            for (int oz = 0; oz < 2; ++oz) {
              float w = 1.0f;
              w = w * (ox ? xi[0] : 1.0f - xi[0]);
              w = w * (oy ? xi[1] : 1.0f - xi[1]);
              w = w * (oz ? xi[2] : 1.0f - xi[2]);
              const float gr = 0.5f * (at(src.occ, t, ox - ex, oy - ey, oz - ez) -
                                       at(src.occ, t, ox + ex, oy + ey, oz + ez));
              acc = acc + w * gr;
            }
        cl[a] = cl[a] + acc * scale;
      }
    }
  }
  const float inv_dt = max_step / dt;
  for (int a = 0; a < 3; ++a) {
    const float corrected = clampf(pos[a] + cl[a], 1.001f, gmax[a]);
    if (pen) {
      np[a] = corrected;
      vel[a] = dir[a] * inv_dt;
    }
  }
  encode(s, np, w);
  w[NUM_POSQ + 0] = pack_pair(vel[0], vel[1]);
  w[NUM_POSQ + 1] = pack_pair(vel[2], aff[0][0]);
  w[NUM_POSQ + 2] = pack_pair(aff[0][1], aff[0][2]);
  w[NUM_POSQ + 3] = pack_pair(aff[1][0], aff[1][1]);
  w[NUM_POSQ + 4] = pack_pair(aff[1][2], aff[2][0]);
  w[NUM_POSQ + 5] = pack_pair(aff[2][1], aff[2][2]);
  return vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2];
}

// Correct a slot of the thread's cell (b0, b1: its posq words): its posq
// words to w.
template <bool XS>
__device__ __forceinline__ void correct_slot(const Src& src, const Tile& t, int b0, int b1, const float gmax[3],
                                             int xs, int w[NUM_POSQ]) {
  const Slot s = decode<XS>(t, b0, b1, xs);
  Stagger st;
  staggered(src.g, t, s.pos, s.gf, st);
  float mv[3], np[3];
  for (int a = 0; a < 3; ++a) {
    float m = tri(st.v[a], st.it[a][0], st.it[a][1], st.it[a][2]);
    m = clampf(m, -0.99f, 0.99f);
    np[a] = clampf(s.pos[a] + m, s.gf[a] - 0.499f, s.gf[a] + 1.999f);
    mv[a] = np[a] - s.pos[a];
  }
  bool oob = false;
  for (int a = 0; a < 3; ++a) oob = oob || np[a] < 1.001f || np[a] > gmax[a];
  const int c[3] = {global_x<XS>(t, xs), t.y, t.z};
  int o[3];
  for (int a = 0; a < 3; ++a) o[a] = min(max((int)floorf(np[a]) - c[a], -1), 1);
  const bool pen = oob || at(src.marker, t, o[0], o[1], o[2]) == CELL_SOLID;
  float dir[3], max_step;
  clamp_step(s.pos, mv, dir, max_step);
  if (pen)
    for (int a = 0; a < 3; ++a) np[a] = clampf(s.pos[a] + dir[a] * max_step, 1.001f, gmax[a]);
  encode(s, np, w);
}

struct Gmax {
  float v[3];
};

// The two posq words of slot q of the thread's cell.
__device__ __forceinline__ void next_words(const int* __restrict__ posq, const Tile& t, int q, int b[2]) {
  b[0] = posq[(q * NUM_POSQ + CH_XY) * t.n + t.cell];
  b[1] = posq[(q * NUM_POSQ + CH_ZV) * t.n + t.cell];
}

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
