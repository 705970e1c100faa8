// The per-slot G2P of g2p.cu (advection and density position correction of
// one slot of a cell), shared by g2p.cu's kernel and advect_pack.cu's fused
// kernels, which compute the same bits for a slot wherever they evaluate it.
#pragma once

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

// The cell (x, y, z) of t.d as t's cell: its index, offsets and z mask.
__device__ __forceinline__ void locate(Tile& t, int x, int y, int z) {
  const Grid& d = t.d;
  t.x = x;
  t.y = y;
  t.z = z;
  t.n = d.X * d.Y * d.Z;
  t.cell = (x * d.Y + y) * d.Z + z;
  t.zm = 0u;
  for (int k = 0; k < 3; ++k) {
    t.ox[k] = wrap(x - 1 + k, d.X) * d.Y * d.Z;
    t.oy[k] = wrap(y - 1 + k, d.Y) * d.Z;
    t.oz[k] = wrap(z - 1 + k, d.Z);
    t.zm |= (zroll(d, z - 1 + k) < d.Z ? 1u : 0u) << k;
  }
}

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
  locate(t, t.x, t.y0 + i / tz, t.z0 + i % tz);
  t.in = i < ty * tz && t.y < d.Y && t.z < d.Z;
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
