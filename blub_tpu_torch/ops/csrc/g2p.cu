// G2P for Hopper: APIC advection and density position correction per slot.
// Replaces the G2P half of the TPU kernels
// blub_tpu/ops/pallas_advect.py::_advect_pack_kernel (def :927, pallas_call
// :1042) and _correct_pack_kernel (:1060 / :1159); their x-pack is the pack
// kernel along x (pack.cu). Also covers _advect_kernel (:294 / :667) and
// _correct_kernel (:514 / :706), the unfused variants. Advect comes in both
// with_solids specialisations of the TPU kernels (template WITH_SOLIDS).
//
// One thread per (slot, cell), slot-major so neighbouring threads read
// neighbouring z addresses of one slot plane. Math as in
// sim/sm_phases.advect_slot_major / correct_slot_major; grid reads are
// cyclic (jnp.roll), occupancy included. With solids a particle whose
// primal cell is occupied first escapes one cell along the dominant axis of
// the solid velocity there, in its sign; a target cell (offset clipped to
// +-2) that is occupied counts as penetration like leaving the domain; and a
// particle that penetrates without leaving its cell also takes the push
// dt*50 * trilinear(0.5*(occ[g-e_a] - occ[g+e_a])) at its escaped xi
// (pallas_advect.py:417-478, _push_force :257). Positions store with rintf (round half to
// even, as quantize_pos); velocities and affine rows as bf16 pairs with
// __float2bfloat16_rn, -0.0 turned into +0.0 before packing. Built with
// -fmad=false so every product and sum rounds as in the plain version.
//
// max |v|^2 is reduced per block and folded with atomicMax on the int bits
// of a non-negative float: deterministic.
//
// What bounds it on the card: bytes. At the dam shape (about 13% of the slots
// valid) advect must read the valid word of every slot (29 MB) and the other
// posq word of the valid ones (4 MB), and write posq + dyn in full (235 MB);
// the face grids (6 MB) stay in L2. Correct reads the same 33 MB and writes
// posq (59 MB). The arithmetic is about 600 (advect) and 200 (correct) f32
// operations per valid slot, a small fraction of the card's rate. Invalid
// slots (most of the upper slots) cost one read and the zero stores. The
// solids specialisation adds the occupancy and 3 solid-velocity grids (8 MB
// at the dam shape, in L2) and about 130 operations per valid slot (escape,
// penetration, and the 24-term push where it applies).
#include "common.cuh"

struct Grid {
  int X, Y, Z;
};

__device__ __forceinline__ float mixf(float a, float b, float t) { return a + (b - a) * t; }

__device__ __forceinline__ float rd(const float* g, Grid d, int x, int y, int z) {
  return g[(wrap(x, d.X) * d.Y + wrap(y, d.Y)) * d.Z + wrap(z, d.Z)];
}

struct Stagger {
  float v[3][8];  // [component][cx*4 + cy*2 + cz]
  float it[3][3];  // [component][axis]
};

__device__ __forceinline__ float tri(const float* v, float ix, float iy, float iz) {
  return mixf(mixf(mixf(v[0], v[4], ix), mixf(v[2], v[6], ix), iy),
              mixf(mixf(v[1], v[5], ix), mixf(v[3], v[7], ix), iy), iz);
}

// sm_phases._staggered_corners_sm for one slot
__device__ void staggered(const float* const g[3], Grid d, int x, int y, int z, const float pos[3],
                          const float gf[3], Stagger& s) {
  float xi[3];
  bool sel[3];
  for (int a = 0; a < 3; ++a) {
    xi[a] = clampf(pos[a] - 0.5f - gf[a], 0.f, 0.999999f);
    sel[a] = xi[a] >= 0.5f;
  }
  for (int c = 0; c < 3; ++c) {
    const int lo = sel[c] ? 0 : -1;
    for (int cx = 0; cx < 2; ++cx)
      for (int cy = 0; cy < 2; ++cy)
        for (int cz = 0; cz < 2; ++cz) {
          int o[3] = {cx, cy, cz};
          o[c] += lo;
          s.v[c][cx * 4 + cy * 2 + cz] = rd(g[c], d, x + o[0], y + o[1], z + o[2]);
        }
    for (int a = 0; a < 3; ++a) s.it[c][a] = a == c ? xi[c] + (sel[c] ? -0.5f : 0.5f) : xi[a];
  }
}

// advect._clamp_step_to_cell
__device__ void clamp_step(const float pos[3], const float m[3], float dir[3], float& max_step) {
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

// occupancy and solid-velocity planes; all null without solids
struct Solids {
  const float* occ;
  const float* sv[3];
};

__device__ __forceinline__ float sgnf(float v) { return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f); }

struct Slot {
  int cell, q, x, y, z;
  float gf[3], pos[3];
  bool valid;
};

__device__ __forceinline__ Slot decode(const int* posq, int K, Grid d) {
  Slot s;
  const int n = d.X * d.Y * d.Z;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  s.valid = false;
  if (t >= (long long)K * n) {
    s.q = -1;
    return s;
  }
  s.q = (int)(t / n);
  s.cell = (int)(t % n);
  s.z = s.cell % d.Z;
  s.y = (s.cell / d.Z) % d.Y;
  s.x = s.cell / (d.Y * d.Z);
  const int b0 = posq[(size_t)(s.q * NUM_POSQ + CH_XY) * n + s.cell];
  const int b1 = posq[(size_t)(s.q * NUM_POSQ + CH_ZV) * n + s.cell];
  s.valid = b1 & 1;
  const int r[3] = {hi16(b0), sext16(b0), hi16(b1)};
  const int c[3] = {s.x, s.y, s.z};
  for (int a = 0; a < 3; ++a) {
    s.gf[a] = (float)c[a];
    s.pos[a] = (s.gf[a] + 1.0f) + (float)r[a] * POS_INV;
  }
  return s;
}

__device__ __forceinline__ void encode(int* out, const Slot& s, const float np[3], int n) {
  int r[3];
  for (int a = 0; a < 3; ++a) r[a] = (int)rintf((np[a] - s.gf[a] - 1.0f) * POS_SCALE);
  out[(size_t)(s.q * NUM_POSQ + CH_XY) * n + s.cell] = pack16(r[0], r[1]);
  out[(size_t)(s.q * NUM_POSQ + CH_ZV) * n + s.cell] = pack16(r[2], 0) | 1;
}

template <bool WITH_SOLIDS>
__global__ void advect_kernel(const int* __restrict__ posq, const float* __restrict__ v0,
                              const float* __restrict__ v1, const float* __restrict__ v2, Solids so,
                              int* __restrict__ out_p, int* __restrict__ out_d, int* __restrict__ max_sq,
                              float dt, int K, Grid d, float gmax0, float gmax1, float gmax2) {
  __shared__ float smem[32];
  const int n = d.X * d.Y * d.Z;
  const Slot s = decode(posq, K, d);
  float vsq = 0.f;
  if (s.q >= 0 && !s.valid) {
    for (int c = 0; c < NUM_POSQ; ++c) out_p[(size_t)(s.q * NUM_POSQ + c) * n + s.cell] = 0;
    for (int c = 0; c < NUM_DYN; ++c) out_d[(size_t)(s.q * NUM_DYN + c) * n + s.cell] = 0;
  } else if (s.valid) {
    const float* g[3] = {v0, v1, v2};
    const float gmax[3] = {gmax0, gmax1, gmax2};
    const int cc[3] = {s.x, s.y, s.z};
    float pos[3] = {s.pos[0], s.pos[1], s.pos[2]};
    if constexpr (WITH_SOLIDS) {
      // escape from moving solids (sm_phases.advect_slot_major :269-288)
      int pc[3];
      for (int a = 0; a < 3; ++a) pc[a] = cc[a] + (pos[a] - 0.5f - s.gf[a] >= 0.5f ? 1 : 0);
      const float occ_here = rd(so.occ, d, pc[0], pc[1], pc[2]);
      float sv[3];
      for (int a = 0; a < 3; ++a) sv[a] = rd(so.sv[a], d, pc[0], pc[1], pc[2]);
      const float ax = fabsf(sv[0]), ay = fabsf(sv[1]), az = fabsf(sv[2]);
      const bool use_x = ax > ay && ax > az;
      const bool use_y = !use_x && ay > az;
      const bool use[3] = {use_x, use_y, !use_x && !use_y};
      if (occ_here > 0.f)
        for (int a = 0; a < 3; ++a)
          if (use[a]) pos[a] = pos[a] + sgnf(sv[a]);
    }
    Stagger st;
    staggered(g, d, s.x, s.y, s.z, pos, s.gf, st);
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
      pen = pen || rd(so.occ, d, cc[0] + o[0], cc[1] + o[1], cc[2] + o[2]) > 0.f;
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
          for (int ox = 0; ox < 2; ++ox)
            for (int oy = 0; oy < 2; ++oy)
              for (int oz = 0; oz < 2; ++oz) {
                float w = 1.0f;
                w = w * (ox ? xi[0] : 1.0f - xi[0]);
                w = w * (oy ? xi[1] : 1.0f - xi[1]);
                w = w * (oz ? xi[2] : 1.0f - xi[2]);
                int lo[3] = {cc[0] + ox, cc[1] + oy, cc[2] + oz}, hi[3] = {lo[0], lo[1], lo[2]};
                lo[a] -= 1;
                hi[a] += 1;
                const float gr = 0.5f * (rd(so.occ, d, lo[0], lo[1], lo[2]) - rd(so.occ, d, hi[0], hi[1], hi[2]));
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
    encode(out_p, s, np, n);
    vsq = vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2];
    const int pairs[6] = {pack_pair(vel[0], vel[1]),       pack_pair(vel[2], aff[0][0]),
                          pack_pair(aff[0][1], aff[0][2]), pack_pair(aff[1][0], aff[1][1]),
                          pack_pair(aff[1][2], aff[2][0]), pack_pair(aff[2][1], aff[2][2])};
    for (int c = 0; c < NUM_DYN; ++c) out_d[(size_t)(s.q * NUM_DYN + c) * n + s.cell] = pairs[c];
  }
  const float m = block_reduce(vsq, MaxOp(), smem);
  if (threadIdx.x == 0 && m > 0.f) atomicMax(max_sq, __float_as_int(m));
}

__global__ void correct_kernel(const int* __restrict__ posq, const float* __restrict__ c0,
                               const float* __restrict__ c1, const float* __restrict__ c2,
                               const int8_t* __restrict__ marker, int* __restrict__ out_p, int K, Grid d,
                               float gmax0, float gmax1, float gmax2) {
  const int n = d.X * d.Y * d.Z;
  const Slot s = decode(posq, K, d);
  if (s.q < 0) return;
  if (!s.valid) {
    for (int c = 0; c < NUM_POSQ; ++c) out_p[(size_t)(s.q * NUM_POSQ + c) * n + s.cell] = 0;
    return;
  }
  const float* g[3] = {c0, c1, c2};
  const float gmax[3] = {gmax0, gmax1, gmax2};
  Stagger st;
  staggered(g, d, s.x, s.y, s.z, s.pos, s.gf, st);
  float mv[3], np[3];
  for (int a = 0; a < 3; ++a) {
    float m = tri(st.v[a], st.it[a][0], st.it[a][1], st.it[a][2]);
    m = clampf(m, -0.99f, 0.99f);
    np[a] = clampf(s.pos[a] + m, s.gf[a] - 0.499f, s.gf[a] + 1.999f);
    mv[a] = np[a] - s.pos[a];
  }
  bool oob = false;
  for (int a = 0; a < 3; ++a) oob = oob || np[a] < 1.001f || np[a] > gmax[a];
  const int c[3] = {s.x, s.y, s.z};
  int o[3];
  for (int a = 0; a < 3; ++a) o[a] = min(max((int)floorf(np[a]) - c[a], -1), 1);
  const int8_t tm = marker[(wrap(s.x + o[0], d.X) * d.Y + wrap(s.y + o[1], d.Y)) * d.Z + wrap(s.z + o[2], d.Z)];
  const bool pen = oob || tm == CELL_SOLID;
  float dir[3], max_step;
  clamp_step(s.pos, mv, dir, max_step);
  if (pen)
    for (int a = 0; a < 3; ++a) np[a] = clampf(s.pos[a] + dir[a] * max_step, 1.001f, gmax[a]);
  encode(out_p, s, np, n);
}

static void gmax(int X, int Y, int Z, float g[3]) {
  g[0] = (float)((double)X - 1.001);
  g[1] = (float)((double)Y - 1.001);
  g[2] = (float)((double)Z - 1.001);
}

#define THREADS 256

// occ == nullptr selects the specialisation without solids
BLUB_EXPORT int g2p_advect_launch(const int* posq, const float* v0, const float* v1, const float* v2,
                                  const float* occ, const float* sv0, const float* sv1, const float* sv2,
                                  int* out_p, int* out_d, int* max_sq, float dt, int K, int X, int Y, int Z,
                                  cudaStream_t st) {
  Grid d{X, Y, Z};
  float g[3];
  gmax(X, Y, Z, g);
  const long long total = (long long)K * X * Y * Z;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  const Solids so{occ, {sv0, sv1, sv2}};
  if (occ != nullptr)
    advect_kernel<true><<<blocks, THREADS, 0, st>>>(posq, v0, v1, v2, so, out_p, out_d, max_sq, dt, K, d, g[0],
                                                    g[1], g[2]);
  else
    advect_kernel<false><<<blocks, THREADS, 0, st>>>(posq, v0, v1, v2, so, out_p, out_d, max_sq, dt, K, d, g[0],
                                                     g[1], g[2]);
  return static_cast<int>(cudaGetLastError());
}

BLUB_EXPORT int g2p_correct_launch(const int* posq, const float* c0, const float* c1, const float* c2,
                                   const int8_t* marker, int* out_p, int K, int X, int Y, int Z, cudaStream_t st) {
  Grid d{X, Y, Z};
  float g[3];
  gmax(X, Y, Z, g);
  const long long total = (long long)K * X * Y * Z;
  correct_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(posq, c0, c1, c2, marker, out_p,
                                                                                  K, d, g[0], g[1], g[2]);
  return static_cast<int>(cudaGetLastError());
}
