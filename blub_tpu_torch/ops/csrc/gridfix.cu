// Grid fix for Hopper: face correction + extrapolation in one pass. Replaces
// the TPU kernel blub_tpu/ops/pallas_gridfix.py::_kernel (def :72,
// pallas_call :253; entries remove_extrapolate_pallas :284 and
// change_extrapolate_pallas :311), both of its with_solids specialisations.
//
// mode 0 (remove): the face value of component c at cell g is vel_c -
// (p_fluid(g) - p_fluid(g+e_c)) at fluid-adjacent faces; a face whose own
// cell is SOLID takes the solid velocity sv_c(g), one whose neighbour is
// SOLID takes sv_c(g+e_c) (pallas_gridfix.py:153-165), and without solids
// (WITH_SOLIDS false, null sv pointers) both are 0. mode 1 (change, never
// with solids): dt * (p_fluid(g+e_c) - p_fluid(g)), 0 at solid faces. A face
// with neither adjacent cell fluid then takes the mean of the valid faces
// among its 8 in-plane neighbours (the extrapolation reads corrected
// values), summed in extrapolate.in_plane_offsets order with a true
// division. Reads outside the domain are zero: marker 0 == SOLID, as
// gridops.shift fills, and solid velocity 0.
//
// What bounds it on the card: bytes. At the dam shape a call must read the 3
// face grids (remove only), the pressure and the marker (6.8-13 MB) and write
// 3 grids (6.3 MB); the solids specialisation also reads the 3
// solid-velocity grids (+6.3 MB). Most faces are extrapolated (the dam's
// fluid fills a quarter of the grid), and each of a face's 8 neighbours'
// corrected values needs two markers, two pressures and a velocity: some 60
// loads a face if each face recomputed them.
//
// The design, after the TPU kernel's windows (_window_copies :38): a block
// owns a tile of TX x 8 x 32 cells (z fastest, a warp on a z row) and all
// three components of it. It stages the marker and the pressure of the tile
// and a one-cell halo in shared memory, zero outside the domain; then, once
// per face of the window, its three components' valid bits (either
// adjacent cell fluid) and corrected values into shared memory (the
// velocity, and with solids the solid velocity, read from the grids only
// for the faces that need them); then each output face is its own value or
// the mean of its valid in-plane neighbours, from shared memory. A window
// with no fluid cell (most of the air) skips both: its faces keep their own
// value, 0. The tile is fixed at compile time, so the window's index
// arithmetic divides by constants.
#include "common.cuh"

#define TX 4  // the tile: TX x TY x TZ cells
#define TY 8
#define TZ 32
#define EX (TX + 2)  // the window: the tile and a one-cell halo
#define EY (TY + 2)
#define EZ (TZ + 2)
#define NE (EX * EY * EZ)
#define GF_THREADS 256

struct Args {
  const float* vel[3];
  const float* p;
  const int8_t* marker;
  float dt;
  int mode, X, Y, Z;
};

// solid velocity planes, apart from Args so the instantiation without
// solids keeps the parameter layout it had; null without solids
struct SolidVel {
  const float* v[3];
};

template <bool WITH_SOLIDS>
__global__ void __launch_bounds__(GF_THREADS) gridfix_kernel(Args a, SolidVel sv, float* out0, float* out1,
                                                             float* out2) {
  __shared__ float pr[NE];     // pressure, 0 outside the domain
  __shared__ float fx[3][NE];  // corrected face values, per component
  __shared__ int8_t mk[NE];    // marker, SOLID (0) outside the domain
  __shared__ uint8_t vb[NE];   // bit c: the face of component c is valid (in the domain)
  const int nbz = (a.Z + TZ - 1) / TZ, nby = (a.Y + TY - 1) / TY;
  const int bz = blockIdx.x % nbz, by = (blockIdx.x / nbz) % nby, bx = blockIdx.x / (nbz * nby);
  const int x0 = bx * TX - 1, y0 = by * TY - 1, z0 = bz * TZ - 1;  // the window's origin
  const size_t sy = a.Z, sx = (size_t)a.Y * a.Z;
  float* const out[3] = {out0, out1, out2};
  const int st[3] = {EY * EZ, EZ, 1};  // window strides

  bool fluid = false;
  for (int j = threadIdx.x; j < NE; j += GF_THREADS) {
    const int gx = x0 + j / (EY * EZ), gy = y0 + j / EZ % EY, gz = z0 + j % EZ;
    const bool in = gx >= 0 && gx < a.X && gy >= 0 && gy < a.Y && gz >= 0 && gz < a.Z;
    const size_t g = gx * sx + gy * sy + gz;
    const int8_t m = in ? a.marker[g] : (int8_t)CELL_SOLID;
    mk[j] = m;
    pr[j] = in ? a.p[g] : 0.f;
    fluid = fluid || m == CELL_FLUID;
  }
  if (!__syncthreads_or(fluid)) {
    // no fluid in the window: every face of the tile is invalid with no
    // valid neighbour, so it keeps its own value: 0, or (0 - 0) * dt in
    // mode change away from solids
    const float zc = (0.f - 0.f) * a.dt;
    for (int j = threadIdx.x; j < TX * TY * TZ; j += GF_THREADS) {
      const int lx = j / (TY * TZ) + 1, ly = j / TZ % TY + 1, lz = j % TZ + 1;
      const int gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
      if (gx >= a.X || gy >= a.Y || gz >= a.Z) continue;
      const int h = (lx * EY + ly) * EZ + lz;
      const size_t g = gx * sx + gy * sy + gz;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[c][g] = a.mode == 0 || mk[h] == CELL_SOLID || mk[h + st[c]] == CELL_SOLID ? 0.f : zc;
    }
    return;
  }

  // every face of the window with its +c neighbour in it: valid bits and
  // corrected values
  for (int j = threadIdx.x; j < NE; j += GF_THREADS) {
    const int l[3] = {j / (EY * EZ), j / EZ % EY, j % EZ};
    const int gx = x0 + l[0], gy = y0 + l[1], gz = z0 + l[2];
    const bool in = gx >= 0 && gx < a.X && gy >= 0 && gy < a.Y && gz >= 0 && gz < a.Z;
    const size_t g = gx * sx + gy * sy + gz;
    const int m = mk[j];
    const bool fl = m == CELL_FLUID;
    const float pf = fl ? pr[j] : 0.f;
    uint8_t bits = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (l[c] == (c == 0 ? EX : (c == 1 ? EY : EZ)) - 1) continue;  // the +c neighbour is outside the window
      const int nm = mk[j + st[c]];
      const bool nfl = nm == CELL_FLUID;
      const float npf = nfl ? pr[j + st[c]] : 0.f;  // shift(p_fluid) masked by nbr fluid
      float v = 0.f;
      if (in) {
        if (a.mode == 0) {
          if (fl || nfl) {
            if (m == CELL_SOLID) {
              if constexpr (WITH_SOLIDS) v = sv.v[c][g];
            } else if (nm == CELL_SOLID) {
              const int gc = c == 0 ? gx : (c == 1 ? gy : gz), dim = c == 0 ? a.X : (c == 1 ? a.Y : a.Z);
              if constexpr (WITH_SOLIDS)
                if (gc + 1 < dim) v = sv.v[c][g + (c == 0 ? sx : (c == 1 ? sy : 1))];  // 0 outside the domain
            } else {
              v = a.vel[c][g] - (pf - npf);
            }
          }
        } else {
          const float change = (npf - pf) * a.dt;
          v = (m == CELL_SOLID || nm == CELL_SOLID) ? 0.f : change;
        }
        if (fl || nfl) bits |= 1u << c;
      }
      fx[c][j] = v;
    }
    vb[j] = bits;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < TX * TY * TZ; j += GF_THREADS) {
    const int lx = j / (TY * TZ) + 1, ly = j / TZ % TY + 1, lz = j % TZ + 1;
    const int gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    if (gx >= a.X || gy >= a.Y || gz >= a.Z) continue;
    const int h = (lx * EY + ly) * EZ + lz;
    const size_t g = gx * sx + gy * sy + gz;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if ((vb[h] >> c) & 1u) {
        out[c][g] = fx[c][h];
        continue;
      }
      // in-plane offsets in extrapolate.in_plane_offsets order: u over the
      // lower other axis, w over the higher, each -1, 0, 1, skipping (0, 0)
      const int su = st[c == 0 ? 1 : 0], sw = st[c == 2 ? 1 : 2];
      float num = 0.f, avg = 0.f;
#pragma unroll
      for (int u = -1; u <= 1; ++u)
#pragma unroll
        for (int w = -1; w <= 1; ++w) {
          if (u == 0 && w == 0) continue;
          const int hn = h + u * su + w * sw;
          if (!((vb[hn] >> c) & 1u)) continue;
          num = num + 1.f;
          avg = avg + fx[c][hn];
        }
      out[c][g] = num > 0.f ? avg / num : fx[c][h];
    }
  }
}

// sv0 == nullptr selects the specialisation without solids; mode 1 takes
// no solids
BLUB_EXPORT int gridfix_launch(const float* v0, const float* v1, const float* v2, const float* sv0,
                               const float* sv1, const float* sv2, const float* p, const int8_t* marker,
                               float* out0, float* out1, float* out2, float dt, int mode, int X, int Y, int Z,
                               cudaStream_t st) {
  if (sv0 != nullptr && mode != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{{v0, v1, v2}, p, marker, dt, mode, X, Y, Z};
  SolidVel sv{{sv0, sv1, sv2}};
  const int blocks = ((X + TX - 1) / TX) * ((Y + TY - 1) / TY) * ((Z + TZ - 1) / TZ);
  if (sv0 != nullptr)
    gridfix_kernel<true><<<blocks, GF_THREADS, 0, st>>>(a, sv, out0, out1, out2);
  else
    gridfix_kernel<false><<<blocks, GF_THREADS, 0, st>>>(a, sv, out0, out1, out2);
  return static_cast<int>(cudaGetLastError());
}
