// Grid fix for Hopper: face correction + extrapolation in one pass. Replaces
// the TPU kernel blub_tpu/ops/pallas_gridfix.py::_kernel (def :72,
// pallas_call :253; entries remove_extrapolate_pallas :284 and
// change_extrapolate_pallas :311), both of its with_solids specialisations.
//
// One thread per (face component c, cell g). mode 0 (remove): the face value
// is vel_c - (p_fluid(g) - p_fluid(g+e_c)) at fluid-adjacent faces; a face
// whose own cell is SOLID takes the solid velocity sv_c(g), one whose
// neighbour is SOLID takes sv_c(g+e_c) (pallas_gridfix.py:153-165), and
// without solids (WITH_SOLIDS false, null sv pointers) both are 0. mode 1
// (change, never with solids): dt * (p_fluid(g+e_c) - p_fluid(g)), 0 at
// solid faces. A face with neither adjacent cell fluid then takes the mean
// of the valid faces among its 8 in-plane neighbours, whose corrected values
// the thread recomputes (the extrapolation reads corrected values). Reads
// outside the domain are zero: marker 0 == SOLID, as gridops.shift fills,
// and solid velocity 0.
//
// What bounds it on the card: bytes. At the dam shape a call reads 3 face
// grids (remove only), the pressure and the marker (6.8-13 MB) and writes 3
// grids (6.3 MB); the solids specialisation also reads the 3 solid-velocity
// grids (+6.3 MB). The recomputed neighbours re-read cached neighbours, so
// device memory sees about one pass.
#include "common.cuh"

struct Args {
  const float* vel[3];
  const float* p;
  const int8_t* marker;
  float dt;
  int mode, X, Y, Z;
};

__device__ __forceinline__ bool inside(const Args& a, int x, int y, int z) {
  return x >= 0 && x < a.X && y >= 0 && y < a.Y && z >= 0 && z < a.Z;
}
__device__ __forceinline__ int idx(const Args& a, int x, int y, int z) { return (x * a.Y + y) * a.Z + z; }
__device__ __forceinline__ int mk(const Args& a, int x, int y, int z) {
  return inside(a, x, y, z) ? (int)a.marker[idx(a, x, y, z)] : CELL_SOLID;
}

// solid velocity planes, apart from Args so the instantiation without
// solids keeps the parameter layout it had; null without solids
struct SolidVel {
  const float* v[3];
};

// solid velocity component c at (x,y,z), zero outside the domain
__device__ __forceinline__ float svr(const Args& a, const SolidVel& sv, int c, int x, int y, int z) {
  return inside(a, x, y, z) ? sv.v[c][idx(a, x, y, z)] : 0.f;
}

// corrected face value of component c at in-domain cell (x,y,z)
template <bool WITH_SOLIDS>
__device__ float fixed(const Args& a, const SolidVel& sv, int c, int x, int y, int z) {
  const int e[3] = {c == 0, c == 1, c == 2};
  const int i = idx(a, x, y, z);
  const int m = a.marker[i];
  const int nx = x + e[0], ny = y + e[1], nz = z + e[2];
  const int nm = mk(a, nx, ny, nz);
  const bool fluid = m == CELL_FLUID, nfluid = nm == CELL_FLUID;
  const float pf = fluid ? a.p[i] : 0.f;
  const float npf = nfluid ? a.p[idx(a, nx, ny, nz)] : 0.f;  // shift(p_fluid) masked by nbr fluid
  if (a.mode == 0) {
    const float corrected = a.vel[c][i] - (pf - npf);
    float v;
    if constexpr (WITH_SOLIDS)
      v = m == CELL_SOLID ? sv.v[c][i] : (nm == CELL_SOLID ? svr(a, sv, c, nx, ny, nz) : corrected);
    else
      v = m == CELL_SOLID ? 0.f : (nm == CELL_SOLID ? 0.f : corrected);
    return (fluid || nfluid) ? v : 0.f;
  }
  const float change = (npf - pf) * a.dt;
  return (m == CELL_SOLID || nm == CELL_SOLID) ? 0.f : change;
}

template <bool WITH_SOLIDS>
__global__ void gridfix_kernel(Args a, SolidVel sv, float* out0, float* out1, float* out2) {
  const int n = a.X * a.Y * a.Z;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (i >= n) return;
  const int z = i % a.Z, y = (i / a.Z) % a.Y, x = i / (a.Y * a.Z);
  const int e[3] = {c == 0, c == 1, c == 2};
  float* out = c == 0 ? out0 : (c == 1 ? out1 : out2);
  const bool fluid = a.marker[i] == CELL_FLUID;
  const bool nfluid = mk(a, x + e[0], y + e[1], z + e[2]) == CELL_FLUID;
  if (fluid || nfluid) {
    out[i] = fixed<WITH_SOLIDS>(a, sv, c, x, y, z);
    return;
  }
  // in-plane offsets in extrapolate.in_plane_offsets order: u over the
  // lower other axis, v over the higher, each -1, 0, 1, skipping (0, 0)
  const int o0 = c == 0 ? 1 : 0, o1 = c == 2 ? 1 : 2;
  float num = 0.f, avg = 0.f;
  for (int u = -1; u <= 1; ++u)
    for (int v = -1; v <= 1; ++v) {
      if (u == 0 && v == 0) continue;
      int off[3] = {0, 0, 0};
      off[o0] = u;
      off[o1] = v;
      const int sx = x + off[0], sy = y + off[1], sz = z + off[2];
      if (!inside(a, sx, sy, sz)) continue;
      const bool valid = mk(a, sx, sy, sz) == CELL_FLUID || mk(a, sx + e[0], sy + e[1], sz + e[2]) == CELL_FLUID;
      if (!valid) continue;
      num = num + 1.f;
      avg = avg + fixed<WITH_SOLIDS>(a, sv, c, sx, sy, sz);
    }
  out[i] = num > 0.f ? avg / num : fixed<WITH_SOLIDS>(a, sv, c, x, y, z);
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
  const int n = X * Y * Z, threads = 256;
  dim3 grid((n + threads - 1) / threads, 3);
  if (sv0 != nullptr)
    gridfix_kernel<true><<<grid, threads, 0, st>>>(a, sv, out0, out1, out2);
  else
    gridfix_kernel<false><<<grid, threads, 0, st>>>(a, sv, out0, out1, out2);
  return static_cast<int>(cudaGetLastError());
}
