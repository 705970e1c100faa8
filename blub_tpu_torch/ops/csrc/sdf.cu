// Mesh signed-distance bake for Hopper: the distance from each point to a
// triangle mesh, negated where a +x ray from the point crosses the mesh an
// odd number of times. It runs once per solid object at scene load, over the
// fluid grid extended by the object's translation range.
//
// Replaces no TPU kernel. It is the counterpart of the JAX package's host
// helper native/blub_native.cpp::sdf_worker / blub_mesh_sdf (:49-102,
// :109-130, multithreaded C++ loaded by blub_tpu/ops/native.py), whose plain
// version is blub_tpu/core/models.py::_point_tri_dist2 + _ray_parity. The
// port's plain version is ops/sdf.py::mesh_sdf_plain.
//
// Bits: every pair's arithmetic follows the plain version's order (dot
// products as u0*v0 + u1*v1 + u2*v2, the va*s >= 0 face test, the clip of
// t, the ray origin nudged by EPS_Y and EPS_Z in f32, the |area| < 1e-20
// guard, x = ((e2*a.x + e3*b.x) + e1*c.x) / area). Built with -fmad=false and
// IEEE division and sqrt (ops/cuda.py), so no operation is contracted or
// approximated. The result is a minimum over the triangles and a crossing
// count, both independent of the order of the triangles, so the kernel gives
// the plain version's bits. The minimum propagates NaN as np.minimum and
// torch.minimum do. Three reuses that change no bit: the segment AB's and
// AC's numerators dot(p - a, ab) and dot(p - a, ac) are d1 and d2 (products
// commute); the plane distance is divided out only for pairs inside the face
// region (elsewhere the plain version discards it for +inf).
//
// What bounds it on the card: operations. Per pair 139 f32 operations, two
// or three of them IEEE divisions, 7 more inside the face region and 12 more
// where the ray's yz projection hits (ops/sdf.py::OPS_PER_PAIR, ops), against
// 16 bytes per point and 36 per triangle. Design: one thread per point,
// THREADS points per block; the triangles are staged through shared memory
// in tiles of TILE, with their per-triangle terms (edges, normal and its
// clamped square norm, clamped segment lengths, the ray test's yz edge
// terms) computed once per tile by exactly the plain version's operations
// for its [1, T] terms. Every thread of a warp reads the same triangle, a
// broadcast. No TMA or wgmma: the work is scalar f32 arithmetic.
#include <math.h>

#include "common.cuh"

#define THREADS 256
#define TILE THREADS  // triangles per shared tile: one staged per thread

#define EPS_Y 3.53163e-5f
#define EPS_Z 7.07271e-5f
#define TINY 1e-20f

struct Tri {        // 32 floats, 128 bytes
  float a[3], b[3], c[3];
  float ab[3], ac[3], bc[3];
  float n[3];       // cross(ab, ac)
  float n2;         // max(dot(n, n), 1e-20)
  float ab2, ac2, bc2;  // max(dot(e, e), 1e-20) of the three segments
  float ey[3], ez[3];   // the ray test's edge terms: (b - a), (c - b), (a - c) in y and z
  float pad;
};

__device__ __forceinline__ float dot3(const float* u, const float* v) {
  return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
}

// np.maximum(x, 1e-20): NaN stays NaN
__device__ __forceinline__ float clamp_tiny(float x) { return x < TINY ? TINY : x; }

// np.minimum: NaN in either gives NaN
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }

// np.sign(np.where(d == 0, 1, d)): 1, -1, or NaN for NaN
__device__ __forceinline__ float face_sign(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : (d == 0.f ? 1.f : d));
}

__device__ void stage(Tri& t, const float* __restrict__ verts, const int* __restrict__ tris, int k) {
  const int i0 = tris[3 * k], i1 = tris[3 * k + 1], i2 = tris[3 * k + 2];
  for (int d = 0; d < 3; ++d) {
    t.a[d] = verts[3 * i0 + d];
    t.b[d] = verts[3 * i1 + d];
    t.c[d] = verts[3 * i2 + d];
  }
  for (int d = 0; d < 3; ++d) {
    t.ab[d] = t.b[d] - t.a[d];
    t.ac[d] = t.c[d] - t.a[d];
    t.bc[d] = t.c[d] - t.b[d];
  }
  t.n[0] = t.ab[1] * t.ac[2] - t.ab[2] * t.ac[1];
  t.n[1] = t.ab[2] * t.ac[0] - t.ab[0] * t.ac[2];
  t.n[2] = t.ab[0] * t.ac[1] - t.ab[1] * t.ac[0];
  t.n2 = clamp_tiny(dot3(t.n, t.n));
  t.ab2 = clamp_tiny(dot3(t.ab, t.ab));
  t.ac2 = clamp_tiny(dot3(t.ac, t.ac));
  t.bc2 = clamp_tiny(dot3(t.bc, t.bc));
  t.ey[0] = t.b[1] - t.a[1];
  t.ez[0] = t.b[2] - t.a[2];
  t.ey[1] = t.c[1] - t.b[1];
  t.ez[1] = t.c[2] - t.b[2];
  t.ey[2] = t.a[1] - t.c[1];
  t.ez[2] = t.a[2] - t.c[2];
  t.pad = 0.f;
}

// squared distance from p to the segment s0 + [0, 1] * dir, given
// num = dot(p - s0, dir) and len2 = max(dot(dir, dir), 1e-20)
__device__ __forceinline__ float seg_d2(const float* p, const float* s0, const float* dir, float num, float len2) {
  float t = num / len2;
  t = t < 0.f ? 0.f : t;  // np.clip(t, 0, 1): NaN stays NaN
  t = t > 1.f ? 1.f : t;
  float d[3];
  for (int k = 0; k < 3; ++k) d[k] = p[k] - (s0[k] + t * dir[k]);
  return dot3(d, d);
}

__global__ void __launch_bounds__(THREADS) sdf_kernel(const float* __restrict__ verts, const int* __restrict__ tris,
                                                      int n_tris, const float* __restrict__ points,
                                                      float* __restrict__ out, int n) {
  __shared__ Tri tile[TILE];
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const bool live = i < n;
  float p[3] = {0.f, 0.f, 0.f};
  if (live) {
    for (int k = 0; k < 3; ++k) p[k] = points[3 * i + k];
  }
  const float qy = p[1] + EPS_Y, qz = p[2] + EPS_Z;  // the ray's nudged origin (x unchanged)
  float best = INFINITY;
  int crossings = 0;
  for (int base = 0; base < n_tris; base += TILE) {
    const int m = min(TILE, n_tris - base);
    __syncthreads();  // the previous tile is read
    if (threadIdx.x < m) stage(tile[threadIdx.x], verts, tris, base + threadIdx.x);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < m; ++j) {
      const Tri& t = tile[j];
      float ap[3], bp[3], cp[3];
      for (int k = 0; k < 3; ++k) {
        ap[k] = p[k] - t.a[k];
        bp[k] = p[k] - t.b[k];
        cp[k] = p[k] - t.c[k];
      }
      const float d1 = dot3(t.ab, ap), d2 = dot3(t.ac, ap);
      const float d3 = dot3(t.ab, bp), d4 = dot3(t.ac, bp);
      const float d5 = dot3(t.ab, cp), d6 = dot3(t.ac, cp);
      const float va = d3 * d6 - d5 * d4;
      const float vb = d5 * d2 - d1 * d6;
      const float vc = d1 * d4 - d3 * d2;
      const float s = face_sign(va + vb + vc);
      float d_face = INFINITY;
      if (va * s >= 0.f && vb * s >= 0.f && vc * s >= 0.f) {
        const float pn = dot3(ap, t.n);
        d_face = pn * pn / t.n2;
      }
      const float d_ab = seg_d2(p, t.a, t.ab, d1, t.ab2);
      const float d_ac = seg_d2(p, t.a, t.ac, d2, t.ac2);
      const float d_bc = seg_d2(p, t.b, t.bc, dot3(bp, t.bc), t.bc2);
      best = min_nan(best, min_nan(min_nan(d_face, d_ab), min_nan(d_ac, d_bc)));

      // +x ray crossing in the yz plane
      const float e1 = t.ey[0] * (qz - t.a[2]) - t.ez[0] * (qy - t.a[1]);
      const float e2 = t.ey[1] * (qz - t.b[2]) - t.ez[1] * (qy - t.b[1]);
      const float e3 = t.ey[2] * (qz - t.c[2]) - t.ez[2] * (qy - t.c[1]);
      if ((e1 < 0.f && e2 < 0.f && e3 < 0.f) || (e1 > 0.f && e2 > 0.f && e3 > 0.f)) {
        float area = e1 + e2 + e3;
        if (fabsf(area) < TINY) area = TINY;
        const float x = (e2 * t.a[0] + e3 * t.b[0] + e1 * t.c[0]) / area;
        crossings += x > p[0];
      }
    }
  }
  if (live) {
    const float d = sqrtf(best);
    out[i] = (crossings & 1) ? -d : d;
  }
}

// verts f32 [V, 3], tris i32 [T, 3] (indices in [0, V)), points f32 [n, 3],
// out f32 [n]
BLUB_EXPORT int sdf_launch(const float* verts, const int* tris, int n_tris, const float* points, float* out, int n,
                           cudaStream_t st) {
  if (n <= 0 || n_tris <= 0) return static_cast<int>(cudaErrorInvalidValue);
  sdf_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(verts, tris, n_tris, points, out, n);
  return static_cast<int>(cudaGetLastError());
}
