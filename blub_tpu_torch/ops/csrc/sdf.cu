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
// Bits: every evaluated pair's arithmetic follows the plain version's order
// (dot products as u0*v0 + u1*v1 + u2*v2, the va*s >= 0 face test, the clip
// of t, the ray origin nudged by EPS_Y and EPS_Z in f32, the |area| < 1e-20
// guard, x = ((e2*a.x + e3*b.x) + e1*c.x) / area). Built with -fmad=false
// and IEEE division and sqrt (ops/cuda.py), so no operation is contracted
// or approximated. The result is a minimum over the triangles and a crossing
// count, both independent of the order of the triangles, and the minimum
// propagates NaN as np.minimum and torch.minimum do. Three reuses that
// change no bit: AB's and AC's numerators dot(p - a, ab) and dot(p - a, ac)
// are d1 and d2 (products commute); the plane distance is divided out only
// for pairs inside the face region (elsewhere the plain version discards it
// for +inf).
//
// What bounds it: operations. Per pair 139 f32 operations (118 for the
// distance part, 21 for the ray part), two or three of them IEEE divisions
// (ops/sdf.py::OPS_*). Brute force (this kernel's first design) spent them
// on every pair. This design evaluates only the pairs that box bounds cannot
// rule out, and the same bits follow from two facts: a pair whose computed
// squared distance is at least a point's running minimum cannot lower it,
// and a pair whose yz projection the ray does not hit adds no crossing.
//
// Design. Four launches. bounds_kernel gives each triangle its bounds (the
// box, the margin's coefficients G2, H, A, the yz box widened by the ray's
// band), a Morton key of its box's centre and the pair's per-triangle terms
// (Tri, once per triangle); after a sort of those keys (ops/sdf.py::prepare),
// unite_kernel puts the triangles' bounds and terms into that order and
// unites the bounds of each group of 32 and of each tile of 32 groups;
// keys_kernel gives each point its Morton key, and a sort of them orders the
// points, so that a warp's 32 points make a compact box and a group of 32
// consecutive triangles a compact patch. In the points' raster order (a
// warp: half a row of the grid) the kernel took 1.6-1.7x as long on the
// bunny and the icospheres, more than the points' sort costs. Every warp
// works alone (no block barrier: warps whose points need different
// triangles never wait for each other). It visits the tiles outward from
// the one nearest its box, testing 32 tiles at a time (a lane per tile), inside a needed
// tile its groups (a lane per group) the least bound first, inside a needed
// group its triangles (a lane per triangle). At each level a unit is skipped
// unless the warp's box comes near enough for the warp's largest running
// minimum and, then, some lane's own point for its own minimum. In a group
// the warp stages the needed triangles' terms into its own shared memory,
// takes the least bound first while it has no finite minimum yet, then lets
// every lane test its point against each candidate and evaluates the union.
// A lane skips a ray part whose widened yz box misses its own ray origin.
// The largest running minimum of a warp is a __reduce_max_sync over the bits
// of non-negative floats, where a NaN is larger than every number, so that
// NaN never lets a pair be skipped. Two earlier forms lost to this one in
// per-phase cycle counts of an instrumented build: tiles staged for a whole
// block made its warps wait for each other at every tile, and candidates
// tested one at a time through chains of warp reductions stalled on them.
//
// The distance bound. Let u = 2^-24, W a warp's point box, T a triangle's
// box, D the distance from W to T, and R an upper bound of the distance from
// any point of W to any corner of a skippable triangle (to skip_box, the box
// of them, rounded up). For a point p in W and any pair that is not flagged,
// the computed squared distance c is at least
//     L = D^2 - (G2 R^4 + H R^2 + A R),
//     G2 = (256 u f)^2,  f = s |ab| |ac| / |n|^2 (s the longest edge),
//     H = 64 u + 96 u / sin A,  A = 36 u C (C the largest |corner coordinate|),
// and a pair is skipped only where L (computed as written, in f32; at the
// coarser levels with a box and coefficients that contain the pair's)
// exceeds a running minimum that is at least the point's own. Derivation, to first order in u (the
// constants carry a factor 2 over it, for the second-order terms and the
// f32 evaluation of L itself):
// - Segments. Each segment's computed closest point s0 + t*dir, t clipped
//   to [0, 1], lies within 5uC of T per axis; each of the five roundings of
//   (p - q) and its squared norm costs a factor (1 - u). So
//   c_seg >= D^2 - 5uR^2 - 17.3uCR.
// - Face. By Binet-Cauchy, va = n.(bp x cp) and cyclically, so va + vb + vc
//   = |n|^2 and va/|n|^2 is the barycentric coordinate of p's projection.
//   Each computed d_i has an error below 5u|edge||p - corner|, so each
//   computed v an error E < 25u|ab||ac|R^2. If the face test passes, with
//   either computed sign s, every barycentric coordinate is at least -2E/|n|^2,
//   so the projection lies within delta = 4 s E / |n|^2 = 100 u f R^2 of the
//   triangle, and the plane distance h has h^2 >= D^2 - delta^2. The computed
//   normal deviates by 1.8 u / sin A of |n| (its cross product cancels), so
//   the computed d_face >= h^2 - (21u + 48u / sin A) R^2.
// - A flag (G2 = inf, an infinite box) marks what these bounds do not cover:
//   a non-finite corner or one beyond WILD = 2^26 (past which products can
//   overflow), a zero-length edge (distance 0 everywhere), dot(n, n) below
//   2e-18 (the pair clamps it at 1e-20) and slivers whose smallest angle has
//   sin^2 < 2^-20 (their margins are as large as their boxes). A group or
//   tile with a flagged triangle has G2 = inf and is never skipped (the sort
//   puts flagged triangles last, in groups of their own). A point with a
//   coordinate beyond WILD or non-finite (NaN: its result is NaN) makes its
//   warp evaluate every pair.
// The ray bound. A hit needs the three computed edge terms e_i strictly of
// one sign. Each e_i = ey*(qz - z_i) - ez*(qy - y_i) is computed with an
// error below 4.01u |edge_i| |q - corner_i| (Cauchy-Schwarz), where q =
// (qy, qz) is the nudged origin as computed, which the skip test uses too.
// With sigma = |n_x| / (2 s_yz^2) (s_yz the longest projected edge; sigma is
// at most the sine of half the projected triangle's smallest angle), a
// point at distance r outside the projection has some edge term of the
// wrong sign by at least |edge| r sigma, so a false hit needs
// r < kappa s_yz / (sigma - kappa), kappa = 8u, and the reversed sign is
// impossible for sigma >= 4 kappa. The yz box is widened by that width; below
// 4 kappa the ray part is never skipped, and where the corners share y or
// share z exactly no pair ever hits (one term's factor is exactly 0, the
// others' signs are those of the cyclic edge differences, never all alike),
// so the box is empty. Tests: tests/test_torch_sdf.py holds the rule
// (ops/sdf.py::pair_bounds) against every pair's plain squared distance and
// hit on adversarial meshes; the card tests hold the kernel's bits.
//
// Shared memory: a warp's staged group of terms, 4 KB (32 KB a block).
#include <math.h>

#include "common.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define GROUP 32    // triangles per group (ops/sdf.py::GROUP): a lane each
#define FIELDS 13   // ops/sdf.py::FIELDS: lo[3], hi[3], G2, H, A, ylo, yhi, zlo, zhi
#define F_LO 0
#define F_HI 3
#define F_G2 6
#define F_H 7
#define F_A 8
#define F_YLO 9
#define F_YHI 10
#define F_ZLO 11
#define F_ZHI 12
#define TILE_FIELDS 19  // ops/sdf.py::TILE_FIELDS: a tile's FIELDS, then the box of its skippable triangles
#define F_SLO 13
#define F_SHI 16
#define FULL 0xffffffffu

#define EPS_Y 3.53163e-5f
#define EPS_Z 7.07271e-5f
#define TINY 1e-20f
#define WILD 67108864.f                    // 2^26
#define ROUND_UP 1.00000095367431640625f  // 1 + 2^-20

struct __align__(16) Tri {  // 32 floats, 128 bytes
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

__device__ void triangle_terms(Tri& t, const float* __restrict__ verts, const int* __restrict__ tris, int k) {
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

// the pair's distance part: its squared distance into best
__device__ __forceinline__ void distance_part(const Tri& t, const float* p, float& best) {
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
}

// the pair's ray part: +x ray crossing in the yz plane
__device__ __forceinline__ void ray_part(const Tri& t, const float* p, float qy, float qz, int& crossings) {
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

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// the squared distance from the box [lo, hi] to the boxes of bounds b
// (stride apart), in ops/sdf.py::pair_bounds's order
__device__ __forceinline__ float box_d2(const float* lo, const float* hi, const float* b, int stride) {
  float g[3];
  for (int k = 0; k < 3; ++k)
    g[k] = fmaxf(fmaxf(b[(F_LO + k) * stride] - hi[k], lo[k] - b[(F_HI + k) * stride]), 0.f);
  return g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
}

// the squared distance from the point p to the box [lo, hi]
__device__ __forceinline__ float point_box_d2(const float* p, const float* lo, const float* hi) {
  float g[3];
  for (int k = 0; k < 3; ++k) g[k] = fmaxf(fmaxf(lo[k] - p[k], p[k] - hi[k]), 0.f);
  return g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
}

// whether the ray origins of [qylo, qyhi] x [qzlo, qzhi] may meet the
// widened yz boxes of bounds b
__device__ __forceinline__ bool meets(float qylo, float qyhi, float qzlo, float qzhi, const float* b, int stride) {
  return !(qyhi < b[F_YLO * stride] || qylo > b[F_YHI * stride] || qzhi < b[F_ZLO * stride] ||
           qzlo > b[F_ZHI * stride]);
}

// a float's bits as an unsigned key in the float's order (-inf least)
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the v-th group a warp visits: start, start + 1, start - 1, start + 2, ...
__device__ __forceinline__ int visit(int v, int start, int nt) {
  const int below = start, above = nt - 1 - start, m = min(below, above);
  if (v <= 2 * m) return (v & 1) ? start + (v + 1) / 2 : start - v / 2;
  return above > below ? start + (v - m) : start - (v - m);
}

// one group of GROUP triangles for a warp: the distance parts its lanes'
// points need (the least bound first while the warp has no finite minimum,
// then the union of each lane's own tests) and its ray parts; the group's
// terms staged into the warp's shared memory
__device__ __forceinline__ void group_pass(Tri* __restrict__ st, const Tri* __restrict__ terms,
                                           const float* __restrict__ tb, int n_tris, int base, bool dist_group,
                                           bool ray_group, bool wild, bool wild_me, const float* p, float qy,
                                           float qz, const float* lo, const float* hi, float qylo, float qyhi,
                                           float qzlo, float qzhi, float r, float r2, float r4, int lane,
                                           float& best, float& wmax, int& crossings) {
  const int m = min(GROUP, n_tris - base);
  const float* bg = tb + base;  // the group's bounds, field-major with stride n_tris
  bool need_ray = false;
  unsigned key = ~0u;  // the lane's triangle's warp bound as an ordered key; NaN first
  float mj = 0.f;      // its margin at the warp's R
  float tlo[3] = {0.f, 0.f, 0.f}, thi[3] = {0.f, 0.f, 0.f};
  if (lane < m) {
    const float* b = bg + lane;
    for (int k = 0; k < 3; ++k) {
      tlo[k] = b[(F_LO + k) * n_tris];
      thi[k] = b[(F_HI + k) * n_tris];
    }
    mj = b[F_G2 * n_tris] * r4 + b[F_H * n_tris] * r2 + b[F_A * n_tris] * r;
    const float lj = box_d2(lo, hi, b, n_tris) - mj;
    need_ray = ray_group && (wild || meets(qylo, qyhi, qzlo, qzhi, b, n_tris));
    if (dist_group && (wild || !(lj > wmax))) key = lj != lj ? 0u : order_key(lj);
  }
  if (!__any_sync(FULL, key != ~0u || need_ray)) return;
  __syncwarp();  // the previous group's terms are read
  if (lane < m) {
    const float4* src = reinterpret_cast<const float4*>(terms + base + lane);
    float4* dst = reinterpret_cast<float4*>(st + lane);
    for (int q = 0; q < 8; ++q) dst[q] = src[q];
  }
  __syncwarp();
  // while the warp has no finite minimum yet (its first pairs), the least
  // bound first, one at a time
  while (!(wmax < INFINITY) && __any_sync(FULL, key != ~0u)) {
    const unsigned least = __reduce_min_sync(FULL, key);
    const int b = __ffs(__ballot_sync(FULL, key == least)) - 1;
    distance_part(st[b], p, best);
    if (lane == b) key = ~0u;
    wmax = __uint_as_float(__reduce_max_sync(FULL, __float_as_uint(best)));
  }
  // then every lane tests its own point against each candidate left (its
  // bound at the warp's margin against its own minimum), and the warp
  // evaluates the union
  if (!wild && key != ~0u && key != 0u && from_order_key(key) > wmax) key = ~0u;
  const unsigned cand = __ballot_sync(FULL, key != ~0u);
  unsigned mine = wild ? cand : 0u;
  if (!wild)
    for (unsigned c = cand; c; c &= c - 1) {
      const int b = __ffs(c) - 1;
      float blo[3], bhi[3];
      for (int k = 0; k < 3; ++k) {
        blo[k] = __shfl_sync(FULL, tlo[k], b);
        bhi[k] = __shfl_sync(FULL, thi[k], b);
      }
      if (!(point_box_d2(p, blo, bhi) - __shfl_sync(FULL, mj, b) > best)) mine |= 1u << b;
    }
  for (unsigned need = __reduce_or_sync(FULL, mine); need; need &= need - 1) {
    distance_part(st[__ffs(need) - 1], p, best);
  }
  wmax = __uint_as_float(__reduce_max_sync(FULL, __float_as_uint(best)));
  for (unsigned rays = __ballot_sync(FULL, need_ray); rays; rays &= rays - 1) {
    const int b = __ffs(rays) - 1;
    const float* c = bg + b;
    if (wild_me || !(qy < c[F_YLO * n_tris] || qy > c[F_YHI * n_tris] || qz < c[F_ZLO * n_tris] ||
                     qz > c[F_ZHI * n_tris])) {
      ray_part(st[b], p, qy, qz, crossings);
    }
  }
}

__global__ void __launch_bounds__(THREADS) sdf_kernel(const Tri* __restrict__ terms, int n_tris,
                                                      const float* __restrict__ tb, const float* __restrict__ groups,
                                                      int n_groups, const float* __restrict__ tiles, int n_tiles,
                                                      const float* __restrict__ points,
                                                      const long long* __restrict__ order, float* __restrict__ out,
                                                      int n) {
  __shared__ Tri s_tri[WARPS][GROUP];  // each warp's staged group
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const bool live = i < n;
  const long long src = order[live ? i : n - 1];  // a lane past the end repeats the last point
  float p[3];
  for (int k = 0; k < 3; ++k) p[k] = points[3LL * src + k];
  const float qy = p[1] + EPS_Y, qz = p[2] + EPS_Z;  // the ray's nudged origin (x unchanged)
  const bool wild_me = !(fabsf(p[0]) <= WILD && fabsf(p[1]) <= WILD && fabsf(p[2]) <= WILD);
  const bool wild = __any_sync(FULL, wild_me);

  // the box of every triangle that may be skipped (ops/sdf.py::skip_box),
  // from the tiles' own
  float box[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k = lane; k < n_tiles; k += 32)
    for (int d = 0; d < 3; ++d) {
      box[d] = fminf(box[d], tiles[(F_SLO + d) * n_tiles + k]);
      box[3 + d] = fmaxf(box[3 + d], tiles[(F_SHI + d) * n_tiles + k]);
    }
  // the warp's box of points and of ray origins; R, R^2, R^4 rounded up
  float lo[3], hi[3];
  for (int k = 0; k < 3; ++k) {
    box[k] = warp_min(box[k]);
    box[3 + k] = warp_max(box[3 + k]);
    lo[k] = warp_min(p[k]);
    hi[k] = warp_max(p[k]);
  }
  const float qylo = warp_min(qy), qyhi = warp_max(qy), qzlo = warp_min(qz), qzhi = warp_max(qz);
  float e[3];
  for (int k = 0; k < 3; ++k) e[k] = fmaxf(hi[k] - box[k], box[3 + k] - lo[k]);
  const float r2 = (e[0] * e[0] + e[1] * e[1] + e[2] * e[2]) * ROUND_UP;
  const float r = sqrtf(r2) * ROUND_UP;
  const float r4 = r2 * r2 * ROUND_UP;

  // the tile nearest the warp's box
  unsigned long long near = ~0ull;
  for (int k = lane; k < n_tiles; k += 32) {
    const float d2 = box_d2(lo, hi, tiles + k, n_tiles);
    near = min(near, (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) | static_cast<unsigned>(k));
  }
  for (int o = 16; o; o >>= 1) near = min(near, __shfl_xor_sync(FULL, near, o));
  const int start = static_cast<int>(near & 0xffffffffu);

  float best = INFINITY, wmax = INFINITY;
  int crossings = 0;
  // this lane's tile of the warp's batch of 32: its box, its margin at the
  // warp's R, the warp's bound and whether the warp's ray origins meet it
  float klo[3] = {0.f, 0.f, 0.f}, khi[3] = {0.f, 0.f, 0.f}, k_m = 0.f, k_bound = 0.f;
  bool k_meets = true;
  for (int v = 0; v < n_tiles; ++v) {
    const int u = v & 31;
    if (u == 0 && v + lane < n_tiles) {
      const float* tk = tiles + visit(v + lane, start, n_tiles);
      for (int k = 0; k < 3; ++k) {
        klo[k] = tk[(F_LO + k) * n_tiles];
        khi[k] = tk[(F_HI + k) * n_tiles];
      }
      k_m = tk[F_G2 * n_tiles] * r4 + tk[F_H * n_tiles] * r2 + tk[F_A * n_tiles] * r;
      k_bound = box_d2(lo, hi, tk, n_tiles) - k_m;
      k_meets = meets(qylo, qyhi, qzlo, qzhi, tk, n_tiles);
    }
    const bool ray_tile = wild || __shfl_sync(FULL, static_cast<int>(k_meets), u);
    bool dist_tile = wild;
    if (!wild && !(__shfl_sync(FULL, k_bound, u) > wmax)) {
      // and some lane's own point's bound does not exceed its own minimum
      float blo[3], bhi[3];
      for (int k = 0; k < 3; ++k) {
        blo[k] = __shfl_sync(FULL, klo[k], u);
        bhi[k] = __shfl_sync(FULL, khi[k], u);
      }
      dist_tile = __any_sync(FULL, !(point_box_d2(p, blo, bhi) - __shfl_sync(FULL, k_m, u) > best));
    }
    if (!dist_tile && !ray_tile) continue;
    // the tile's groups, a lane each: the warp's tests, then each lane's own
    const int g0 = visit(v, start, n_tiles) * GROUP, ng = min(GROUP, n_groups - g0);
    float glo[3] = {0.f, 0.f, 0.f}, ghi[3] = {0.f, 0.f, 0.f}, g_m = 0.f, g_bound = INFINITY;
    bool g_meets = false;
    if (lane < ng) {
      const float* gk = groups + g0 + lane;
      for (int k = 0; k < 3; ++k) {
        glo[k] = gk[(F_LO + k) * n_groups];
        ghi[k] = gk[(F_HI + k) * n_groups];
      }
      g_m = gk[F_G2 * n_groups] * r4 + gk[F_H * n_groups] * r2 + gk[F_A * n_groups] * r;
      g_bound = box_d2(lo, hi, gk, n_groups) - g_m;
      g_meets = ray_tile && (wild || meets(qylo, qyhi, qzlo, qzhi, gk, n_groups));
    }
    // its groups' distance parts, the least warp bound first, until it
    // exceeds the warp's largest running minimum; then the groups left
    // whose ray parts the warp's origins may need
    unsigned gkey = lane < ng && dist_tile && (wild || !(g_bound > wmax)) ? (g_bound != g_bound ? 0u : order_key(g_bound))
                                                                           : ~0u;
    unsigned rays_left = __ballot_sync(FULL, g_meets);
    while (true) {
      int b;
      bool dist_group = false;
      if (__any_sync(FULL, gkey != ~0u)) {
        const unsigned least = __reduce_min_sync(FULL, gkey);
        b = __ffs(__ballot_sync(FULL, gkey == least)) - 1;
        if (lane == b) gkey = ~0u;
        if (!wild && least != 0u && from_order_key(least) > wmax) {
          gkey = ~0u;  // and every group after it
          continue;
        }
        dist_group = true;
        if (!wild) {  // some lane's own point's bound does not exceed its own minimum
          float blo[3], bhi[3];
          for (int k = 0; k < 3; ++k) {
            blo[k] = __shfl_sync(FULL, glo[k], b);
            bhi[k] = __shfl_sync(FULL, ghi[k], b);
          }
          dist_group = __any_sync(FULL, !(point_box_d2(p, blo, bhi) - __shfl_sync(FULL, g_m, b) > best));
        }
      } else if (rays_left) {
        b = __ffs(rays_left) - 1;
      } else {
        break;
      }
      const bool ray_group = (rays_left >> b) & 1u;
      rays_left &= ~(1u << b);
      if (!dist_group && !ray_group) continue;
      group_pass(s_tri[warp], terms, tb, n_tris, (g0 + b) * GROUP, dist_group, ray_group, wild, wild_me, p, qy, qz,
                 lo, hi, qylo, qyhi, qzlo, qzhi, r, r2, r4, lane, best, wmax, crossings);
    }
  }
  if (live) {
    const float d = sqrtf(best);
    out[src] = (crossings & 1) ? -d : d;
  }
}

// ---------------------------------------------------------------------------
// Each triangle's bounds (ops/sdf.py::triangle_bounds, whose operations it
// repeats in f64 from the f32 corners, each row converted outward to f32)
// and its Morton key: the centre of its f32 box quantized to 10 bits per
// axis over the vertices' box [vlo, vhi] (ops/sdf.py::_morton), flagged triangles
// (G2 or the ray box infinite) at 2^30, after every other.
#define U_ROUND 5.9604644775390625e-08  // 2^-24
#define MIN_SIN2 9.5367431640625e-07    // 2^-20
#define MIN_N2 2e-18
#define RAY_KAPPA (8.0 * U_ROUND)
#define RAY_MIN_SIGMA (4.0 * RAY_KAPPA)
#define G2_UP 1.0000002384185791015625  // 1 + 2^-22

__device__ __forceinline__ long long spread10(unsigned v) {
  long long r = 0;
  for (int b = 0; b < 10; ++b) r |= static_cast<long long>((v >> b) & 1u) << (3 * b);
  return r;
}

__device__ __forceinline__ unsigned quantize10(float x, float lo, float hi) {
  float d = hi - lo;
  d = d < 1e-30f ? 1e-30f : d;  // torch.clamp(min=1e-30): NaN stays NaN
  float q = (x - lo) * (1023.f / d);
  q = q != q ? 0.f : fminf(fmaxf(q, 0.f), 1023.f);
  return static_cast<unsigned>(q);
}

__global__ void bounds_kernel(const float* __restrict__ verts, const int* __restrict__ tris, int n_tris,
                              const float* __restrict__ vlo, const float* __restrict__ vhi, float* __restrict__ tb,
                              long long* __restrict__ key,
                              Tri* __restrict__ terms) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_tris) return;
  triangle_terms(terms[k], verts, tris, k);
  float c[3][3];
  for (int i = 0; i < 3; ++i)
    for (int d = 0; d < 3; ++d) c[i][d] = verts[3LL * tris[3LL * k + i] + d];
  double ab[3], ac[3], bc[3];
  bool finite = true;
  double big = 0.0;
  for (int d = 0; d < 3; ++d) {
    ab[d] = static_cast<double>(c[1][d]) - static_cast<double>(c[0][d]);
    ac[d] = static_cast<double>(c[2][d]) - static_cast<double>(c[0][d]);
    bc[d] = static_cast<double>(c[2][d]) - static_cast<double>(c[1][d]);
    for (int i = 0; i < 3; ++i) {
      finite = finite && isfinite(c[i][d]);
      big = fmax(big, fabs(static_cast<double>(c[i][d])));
    }
  }
  const double l_ab = ab[0] * ab[0] + ab[1] * ab[1] + ab[2] * ab[2];
  const double l_ac = ac[0] * ac[0] + ac[1] * ac[1] + ac[2] * ac[2];
  const double l_bc = bc[0] * bc[0] + bc[1] * bc[1] + bc[2] * bc[2];
  const double nx = ab[1] * ac[2] - ab[2] * ac[1];
  const double ny = ab[2] * ac[0] - ab[0] * ac[2];
  const double nz = ab[0] * ac[1] - ab[1] * ac[0];
  const double n2 = nx * nx + ny * ny + nz * nz;
  const bool tame = finite && big <= static_cast<double>(WILD);
  const double p01 = l_ab * l_ac, p02 = l_ab * l_bc, p12 = l_ac * l_bc;
  const bool keep = tame && fmin(l_ab, fmin(l_ac, l_bc)) > 0.0 && n2 >= MIN_N2 &&
                    n2 >= MIN_SIN2 * fmax(p01, fmax(p02, p12));
  const double safe = keep ? n2 : 1.0;
  const double f = sqrt(fmax(l_ab, fmax(l_ac, l_bc)) * p01) / safe;  // s |ab| |ac| / |n|^2
  const double q = (256.0 * U_ROUND) * f;
  const double g2 = keep ? q * q : INFINITY;
  const double h = keep ? 64.0 * U_ROUND + (96.0 * U_ROUND) * sqrt(p01 / safe) : 0.0;
  const double a_coef = keep ? (36.0 * U_ROUND) * (tame ? big : 0.0) : 0.0;
  float flo[3], fhi[3];
  for (int d = 0; d < 3; ++d) {
    flo[d] = fminf(c[0][d], fminf(c[1][d], c[2][d]));
    fhi[d] = fmaxf(c[0][d], fmaxf(c[1][d], c[2][d]));
  }
  // the ray: the exact f32 yz edges, as the pair computes them
  float ey[3], ez[3];
  for (int i = 0; i < 3; ++i) {
    ey[i] = c[(i + 1) % 3][1] - c[i][1];
    ez[i] = c[(i + 1) % 3][2] - c[i][2];
  }
  const bool never = finite && ((ey[0] == 0.f && ey[1] == 0.f && ey[2] == 0.f) ||
                                (ez[0] == 0.f && ez[1] == 0.f && ez[2] == 0.f));
  double syz2 = 0.0;
  for (int i = 0; i < 3; ++i) {
    const double y = ey[i], z = ez[i];
    syz2 = fmax(syz2, y * y + z * z);
  }
  const double sigma = fabs(nx) / (syz2 > 0.0 ? 2.0 * syz2 : 1.0);
  const bool ray_ok = tame && !never && sigma >= RAY_MIN_SIGMA;
  const double w = RAY_KAPPA * sqrt(syz2) / (ray_ok ? sigma - RAY_KAPPA : 1.0);
  double ray[4];
  for (int j = 0; j < 2; ++j) {
    const double rlo = ray_ok ? static_cast<double>(flo[1 + j]) - w : -INFINITY;
    const double rhi = ray_ok ? static_cast<double>(fhi[1 + j]) + w : INFINITY;
    ray[2 * j] = never ? INFINITY : rlo;
    ray[2 * j + 1] = never ? -INFINITY : rhi;
  }
  float row[FIELDS];
  for (int d = 0; d < 3; ++d) {
    row[F_LO + d] = keep ? flo[d] : -INFINITY;
    row[F_HI + d] = keep ? fhi[d] : INFINITY;
  }
  row[F_G2] = __double2float_ru(g2 * G2_UP);
  row[F_H] = __double2float_ru(h);
  row[F_A] = __double2float_ru(a_coef);
  row[F_YLO] = __double2float_rd(ray[0]);
  row[F_YHI] = __double2float_ru(ray[1]);
  row[F_ZLO] = __double2float_rd(ray[2]);
  row[F_ZHI] = __double2float_ru(ray[3]);
  for (int fi = 0; fi < FIELDS; ++fi) tb[static_cast<long long>(fi) * n_tris + k] = row[fi];
  long long kk = 1LL << 30;
  if (!isinf(row[F_G2]) && row[F_YLO] != -INFINITY) {
    kk = 0;
    for (int d = 0; d < 3; ++d)
      kk |= spread10(quantize10((row[F_LO + d] + row[F_HI + d]) * 0.5f, vlo[d], vhi[d])) << d;
  }
  key[k] = kk;
}

// Each point's Morton key (ops/sdf.py::point_keys): its coordinates
// quantized to 10 bits per axis over the points' box [lo, hi].
__global__ void keys_kernel(const float* __restrict__ points, int n, const float* __restrict__ lo,
                            const float* __restrict__ hi, int* __restrict__ key) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long kk = 0;
  for (int d = 0; d < 3; ++d) kk |= spread10(quantize10(points[3 * i + d], lo[d], hi[d])) << d;
  key[i] = static_cast<int>(kk);
}

// ---------------------------------------------------------------------------
// The triangles in their Morton order and the bounds of their groups and
// tiles (ops/sdf.py::unite): a block per tile, a warp per group, a lane per
// triangle. A group's bounds are its triangles' least lows and largest highs
// and coefficients (the fill below past the last triangle); a tile's, its
// groups', and the box of its skippable triangles (G2 finite), from which
// sdf_kernel takes skip_box. The bounds hold no NaN (flags make them
// infinite), so fminf and fmaxf give np.minimum's and np.maximum's bits.
__device__ __forceinline__ bool least_field(int f) { return f < F_HI || f == F_YLO || f == F_ZLO; }

__device__ __forceinline__ float fill_field(int f) {  // ops/sdf.py::_GROUP_FILL
  if (f < F_G2) return f < F_HI ? INFINITY : -INFINITY;
  if (f < F_YLO) return 0.f;
  return least_field(f) ? INFINITY : -INFINITY;
}

__global__ void __launch_bounds__(GROUP * GROUP) unite_kernel(const float* __restrict__ tb_in,
                                                                const Tri* __restrict__ terms_in,
                                                                const long long* __restrict__ perm, int n_tris,
                                                                float* __restrict__ tb, Tri* __restrict__ terms,
                                                                float* __restrict__ groups, int n_groups,
                                                                float* __restrict__ tiles, int n_tiles) {
  __shared__ float s_group[GROUP][TILE_FIELDS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = blockIdx.x * GROUP + w;
  const long long j = static_cast<long long>(g) * GROUP + lane;
  const bool live = j < n_tris;
  const long long k = live ? perm[j] : 0;
  if (live) {
    const float4* src = reinterpret_cast<const float4*>(terms_in + k);
    float4* dst = reinterpret_cast<float4*>(terms + j);
    for (int q = 0; q < 8; ++q) dst[q] = src[q];
  }
  float row[TILE_FIELDS];
#pragma unroll
  for (int f = 0; f < FIELDS; ++f) {
    row[f] = live ? tb_in[f * static_cast<long long>(n_tris) + k] : fill_field(f);
    if (live) tb[f * static_cast<long long>(n_tris) + j] = row[f];
  }
  const bool skippable = live && isfinite(row[F_G2]);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    row[F_SLO + d] = skippable ? row[F_LO + d] : INFINITY;
    row[F_SHI + d] = skippable ? row[F_HI + d] : -INFINITY;
  }
#pragma unroll
  for (int f = 0; f < TILE_FIELDS; ++f) {
    row[f] = (f < FIELDS ? least_field(f) : f < F_SHI) ? warp_min(row[f]) : warp_max(row[f]);
    if (lane == 0) {
      s_group[w][f] = row[f];
      if (f < FIELDS && g < n_groups) groups[f * n_groups + g] = row[f];
    }
  }
  __syncthreads();
  if (w == 0)
    for (int f = 0; f < TILE_FIELDS; ++f) {
      const float x = s_group[lane][f];
      const float y = (f < FIELDS ? least_field(f) : f < F_SHI) ? warp_min(x) : warp_max(x);
      if (lane == 0) tiles[f * n_tiles + blockIdx.x] = y;
    }
}

// verts f32 [V, 3], tris i32 [T, 3] (indices in [0, V)), vlo and vhi f32[3]
// the vertices' box; tb f32 [13, T], key i64 [T] and terms f32 [T, 32] (Tri)
// receive the bounds, the keys and the per-triangle terms
BLUB_EXPORT int sdf_bounds_launch(const float* verts, const int* tris, int n_tris, const float* vlo, const float* vhi,
                                  float* tb, long long* key, float* terms, cudaStream_t st) {
  if (n_tris <= 0) return static_cast<int>(cudaErrorInvalidValue);
  bounds_kernel<<<(n_tris + 127) / 128, 128, 0, st>>>(verts, tris, n_tris, vlo, vhi, tb, key,
                                                      reinterpret_cast<Tri*>(terms));
  return static_cast<int>(cudaGetLastError());
}

// tb_in f32 [13, T] and terms_in f32 [T, 32] (bounds_kernel's), perm i64 [T]
// (the Morton order: the j-th triangle is perm[j]); tb, terms, groups f32
// [13, G = ceil(T / 32)] and tiles f32 [19, ceil(G / 32)] receive the
// triangles' bounds and terms in that order and the groups' and tiles' bounds
BLUB_EXPORT int sdf_unite_launch(const float* tb_in, const float* terms_in, const long long* perm, int n_tris,
                                 float* tb, float* terms, float* groups, int n_groups, float* tiles, int n_tiles,
                                 cudaStream_t st) {
  if (n_tris <= 0 || n_groups != (n_tris + GROUP - 1) / GROUP || n_tiles != (n_groups + GROUP - 1) / GROUP)
    return static_cast<int>(cudaErrorInvalidValue);
  unite_kernel<<<n_tiles, GROUP * GROUP, 0, st>>>(tb_in, reinterpret_cast<const Tri*>(terms_in), perm, n_tris, tb,
                                                  reinterpret_cast<Tri*>(terms), groups, n_groups, tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// points f32 [n, 3], lo and hi f32[3] their box; key i32 [n] receives the
// points' Morton keys
BLUB_EXPORT int sdf_keys_launch(const float* points, int n, const float* lo, const float* hi, int* key,
                                cudaStream_t st) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  keys_kernel<<<(n + 255) / 256, 256, 0, st>>>(points, n, lo, hi, key);
  return static_cast<int>(cudaGetLastError());
}

// terms f32 [T, 32] (Tri) and tb f32 [13, T] of the triangles in their
// order, groups f32 [13, G = ceil(T / 32)], tiles f32 [19, ceil(G / 32)]
// (unite_kernel's), points f32 [n, 3], order i64 [n] (the kernel's i-th
// point is points[order[i]]), out f32 [n]
BLUB_EXPORT int sdf_launch(const float* terms, int n_tris, const float* tb, const float* groups, int n_groups,
                           const float* tiles, int n_tiles, const float* points, const long long* order, float* out,
                           int n, cudaStream_t st) {
  if (n <= 0 || n_tris <= 0 || n_groups != (n_tris + GROUP - 1) / GROUP || n_tiles != (n_groups + GROUP - 1) / GROUP)
    return static_cast<int>(cudaErrorInvalidValue);
  sdf_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(reinterpret_cast<const Tri*>(terms), n_tris, tb,
                                                               groups, n_groups, tiles, n_tiles, points, order, out,
                                                               n);
  return static_cast<int>(cudaGetLastError());
}
