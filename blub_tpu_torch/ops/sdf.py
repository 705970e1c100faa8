"""Mesh signed-distance bake: the distance from each point to a triangle
mesh, negated where a +x ray from the point crosses the mesh an odd number
of times (the counterpart of ``native/blub_native.cpp::blub_mesh_sdf``, the
JAX package's host helper, whose plain version is
``blub_tpu/core/models.py::_point_tri_dist2`` + ``_ray_parity``).

``mesh_sdf`` takes the plain version for CPU tensors and launches
``csrc/sdf.cu`` for CUDA tensors (one launch, counted as ``sdf``). Both give
the same bits: the kernel repeats the plain version's arithmetic per pair in
the same order. The ray's origin is nudged in y and z so that points on a
shared edge's projection (voxel centres on a cube face's diagonal) do not
fall between both triangles' strict in-tests.

A degenerate triangle (a zero-length edge) gives distance 0 at every point,
as in the JAX package: its face test passes everywhere and its normal is 0.
"""

from __future__ import annotations

import torch

from . import cuda
from .g2p import _sqrt_rn

_P, _I = cuda.P, cuda.I
_SIG = {"sdf_launch": [_P, _P, _I, _P, _P, _I, _P]}

EPS_Y = 3.53163e-5  # the ray origin's nudge in y and z, added in f32
EPS_Z = 7.07271e-5
TINY = 1e-20  # the floor of squared lengths and of |area|, in f32

# f32 operations per (point, triangle) pair that every pair needs, each
# counted once: the three corner offsets (9), six dot products (30), va, vb,
# vc (9), their sum (2), the face sign and test (2 + 6), three segments
# (AB and AC 17 each, their numerators being d1 and d2: divide 1, clip 2,
# projection 6, difference 3, square norm 5; BC 22, its numerator a dot of
# bp), the four minima (4), three yz edge terms (15) and the crossing test
# (6). Two terms are needed only by some pairs and are counted per such
# pair (``pair_work``): the plane distance (dot, square, divide: 7) inside
# the face region, and the crossing's x (area 2, its guard 2, x 6, the
# compare and the count 2) where the yz projection hits.
OPS_PER_PAIR = 9 + 30 + 9 + 2 + 8 + 17 + 17 + 22 + 4 + 15 + 6
OPS_PER_FACE = 7
OPS_PER_HIT = 12
# per point: the nudge (2), sqrt and sign (2); per triangle: edges (9), the
# normal (9), four clamped square norms (24), the yz edge terms (6)
OPS_PER_POINT = 4
OPS_PER_TRIANGLE = 48


def mesh_sdf(verts: torch.Tensor, tris: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Signed distance f32[N] from ``points`` f32[N, 3] to the mesh of
    ``verts`` f32[V, 3] and ``tris`` i32[T, 3], all on one device. Raises
    for a mesh without triangles and for indices outside [0, V) (one read
    of their range, a sync on the card)."""
    if not verts.device == tris.device == points.device:
        raise ValueError(f"mesh_sdf: verts, tris and points on {verts.device}, {tris.device}, {points.device}")
    if tris.shape[0] == 0:
        raise ValueError("mesh_sdf: the mesh has no triangles")
    lo, hi = (int(x) for x in torch.aminmax(tris))
    if lo < 0 or hi >= verts.shape[0]:
        raise ValueError(f"mesh_sdf: triangle indices outside [0, {verts.shape[0]})")
    if not points.is_cuda:
        return mesh_sdf_plain(verts, tris, points)
    return launch(verts, tris, points)


def launch(verts: torch.Tensor, tris: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/sdf.cu`` on CUDA tensors (counted as ``sdf``),
    without ``mesh_sdf``'s read of the index range: the indices must lie in
    [0, V)."""
    n, t = points.shape[0], tris.shape[0]
    if t == 0:
        raise ValueError("mesh_sdf: the mesh has no triangles")
    cuda.require(points, torch.float32, (n, 3), "sdf points")
    cuda.require(verts, torch.float32, (verts.shape[0], 3), "sdf verts")
    cuda.require(tris, torch.int32, (t, 3), "sdf tris")
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    if n == 0:
        return out
    lib = cuda.library("sdf", _SIG)
    P = cuda.ptr
    err = lib.sdf_launch(P(verts), P(tris), t, P(points), P(out), n, cuda.stream())
    cuda.count_launch("sdf")
    cuda.check(lib, err, "sdf")
    return out


def ops(n_points: int, n_tris: int, n_face: int, n_hit: int) -> int:
    """f32 operations a bake of ``n_points`` against ``n_tris`` needs (its
    bound by operations), given its ``pair_work``."""
    return (OPS_PER_PAIR * n_points * n_tris + OPS_PER_FACE * n_face + OPS_PER_HIT * n_hit
            + OPS_PER_POINT * n_points + OPS_PER_TRIANGLE * n_tris)


def pair_work(verts: torch.Tensor, tris: torch.Tensor, points: torch.Tensor):
    """(pairs inside the face region, pairs whose yz projection the ray
    hits) of this bake, from the plain version's tests: the pairs that need
    the plane distance and the crossing's x."""
    face = hit = 0
    for _, p, tt in _blocks(verts, tris, points):
        face += _point_tri_dist2(p, tt)[1].sum()
        hit += _ray_parity(p, tt)[1].sum()
    return int(face), int(hit)


def _dot(u, v):
    """Per-component dot product, summed in ``np.sum(u * v, -1)``'s order."""
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def _triangle_terms(verts, tris):
    """Corners and per-triangle terms as [1, T] rows, computed once."""
    idx = tris.long()
    a, b, c = ([verts[idx[:, k], i][None] for i in range(3)] for k in range(3))
    tiny = torch.tensor(TINY, dtype=torch.float32, device=verts.device)
    ab = [b[i] - a[i] for i in range(3)]
    ac = [c[i] - a[i] for i in range(3)]
    bc = [c[i] - b[i] for i in range(3)]
    n = [ab[1] * ac[2] - ab[2] * ac[1], ab[2] * ac[0] - ab[0] * ac[2], ab[0] * ac[1] - ab[1] * ac[0]]
    return {
        "a": a, "b": b, "c": c, "ab": ab, "ac": ac, "bc": bc, "n": n, "tiny": tiny,
        "n2": torch.maximum(_dot(n, n), tiny),
        "ab2": torch.maximum(_dot(ab, ab), tiny),
        "ac2": torch.maximum(_dot(ac, ac), tiny),
        "bc2": torch.maximum(_dot(bc, bc), tiny),
        # the ray test's edge terms, (b - a), (c - b), (a - c) in y and z
        "ey": [b[1] - a[1], c[1] - b[1], a[1] - c[1]],
        "ez": [b[2] - a[2], c[2] - b[2], a[2] - c[2]],
    }


def _point_tri_dist2(p, tt):
    """Squared distance [n, T] from each point (columns [n, 1]) to each
    triangle, component-wise in ``blub_tpu/core/models.py``'s order, and
    the face-region mask [n, T]."""
    a, b, c, ab, ac = tt["a"], tt["b"], tt["c"], tt["ab"], tt["ac"]
    ap = [p[i] - a[i] for i in range(3)]
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = [p[i] - b[i] for i in range(3)]
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = [p[i] - c[i] for i in range(3)]
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc

    # face region: squared distance to the supporting plane, valid only when
    # the projection's barycentrics are all non-negative; the sign of the
    # denominator as np.sign gives it (1, -1, NaN; torch.sign(NaN) is 0)
    pn = _dot(ap, tt["n"])
    d_plane = pn * pn / tt["n2"]
    one = torch.ones((), dtype=torch.float32, device=p[0].device)
    s = torch.where(denom == 0, one, denom)
    s = torch.where(torch.isnan(s), s, torch.where(s > 0, one, -one))
    inside = (va * s >= 0) & (vb * s >= 0) & (vc * s >= 0)
    d_face = torch.where(inside, d_plane, torch.full_like(d_plane, float("inf")))

    # edge regions: exact segment distances cover every outside case
    def seg(s0, sdir, len2):
        t = _dot([p[i] - s0[i] for i in range(3)], sdir) / len2
        t = torch.clamp(t, 0.0, 1.0)  # NaN stays NaN
        d = [p[i] - (s0[i] + t * sdir[i]) for i in range(3)]
        return _dot(d, d)

    d_ab = seg(a, ab, tt["ab2"])
    d_ac = seg(a, ac, tt["ac2"])
    d_bc = seg(b, tt["bc"], tt["bc2"])
    return torch.minimum(torch.minimum(d_face, d_ab), torch.minimum(d_ac, d_bc)), inside


def _ray_parity(p, tt):
    """+x ray crossing parity per point, from the nudged origin, and the
    mask [n, T] of pairs whose yz projection the ray hits."""
    dev = p[0].device
    qy = p[1] + torch.tensor(EPS_Y, dtype=torch.float32, device=dev)
    qz = p[2] + torch.tensor(EPS_Z, dtype=torch.float32, device=dev)
    a, b, c, ey, ez = tt["a"], tt["b"], tt["c"], tt["ey"], tt["ez"]
    e1 = ey[0] * (qz - a[2]) - ez[0] * (qy - a[1])
    e2 = ey[1] * (qz - b[2]) - ez[1] * (qy - b[1])
    e3 = ey[2] * (qz - c[2]) - ez[2] * (qy - c[1])
    hit = ((e1 < 0) & (e2 < 0) & (e3 < 0)) | ((e1 > 0) & (e2 > 0) & (e3 > 0))
    area = e1 + e2 + e3
    area = torch.where(area.abs() < tt["tiny"], tt["tiny"], area)
    x = (e2 * a[0] + e3 * b[0] + e1 * c[0]) / area
    crossings = (hit & (x > p[0])).sum(dim=1)
    return crossings % 2 == 1, hit


def _blocks(verts, tris, points):
    """The plain version's ``[n, T]`` blocks of pairs (2^20 on the CPU, 2^25
    on the card): (rows, the points' columns [n, 1], the triangle terms)."""
    if tris.shape[0] == 0:
        raise ValueError("mesh_sdf: the mesh has no triangles")
    tt = _triangle_terms(verts, tris)
    chunk = max(1, (1 << (25 if points.is_cuda else 20)) // tris.shape[0])
    for s in range(0, points.shape[0], chunk):
        yield slice(s, s + chunk), [points[s : s + chunk, i, None] for i in range(3)], tt


def mesh_sdf_plain(verts: torch.Tensor, tris: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch bake (f32), block by block, in the order of
    ``blub_tpu/core/models.py``'s numpy bake, whose bits it gives on the
    CPU."""
    out = torch.empty(points.shape[0], dtype=torch.float32, device=points.device)
    for rows, p, tt in _blocks(verts, tris, points):
        dist = _sqrt_rn(_point_tri_dist2(p, tt)[0].amin(dim=1))
        out[rows] = torch.where(_ray_parity(p, tt)[0], -dist, dist)
    return out
