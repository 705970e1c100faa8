"""Mesh signed-distance bake: the distance from each point to a triangle
mesh, negated where a +x ray from the point crosses the mesh an odd number
of times (the counterpart of ``native/blub_native.cpp::blub_mesh_sdf``, the
JAX package's host helper, whose plain version is
``blub_tpu/core/models.py::_point_tri_dist2`` + ``_ray_parity``).

``mesh_sdf`` takes the plain version for CPU tensors and launches
``csrc/sdf.cu`` for CUDA tensors (``bounds_kernel``, ``unite_kernel``,
``keys_kernel`` and ``sdf_kernel``, counted as ``sdf_bounds``,
``sdf_unite``, ``sdf_keys`` and ``sdf``). Both give the same bits: the
kernel repeats the plain version's arithmetic per pair in the same order.
The ray's origin is nudged in y and z so that points on a shared edge's
projection (voxel centres on a cube face's diagonal) do not fall between
both triangles' strict in-tests.

The kernel evaluates only the pairs that box bounds cannot rule out
(``csrc/sdf.cu``'s head comment derives the rule). ``prepare`` puts the
triangles and the points into Morton order (``bounds`` and ``point_keys``,
each followed by a sort of the keys) and unites the bounds of groups and
tiles of GROUP (``unite``); the order changes no bit, since the result is
a minimum and a parity count over the triangles. ``pair_bounds`` is the skip rule per point and triangle with
the kernel's f32 bounds and margins, for the tests and for ``pair_work``,
which counts the pairs that no exact box-pruned bake can skip (the bound
by operations, ``ops``, beside the brute-force count, ``ops_brute``).

A degenerate triangle (a zero-length edge) gives distance 0 at every point,
as in the JAX package: its face test passes everywhere and its normal is 0.
The bounds flag it, so every point evaluates it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda
from .g2p import _sqrt_rn

_P, _I = cuda.P, cuda.I
_SIG = {"sdf_launch": [_P, _I, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P],
        "sdf_bounds_launch": [_P, _P, _I, _P, _P, _P, _P, _P, _P],
        "sdf_unite_launch": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P],
        "sdf_keys_launch": [_P, _I, _P, _P, _P, _P]}

EPS_Y = 3.53163e-5  # the ray origin's nudge in y and z, added in f32
EPS_Z = 7.07271e-5
TINY = 1e-20  # the floor of squared lengths and of |area|, in f32

GROUP = 32  # triangles per group, a lane each
TERMS = 32  # f32 per triangle of the pairs' per-triangle terms (csrc/sdf.cu's Tri)

# The skip rule's constants, derived in csrc/sdf.cu's head comment.
U = 2.0**-24  # the unit roundoff of f32
WILD = 2.0**26  # a point or corner with a larger |coordinate| (or a non-finite one) is never skipped
MIN_SIN2 = 2.0**-20  # a triangle whose smallest angle has a smaller squared sine is flagged
MIN_N2 = 2e-18  # a triangle with a smaller dot(n, n) is flagged (the pair clamps it at 1e-20)
RAY_KAPPA = 8 * U  # the ray test's rounding band, per unit of length from a corner
RAY_MIN_SIGMA = 4 * RAY_KAPPA  # the smallest projected shape factor whose band is bounded
ROUND_UP = 1.0 + 2.0**-20  # rounds a computed f32 length or margin up past its error

# Fields of the bound tables, f32 [FIELDS, triangles] and [FIELDS, groups]:
# the box (LO + axis, HI + axis), the margin's coefficients (G2, H, A) and
# the ray's widened yz box (YLO, YHI, ZLO, ZHI).
LO, HI, G2, H, A, YLO, YHI, ZLO, ZHI = 0, 3, 6, 7, 8, 9, 10, 11, 12
FIELDS = 13
# A tile's bounds add the box (SLO + axis, SHI + axis) of its skippable
# triangles (G2 finite): ``skip_box`` is their union.
SLO, SHI = 13, 16
TILE_FIELDS = 19
_GROUP_MIN = (0, 1, 2, YLO, ZLO)  # a group takes its triangles' least value of these, the largest of the rest
_GROUP_FILL = (float("inf"),) * 3 + (float("-inf"),) * 3 + (0.0,) * 3 + (float("inf"), float("-inf")) * 2

# f32 operations per (point, triangle) pair, each counted once. The
# distance part: the three corner offsets (9), six dot products (30), va,
# vb, vc (9), their sum (2), the face sign and test (2 + 6), three segments
# (AB and AC 17 each, their numerators being d1 and d2: divide 1, clip 2,
# projection 6, difference 3, square norm 5; BC 22, its numerator a dot of
# bp) and the four minima (4). The ray part: three yz edge terms (15) and
# the crossing test (6). Two terms are needed only by some pairs and are
# counted per such pair (``pair_work``): the plane distance (dot, square,
# divide: 7) inside the face region, and the crossing's x (area 2, its
# guard 2, x 6, the compare and the count 2) where the yz projection hits.
OPS_DIST = 9 + 30 + 9 + 2 + 8 + 17 + 17 + 22 + 4
OPS_RAY = 15 + 6
OPS_PER_PAIR = OPS_DIST + OPS_RAY
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
    """The Morton order and the bounds (``prepare``), then the bake's
    launch (``run``) on CUDA tensors, without ``mesh_sdf``'s read of the
    index range: the indices must lie in [0, V)."""
    _require(verts, tris, points)
    if points.shape[0] == 0:
        return torch.empty(0, dtype=torch.float32, device=points.device)
    return run(prepare(verts, tris, points), points)


def _require(verts, tris, points):
    if tris.shape[0] == 0:
        raise ValueError("mesh_sdf: the mesh has no triangles")
    cuda.require(points, torch.float32, (points.shape[0], 3), "sdf points")
    cuda.require(verts, torch.float32, (verts.shape[0], 3), "sdf verts")
    cuda.require(tris, torch.int32, (tris.shape[0], 3), "sdf tris")


def run(prepared, points: torch.Tensor) -> torch.Tensor:
    """The kernel's launch on ``prepare``'s output (counted as ``sdf``)."""
    order, terms, tb, groups, tiles = prepared
    n, t = points.shape[0], terms.shape[0]
    cuda.require(points, torch.float32, (n, 3), "sdf points")
    cuda.require(order, torch.int64, (n,), "sdf order")
    cuda.require(terms, torch.float32, (t, TERMS), "sdf terms")
    cuda.require(tb, torch.float32, (FIELDS, t), "sdf bounds")
    cuda.require(groups, torch.float32, (FIELDS, -(-t // GROUP)), "sdf group bounds")
    cuda.require(tiles, torch.float32, (TILE_FIELDS, -(-groups.shape[1] // GROUP)), "sdf tile bounds")
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    if n == 0:
        return out
    lib = cuda.library("sdf", _SIG)
    P = cuda.ptr
    err = lib.sdf_launch(P(terms), t, P(tb), P(groups), groups.shape[1], P(tiles), tiles.shape[1], P(points),
                         P(order), P(out), n, cuda.stream())
    cuda.count_launch("sdf")
    cuda.check(lib, err, "sdf")
    return out


# ---------------------------------------------------------------------------
# the spatial order and the bounds


def _down(x64: torch.Tensor) -> torch.Tensor:
    """The largest f32 at most ``x64``."""
    f = x64.float()
    return torch.where(f.double() > x64, torch.nextafter(f, torch.full_like(f, float("-inf"))), f)


def _up(x64: torch.Tensor) -> torch.Tensor:
    """The least f32 at least ``x64``."""
    f = x64.float()
    return torch.where(f.double() < x64, torch.nextafter(f, torch.full_like(f, float("inf"))), f)


def triangle_bounds(verts: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Each triangle's bounds, f32 [FIELDS, T] (``csrc/sdf.cu``'s head
    comment derives them; its ``bounds_kernel`` repeats these operations on
    the card): its box, the coefficients of the margin ``G2 R^4 + H R^2 +
    A R`` that its computed squared distances may fall below the box's,
    and its yz box widened by the ray test's rounding band.
    Computed in f64 from the f32 corners, rounded outward to f32. A flagged
    triangle (a corner non-finite or beyond WILD, a zero-length edge, a
    squared sine of its smallest angle below MIN_SIN2, dot(n, n) below
    MIN_N2) gets an infinite box and G2 = inf: it is never skipped. Its
    ray box is infinite too unless its corners share y or z exactly (then
    no ray ever hits it: the box is empty), and so is the ray box of a
    triangle whose projected shape factor is below RAY_MIN_SIGMA."""
    c = verts[tris.long()]  # f32 [T, corner, axis]
    d = c.double()
    a, b, cc = d.unbind(1)
    ab, ac, bc = b - a, cc - a, cc - b
    l2 = torch.stack([_dot(e.unbind(1), e.unbind(1)) for e in (ab, ac, bc)], 1)
    u, v = ab.unbind(1), ac.unbind(1)
    n = [u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0]]
    n2 = _dot(n, n)
    finite = torch.isfinite(c).flatten(1).all(1)
    tame = finite & (d.abs().flatten(1).amax(1) <= WILD)
    big = torch.where(tame, d.abs().flatten(1).amax(1), torch.zeros_like(n2))
    prod = torch.stack([l2[:, 0] * l2[:, 1], l2[:, 0] * l2[:, 2], l2[:, 1] * l2[:, 2]], 1)
    keep = tame & (l2.amin(1) > 0) & (n2 >= MIN_N2) & (n2 >= MIN_SIN2 * prod.amax(1))
    safe = torch.where(keep, n2, torch.ones_like(n2))
    f = torch.sqrt(l2.amax(1) * prod[:, 0]) / safe  # s |ab| |ac| / |n|^2
    q = 256 * U * f
    g2 = torch.where(keep, q * q, torch.full_like(f, float("inf")))
    h = torch.where(keep, 64 * U + 96 * U * torch.sqrt(prod[:, 0] / safe), torch.zeros_like(f))
    big_a = torch.where(keep, 36 * U * big, torch.zeros_like(f))
    inf = torch.full_like(f, float("inf"))
    lo = torch.where(keep[:, None], c.amin(1).double(), -inf[:, None])
    hi = torch.where(keep[:, None], c.amax(1).double(), inf[:, None])

    # the ray: the corners' exact f32 yz edges as the kernel computes them
    ey = c[:, :, 1].roll(-1, 1) - c[:, :, 1]
    ez = c[:, :, 2].roll(-1, 1) - c[:, :, 2]
    never = finite & ((ey == 0).all(1) | (ez == 0).all(1))
    syz2 = (ey.double() * ey.double() + ez.double() * ez.double()).amax(1)
    nx = n[0]
    sigma = nx.abs() / torch.where(syz2 > 0, 2 * syz2, torch.ones_like(syz2))
    ray_ok = tame & ~never & (sigma >= RAY_MIN_SIGMA)
    w = RAY_KAPPA * torch.sqrt(syz2) / torch.where(ray_ok, sigma - RAY_KAPPA, torch.ones_like(sigma))
    box_lo, box_hi = c.amin(1).double(), c.amax(1).double()
    ray = []
    for k in (1, 2):
        rlo = torch.where(ray_ok, box_lo[:, k] - w, -inf)
        rhi = torch.where(ray_ok, box_hi[:, k] + w, inf)
        ray += [torch.where(never, inf, rlo), torch.where(never, -inf, rhi)]
    rows = [_down(lo[:, k]) for k in range(3)] + [_up(hi[:, k]) for k in range(3)]
    rows += [_up(g2 * (1 + 2.0**-22)), _up(h), _up(big_a)]
    rows += [_down(ray[0]), _up(ray[1]), _down(ray[2]), _up(ray[3])]
    return torch.stack(rows)


def skip_box(tb: torch.Tensor) -> torch.Tensor:
    """f32[6]: the box (lo, hi) of every triangle that may be skipped (G2
    finite); the margin's R is the largest distance from a point to it."""
    ok = torch.isfinite(tb[G2])
    lo = torch.where(ok, tb[LO : LO + 3], float("inf")).amin(1)
    hi = torch.where(ok, tb[HI : HI + 3], float("-inf")).amax(1)
    return torch.cat([lo, hi])


def group_bounds(tb: torch.Tensor) -> torch.Tensor:
    """f32 [FIELDS, ceil(T / GROUP)]: each group's union of its triangles'
    bounds (least lows, largest highs and coefficients); of the groups'
    bounds, each tile's (GROUP groups)."""
    t = tb.shape[1]
    ng = -(-t // GROUP)
    fill = torch.tensor(_GROUP_FILL, dtype=torch.float32, device=tb.device)[:, None]
    x = torch.cat([tb, fill.expand(FIELDS, ng * GROUP - t)], 1).view(FIELDS, ng, GROUP)
    is_min = torch.tensor([k in _GROUP_MIN for k in range(FIELDS)], device=tb.device)[:, None]
    return torch.where(is_min, x.amin(2), x.amax(2))


def tile_skip_boxes(tb: torch.Tensor) -> torch.Tensor:
    """f32 [6, ceil(T / GROUP^2)]: each tile's ``skip_box``."""
    t = tb.shape[1]
    nt = -(-t // GROUP**2)
    ok = torch.isfinite(tb[G2])
    lo = torch.where(ok, tb[LO : LO + 3], float("inf"))
    hi = torch.where(ok, tb[HI : HI + 3], float("-inf"))
    pad = nt * GROUP**2 - t
    lo = torch.cat([lo, lo.new_full((3, pad), float("inf"))], 1).view(3, nt, -1).amin(2)
    hi = torch.cat([hi, hi.new_full((3, pad), float("-inf"))], 1).view(3, nt, -1).amax(2)
    return torch.cat([lo, hi])


def unite(tb: torch.Tensor, tt: torch.Tensor, perm: torch.Tensor):
    """The triangles in the order ``perm`` (int64 [T]): their terms f32 [T,
    TERMS] and bounds f32 [FIELDS, T], their groups' bounds
    (``group_bounds``) and their tiles' f32 [TILE_FIELDS, ceil(G /
    GROUP)]: the groups' ``group_bounds``, then ``tile_skip_boxes``.
    ``csrc/sdf.cu``'s ``unite_kernel`` on CUDA tensors (one launch, counted
    as ``sdf_unite``), the plain version on CPU tensors; the same bits."""
    if not tb.is_cuda:
        return unite_plain(tb, tt, perm)
    t = tb.shape[1]
    ng = -(-t // GROUP)
    nt = -(-ng // GROUP)
    cuda.require(tb, torch.float32, (FIELDS, t), "sdf bounds")
    cuda.require(tt, torch.float32, (t, TERMS), "sdf terms")
    cuda.require(perm, torch.int64, (t,), "sdf triangle order")
    dev = tb.device
    out_tt = torch.empty(t, TERMS, dtype=torch.float32, device=dev)
    out_tb = torch.empty(FIELDS, t, dtype=torch.float32, device=dev)
    groups = torch.empty(FIELDS, ng, dtype=torch.float32, device=dev)
    tiles = torch.empty(TILE_FIELDS, nt, dtype=torch.float32, device=dev)
    lib = cuda.library("sdf", _SIG)
    P = cuda.ptr
    err = lib.sdf_unite_launch(P(tb), P(tt), P(perm), t, P(out_tb), P(out_tt), P(groups), ng, P(tiles), nt,
                               cuda.stream())
    cuda.count_launch("sdf_unite")
    cuda.check(lib, err, "sdf_unite")
    return out_tt, out_tb, groups, tiles


def unite_plain(tb: torch.Tensor, tt: torch.Tensor, perm: torch.Tensor):
    """``unite``'s plain version."""
    tb = tb[:, perm]
    groups = group_bounds(tb)
    return tt[perm], tb, groups, torch.cat([group_bounds(groups), tile_skip_boxes(tb)])


def _morton(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton keys (int64) of the rows of ``x`` f32 [m, 3], each axis
    quantized to 10 bits over [lo, hi] (outside values clamped, NaN as 0),
    as ``csrc/sdf.cu``'s ``quantize10`` and ``spread10`` compute them."""
    def make():
        v = torch.arange(1024, dtype=torch.int64)
        spread = sum(((v >> i) & 1) << (3 * i) for i in range(10))
        return torch.stack([spread << k for k in range(3)])

    table = make().to(x.device)  # [3, 1024], axis k shifted by k
    d = torch.clamp(hi - lo, min=1e-30)
    q = ((x - lo) * (torch.full_like(d, 1023.0) / d)).nan_to_num(0.0).clamp(0, 1023).long()
    return table.gather(1, q.T).sum(0)


def bounds(verts: torch.Tensor, tris: torch.Tensor):
    """Each triangle's bounds (``triangle_bounds``, f32 [FIELDS, T]), Morton
    key (int64 [T]: the centre of its box over the vertices' box, flagged
    triangles at 2^30) and the pairs' per-triangle terms (``terms``, f32
    [T, TERMS]): ``csrc/sdf.cu``'s ``bounds_kernel`` on CUDA tensors (one
    launch, counted as ``sdf_bounds``), the plain version on CPU tensors;
    the same bits."""
    vlo, vhi = torch.aminmax(verts, dim=0)
    if not verts.is_cuda:
        return bounds_plain(verts, tris, vlo, vhi)
    t = tris.shape[0]
    tb = torch.empty(FIELDS, t, dtype=torch.float32, device=verts.device)
    key = torch.empty(t, dtype=torch.int64, device=verts.device)
    tt = torch.empty(t, TERMS, dtype=torch.float32, device=verts.device)
    lib = cuda.library("sdf", _SIG)
    P = cuda.ptr
    err = lib.sdf_bounds_launch(P(verts), P(tris), t, P(vlo), P(vhi), P(tb), P(key), P(tt), cuda.stream())
    cuda.count_launch("sdf_bounds")
    cuda.check(lib, err, "sdf_bounds")
    return tb, key, tt


def bounds_plain(verts: torch.Tensor, tris: torch.Tensor, vlo: torch.Tensor, vhi: torch.Tensor):
    """``bounds``' plain version, given the vertices' box [vlo, vhi] (f32[3]
    each)."""
    tb = triangle_bounds(verts, tris)
    centre = (tb[LO : LO + 3] + tb[HI : HI + 3]) * 0.5
    flagged = ~torch.isfinite(tb[G2]) | (tb[YLO] == float("-inf"))
    return tb, torch.where(flagged, 1 << 30, _morton(centre.T, vlo, vhi)), terms(verts, tris)


def terms(verts: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """The pairs' per-triangle terms, f32 [T, TERMS] in the order of
    ``csrc/sdf.cu``'s ``Tri``: the corners a, b, c, the edges ab, ac, bc,
    the normal n, dot(n, n), ab's, ac's and bc's squared lengths (each
    clamped at 1e-20), the yz edge terms and a zero."""
    tt = _triangle_terms(verts, tris)
    rows = [*tt["a"], *tt["b"], *tt["c"], *tt["ab"], *tt["ac"], *tt["bc"], *tt["n"], tt["n2"], tt["ab2"],
            tt["ac2"], tt["bc2"], *tt["ey"], *tt["ez"], torch.zeros_like(tt["n2"])]
    return torch.cat(rows).T.contiguous()


def point_keys(points: torch.Tensor) -> torch.Tensor:
    """Each point's 30-bit Morton key (int32 [n]) over the points' box:
    ``csrc/sdf.cu``'s ``keys_kernel`` on CUDA tensors (one launch, counted
    as ``sdf_keys``), ``_morton`` on CPU tensors; the same bits."""
    lo, hi = torch.aminmax(points, dim=0)
    if not points.is_cuda:
        return _morton(points, lo, hi).int()
    n = points.shape[0]
    cuda.require(points, torch.float32, (n, 3), "sdf points")
    key = torch.empty(n, dtype=torch.int32, device=points.device)
    lib = cuda.library("sdf", _SIG)
    err = lib.sdf_keys_launch(cuda.ptr(points), n, cuda.ptr(lo), cuda.ptr(hi), cuda.ptr(key), cuda.stream())
    cuda.count_launch("sdf_keys")
    cuda.check(lib, err, "sdf_keys")
    return key


def prepare(verts: torch.Tensor, tris: torch.Tensor, points: torch.Tensor):
    """The kernel's inputs beside the points: the points' Morton order
    (int64 [n]: the kernel's i-th point is ``points[order[i]]``), and, for
    the triangles in Morton order of their box centres (flagged ones last),
    ``unite``'s terms, bounds, groups and tiles."""
    tb, key, tt = bounds(verts, tris)
    return (torch.argsort(point_keys(points)), *unite(tb, tt, torch.argsort(key)))


def pair_bounds(p, tb: torch.Tensor, box: torch.Tensor):
    """The kernel's skip tests for single points (columns [n, 1] of ``p``)
    against triangles (the rows [T] of ``tb``), f32 in the kernel's order:
    the lower bound L [n, T] of each pair's computed squared distance (the
    kernel skips the distance part only where L exceeds its best so far),
    the mask [n, T] of pairs whose nudged ray origin lies in the widened yz
    box (it skips the ray part outside), and the points that are never
    skipped (a coordinate non-finite or beyond WILD) [n, 1]."""
    dev = p[0].device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    up, zero = f32(ROUND_UP), f32(0.0)
    e = [torch.maximum(p[k] - box[k], box[3 + k] - p[k]) for k in range(3)]
    r2 = ((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]) * up
    r = _sqrt_rn(r2) * up
    r4 = r2 * r2 * up
    g = [torch.maximum(torch.maximum(tb[LO + k] - p[k], p[k] - tb[HI + k]), zero) for k in range(3)]
    d2 = (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]
    bound = d2 - ((tb[G2] * r4 + tb[H] * r2) + tb[A] * r)
    qy, qz = p[1] + f32(EPS_Y), p[2] + f32(EPS_Z)
    inside = ~((qy < tb[YLO]) | (qy > tb[YHI]) | (qz < tb[ZLO]) | (qz > tb[ZHI]))
    wild = ~((p[0].abs() <= WILD) & (p[1].abs() <= WILD) & (p[2].abs() <= WILD))
    return bound, inside | wild, wild


class Work(NamedTuple):
    """A bake's pairs by the work they need: ``face`` and ``hit`` over all
    pairs (the brute-force count's terms); ``needed``, the pairs whose
    distance part no exact box-pruned bake can skip (their bound at most
    the point's final squared distance, or a point never skipped);
    ``needed_face``, those of them inside the face region; ``inside``, the
    pairs whose ray origin lies in the widened yz box (hits among them)."""

    points: int
    triangles: int
    face: int
    hit: int
    needed: int
    needed_face: int
    inside: int


def pair_work(verts: torch.Tensor, tris: torch.Tensor, points: torch.Tensor) -> Work:
    """This bake's ``Work``, from the plain version's tests and
    ``pair_bounds``."""
    tb = triangle_bounds(verts, tris)
    box = skip_box(tb)
    face = hit = needed = needed_face = inside = 0
    for _, p, tt in _blocks(verts, tris, points):
        d2, in_face = _point_tri_dist2(p, tt)
        bound, in_box, wild = pair_bounds(p, tb, box)
        need = ~(bound > d2.amin(1, keepdim=True)) | wild
        face += in_face.sum()
        hit += _ray_parity(p, tt)[1].sum()
        needed += need.sum()
        needed_face += (need & in_face).sum()
        inside += in_box.sum()
    return Work(points.shape[0], tris.shape[0], *(int(x) for x in (face, hit, needed, needed_face, inside)))


def ops(w: Work) -> int:
    """f32 operations a bake needs (its bound by operations): the distance
    part of the needed pairs, the ray part of the pairs inside the yz box."""
    return (OPS_DIST * w.needed + OPS_PER_FACE * w.needed_face + OPS_RAY * w.inside + OPS_PER_HIT * w.hit
            + OPS_PER_POINT * w.points + OPS_PER_TRIANGLE * w.triangles)


def ops_brute(w: Work) -> int:
    """f32 operations of the brute-force bake: every pair."""
    return (OPS_PER_PAIR * w.points * w.triangles + OPS_PER_FACE * w.face + OPS_PER_HIT * w.hit
            + OPS_PER_POINT * w.points + OPS_PER_TRIANGLE * w.triangles)


# ---------------------------------------------------------------------------
# the plain version


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
