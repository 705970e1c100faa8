"""The port's mesh bake (``ops/sdf.py``, ``core/models.py``) against the JAX
package's, on the CPU:

- ``mesh_sdf_plain`` against the JAX package's numpy bake
  (``_point_tri_dist2`` + ``_ray_parity``, composed as its ``mesh_sdf``
  does without the native helper): bit for bit, on the cube with voxel
  centres (among them points on its faces' diagonals, where the ray's nudge
  decides), the procedural logo, the procedural bunny (random points, a grid
  over its box, its vertices and its edges' midpoints), a mesh with a
  zero-length edge (distance 0 everywhere, the reference's own behaviour)
  and far-away points;
- against the JAX package's ``mesh_sdf`` (its g++ helper where that builds,
  which contracts multiply-adds): within rtol 1e-6 and atol 1e-6, with the
  same signs;
- ``build_solid_objects(device="cpu")`` against the JAX package's on a
  reduced bunny scene: the field within 1e-5 voxel, as the wavegenerator
  bake is held in tests/test_torch_solids.py;
- the device rule: ``device="cuda"`` raises without CUDA; a mesh without
  triangles, an index outside [0, V) and tensors on two devices raise;
- ``pair_work``, the data-dependent terms of the bound by operations, and
  its needed pairs against a count in numpy;
- the kernel's skip rule (``pair_bounds`` with ``triangle_bounds``): every
  pair's plain squared distance is at least its bound, so a pair the rule
  skips cannot change a point's minimum, and no pair outside the widened yz
  box is a ray hit; on adversarial meshes and on points built to sit where
  rounding decides (on vertices' axis rays, in small triangles' planes far
  away, just outside nearly edge-on triangles' projected corners), where
  zeroed margins fail;
- the Morton order of ``prepare`` changes no bit: the plain bake over the
  reordered points and triangles, mapped back, is the JAX numpy bake.

The kernel (``csrc/sdf.cu``) is held against ``mesh_sdf_plain`` on the card
in tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

from blub_tpu.core import config as jconfig
from blub_tpu.core import models as jmodels
from blub_tpu_torch.core import config, models
from blub_tpu_torch.ops import sdf


def _jax_numpy_sdf(verts, tris, points, chunk=32768):
    """``blub_tpu/core/models.py::mesh_sdf`` without its native helper."""
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    out = np.empty(points.shape[0], np.float32)
    for s in range(0, points.shape[0], chunk):
        p = points[s : s + chunk]
        dist = np.sqrt(jmodels._point_tri_dist2(p, a, b, c).min(axis=1))
        out[s : s + chunk] = np.where(jmodels._ray_parity(p, a, b, c), -dist, dist)
    return out


def _plain(verts, tris, points):
    return sdf.mesh_sdf_plain(torch.from_numpy(verts), torch.from_numpy(tris), torch.from_numpy(points)).numpy()


def _grid(n, lo, hi):
    """Voxel centres of an n^3 grid over [lo, hi]^3, f32[n^3, 3]."""
    return (lo + (np.indices((n, n, n)).reshape(3, -1).T + 0.5) / n * (hi - lo)).astype(np.float32)


def _bunny_points():
    v, f = models.procedural_bunny()
    rng = np.random.default_rng(0)
    lo, hi = v.min(0) - 0.1, v.max(0) + 0.1
    return np.concatenate([
        (lo + rng.random((6000, 3)) * (hi - lo)).astype(np.float32),
        (lo + (np.indices((14, 14, 14)).reshape(3, -1).T + 0.5) / 14 * (hi - lo)).astype(np.float32),
        v,
        ((v[f] + v[np.roll(f, 1, axis=1)]) / 2).reshape(-1, 3).astype(np.float32),
    ])


def _degenerate():
    """A zero-length edge (corners 0 and 1 coincide) beside a proper triangle."""
    v = np.array([[0, 0, 0], [0, 0, 0], [1, 0, 1], [0, 1, 0], [1, 1, 1]], np.float32)
    return v, np.array([[0, 1, 2], [2, 3, 4]], np.int32)


def _far_points():
    rng = np.random.default_rng(5)
    d = rng.standard_normal((500, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(10, 1e4, (500, 1)) + 0.5).astype(np.float32)


CASES = {
    # 16^3 voxel centres over [-0.25, 1.25]^3: y == z on the x faces' diagonals
    "cube": lambda: (*models.cube_mesh(), _grid(16, -0.25, 1.25)),
    "logo": lambda: (*models.procedural_logo(), _grid(18, -0.1, 1.1)),
    "bunny": lambda: (*models.procedural_bunny(), _bunny_points()),
    "zero_length_edge": lambda: (*_degenerate(), _grid(12, -0.5, 1.5)),
    "far": lambda: (*models.procedural_bunny(), _far_points()),
}


@pytest.mark.parametrize("case", CASES)
def test_plain_bake_matches_the_jax_numpy_bake(case):
    verts, tris, pts = CASES[case]()
    ref = _jax_numpy_sdf(verts, tris, pts)
    got = _plain(verts, tris, pts)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    if case == "zero_length_edge":
        assert np.all(got == 0)  # the reference's own behaviour on a degenerate triangle
    if case == "cube":
        inside = np.all((pts > 0) & (pts < 1), axis=1)
        assert np.array_equal(got < 0, inside) and 0 < inside.sum() < len(pts)


@pytest.mark.parametrize("case", ["cube", "logo", "bunny"])
def test_plain_bake_matches_the_jax_bake(case):
    verts, tris, pts = CASES[case]()
    ref = jmodels.mesh_sdf(verts, tris, pts)
    got = models.mesh_sdf(verts, tris, pts, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # the sign bit is the crossing parity's (an inside point on the surface is -0.0)
    assert np.array_equal(np.signbit(got), np.signbit(ref))


BUNNY_SCENE = {
    "gravity": {"x": 0.0, "y": -9.81, "z": 0.0},
    "fluid": {
        "world_position": {"x": 0.0, "y": 0.0, "z": 0.0}, "grid_to_world_scale": 0.01,
        "grid_dimension": {"x": 32, "y": 16, "z": 16}, "max_num_particles": 10**6,
        "fluid_cubes": [{"min": {"x": 0.0, "y": 0.0, "z": 0.0}, "max": {"x": 0.1, "y": 0.1, "z": 0.16}}],
    },
    # dam_halfhalf_staticbunny's object at a quarter of the grid, turned
    "static_objects": [{
        "model": "stanford bunny/bunny.obj", "world_position": {"x": 0.2, "y": 0.0, "z": 0.04},
        "scale": 0.1, "rotation_angles": {"x": 0.0, "y": 30.0, "z": 0.0},
    }],
}


def test_build_solid_objects_matches_jax():
    (mine,) = models.build_solid_objects(config.load_scene_dict(BUNNY_SCENE, "t"), device="cpu")
    (ref,) = jmodels.build_solid_objects(jconfig.load_scene_dict(BUNNY_SCENE, "t"))
    assert mine.standin == ref.standin == "bunny"
    assert mine.pad_lo == tuple(ref.pad_lo) and mine.sdf.shape == ref.sdf.shape
    np.testing.assert_allclose(mine.sdf, ref.sdf, rtol=0, atol=1e-5)
    assert (mine.sdf < 0).sum() > 50


def test_device_rule():
    scene = config.load_scene_dict(BUNNY_SCENE, "t")
    v, f = models.cube_mesh()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            models.build_solid_objects(scene)
        with pytest.raises(RuntimeError, match="CUDA"):
            models.mesh_sdf(v, f, _grid(2, 0, 1), device="cuda")
    with pytest.raises(ValueError, match="no triangles"):
        sdf.mesh_sdf(torch.from_numpy(v), torch.from_numpy(f[:0]), torch.from_numpy(_grid(2, 0, 1)))
    with pytest.raises(ValueError, match="outside"):
        models.mesh_sdf(v, f + 1, _grid(2, 0, 1), device="cpu")
    with pytest.raises(ValueError, match="outside"):  # torch's indexing would wrap -1
        sdf.mesh_sdf(torch.from_numpy(v), torch.from_numpy(f - 1), torch.from_numpy(_grid(2, 0, 1)))
    with pytest.raises(ValueError, match="on meta"):
        sdf.mesh_sdf(torch.from_numpy(v).to("meta"), torch.from_numpy(f), torch.from_numpy(_grid(2, 0, 1)))


def test_pair_work():
    """A point's face-region pairs are the cube's triangles its projection
    falls in (all 12 from the centre, on the diagonals), its hits the
    triangles that its ray's yz projection crosses, in front or behind: the
    nudge picks one of each x face's two. Its needed pairs: from the centre
    all 12 triangles lie at 0.5 or their boxes come nearer, from (3, .5, .5)
    only the two of the x = 1 face, from (.5, 5, .5) the y = 1 face's two
    (each pair in its face region); the ray's yz boxes: the x faces' four
    (the others' corners share y or z: never a hit, an empty box)."""
    v, f = (torch.from_numpy(a) for a in models.cube_mesh())
    pts = torch.tensor([[0.5, 0.5, 0.5], [3.0, 0.5, 0.5], [0.5, 5.0, 0.5]])
    got = [sdf.pair_work(v, f, pts[i : i + 1])[2:] for i in range(3)]
    assert got == [(12, 2, 12, 12, 4), (4, 2, 2, 2, 4), (4, 0, 2, 2, 0)]
    w = sdf.pair_work(v, f, pts)
    assert w == (3, 12, 20, 4, 16, 16, 8)
    assert sdf.ops_brute(w) == 3 * 12 * sdf.OPS_PER_PAIR + 20 * 7 + 4 * 12 + 3 * 4 + 12 * 48
    assert sdf.ops(w) == 16 * sdf.OPS_DIST + 16 * 7 + 8 * sdf.OPS_RAY + 4 * 12 + 3 * 4 + 12 * 48


# ---------------------------------------------------------------------------
# the skip rule


def _soup():
    rng = np.random.default_rng(11)
    v = (rng.random((240, 3)) * 2 - 0.5).astype(np.float32)
    return v, rng.integers(0, 240, (200, 3)).astype(np.int32), (rng.random((1500, 3)) * 3 - 1).astype(np.float32)


def _slivers(k=120, seed=12):
    """Needles (a corner near another) and caps (a corner near the opposite
    edge's middle), their smallest angle 1e-3 to 1e-1 of the other's size."""
    rng = np.random.default_rng(seed)
    ts = []
    for j in range(k):
        a = rng.random(3)
        d = rng.standard_normal(3)
        b = a + d / np.linalg.norm(d) * rng.uniform(0.05, 1)
        e = 10 ** rng.uniform(-3, -1) * np.linalg.norm(b - a)
        ts.append([a, b, (a + e * rng.standard_normal(3)) if j % 2 else ((a + b) / 2 + e * rng.standard_normal(3))])
    v = np.array(ts, np.float32).reshape(-1, 3)
    return v, np.arange(len(v), dtype=np.int32).reshape(-1, 3)


def _edge_on(k=100, seed=13):
    """Triangles whose planes nearly contain the x axis: their yz projections
    are slivers, where the ray test's rounding band is widest."""
    rng = np.random.default_rng(seed)
    ts = []
    for _ in range(k):
        a = rng.random(3)
        u = np.array([1.0, 0, 0]) + rng.standard_normal(3) * 10 ** rng.uniform(-6, -2)
        w = rng.standard_normal(3)
        w[0] = 0
        ts.append([a, a + u * rng.uniform(0.1, 1), a + w * rng.uniform(0.1, 1)])
    v = np.array(ts, np.float32).reshape(-1, 3)
    return v, np.arange(len(v), dtype=np.int32).reshape(-1, 3)


def _axis_rays(v, scales):
    """Points on each vertex's six axis rays, where a computed segment point
    one ulp off the vertex could come nearer than the box."""
    out = [v + sign * scale * np.eye(3)[k] for scale in scales for k in range(3) for sign in (-1, 1)]
    return np.concatenate(out).astype(np.float32)


def _in_plane(v, f, dists, seed):
    """Points in each triangle's plane, ``dists`` from its centroid, a hair
    off it: far points of small triangles, whose face test is rounding noise."""
    rng = np.random.default_rng(seed)
    a, b, c = (v[f[:, k]].astype(np.float64) for k in range(3))
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    out = []
    for d in dists:
        r = rng.standard_normal(a.shape)
        r -= (r * n).sum(1, keepdims=True) * n
        r /= np.linalg.norm(r, axis=1, keepdims=True)
        out.append((a + b + c) / 3 + r * d + n * d * 10 ** rng.uniform(-9, -3, (len(a), 1)))
    return np.concatenate(out).astype(np.float32)


def _projected_corners(v, f, scales, seed):
    """Points just outside each triangle's projected (yz) corners, on the
    outward bisector and on an edge's line beyond the corner, at any x; the
    ray's nudge taken off, so that the nudged origin lands there."""
    rng = np.random.default_rng(seed)
    c = v[f].astype(np.float64)
    out = []
    for i in range(3):
        V, P, Q = c[:, i], c[:, (i + 1) % 3], c[:, (i + 2) % 3]
        u1, u2 = ((X - V)[:, 1:] / (np.linalg.norm((X - V)[:, 1:], axis=1, keepdims=True) + 1e-300) for X in (P, Q))
        bis = -(u1 + u2) / (np.linalg.norm(u1 + u2, axis=1, keepdims=True) + 1e-300)
        for s in scales:
            for q in (bis * s, (V - P)[:, 1:] * s):
                x = V.copy()
                x[:, 1:] += q
                x[:, 0] += rng.standard_normal(len(x))
                out.append(x)
    pts = np.concatenate(out)
    pts[:, 1:] -= [sdf.EPS_Y, sdf.EPS_Z]
    return pts.astype(np.float32)


def _nan_vertex():
    v, f = models.procedural_bunny()
    v = v.copy()
    v[5] = np.nan
    return v, f, np.random.default_rng(14).random((600, 3)).astype(np.float32)


def _tiny_sphere():
    v, f = models.icosphere_mesh(2)
    return ((v - 0.5) * 0.004 + 0.5).astype(np.float32), f


RULE_CASES = {
    "icosphere3": lambda: (*models.icosphere_mesh(3), _grid(12, -0.3, 1.3)),
    "bunny": lambda: (*models.procedural_bunny(), _bunny_points()[::3]),
    "cube_faces_and_diagonals": lambda: (*models.cube_mesh(), _grid(16, -0.25, 1.25)),
    "soup": _soup,
    "slivers": lambda: (*_slivers(), (np.random.default_rng(15).random((2000, 3)) * 2 - 0.5).astype(np.float32)),
    "zero_length_edge": lambda: (*_degenerate(), _grid(12, -0.5, 1.5)),
    "nan_vertex": _nan_vertex,
    "far": lambda: (*models.procedural_bunny(), (_far_points() - 0.5) / 10 + 0.5),
    "bunny_axis_rays": lambda: (*models.procedural_bunny(), _axis_rays(models.procedural_bunny()[0],
                                                                       [1e-7, 1e-5, 1e-3, 0.1])),
    "slivers_axis_rays": lambda: (*_slivers(), _axis_rays(_slivers()[0], [1e-6, 1e-3, 0.1, 1])),
    "tiny_sphere_in_plane": lambda: (*_tiny_sphere(), _in_plane(*_tiny_sphere(), [1, 10, 100, 1000], 16)),
    "slivers_in_plane": lambda: (*_slivers(), _in_plane(*_slivers(), [0.1, 1, 10, 100], 17)),
    "edge_on_projected_corners": lambda: (*_edge_on(), _projected_corners(*_edge_on(), [1e-7, 1e-5, 1e-3, 0.1], 18)),
}


@pytest.mark.parametrize("case", RULE_CASES)
def test_skip_rule_is_sound(case):
    """Every pair's plain squared distance is at least the rule's bound L
    (where the rule may skip: L finite, the point not wild), so a pair the
    kernel skips (L above a running minimum, which is at least the final
    one) changes no point's minimum; in particular every pair whose L
    exceeds its point's final minimum lies at or above that minimum, not
    NaN; and no pair outside its widened yz box is a ray hit."""
    verts, tris, pts = (torch.from_numpy(np.ascontiguousarray(a)) for a in RULE_CASES[case]())
    tb = sdf.triangle_bounds(verts, tris)
    box = sdf.skip_box(tb)
    skipped = 0
    for _, p, tt in sdf._blocks(verts, tris, pts):
        dist2 = sdf._point_tri_dist2(p, tt)[0]
        hit = sdf._ray_parity(p, tt)[1]
        bound, inside, wild = sdf.pair_bounds(p, tb, box)
        may = torch.isfinite(bound) & ~wild
        assert bool((dist2[may] >= bound[may]).all())
        best = dist2.amin(1, keepdim=True)
        skip = (bound > best) & ~wild
        assert bool((dist2 >= best)[skip].all())
        assert not bool((hit & ~inside).any())
        skipped += int(skip.sum())
    if case == "nan_vertex":  # every point's minimum is NaN: nothing is skipped
        assert skipped == 0
    elif case != "zero_length_edge":  # a degenerate triangle makes every minimum 0: nothing to skip
        assert skipped > 0


def test_skip_rule_flags():
    """A zero-length edge, a non-finite corner, a corner beyond WILD and a
    sliver below MIN_SIN2 get G2 = inf and an infinite box (never skipped);
    the cube's y and z faces (corners sharing y or z) get an empty ray box,
    its x faces a finite one just wider than the face."""
    v = np.array([[0, 0, 0], [0, 0, 0], [1, 0, 1], [np.nan, 0, 0], [1e9, 0, 0], [1, 1e-4, 0], [2, 1e-7, 0],
                  [0, 1, 1]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3], [0, 2, 4], [0, 6, 5], [0, 2, 7]], np.int32)
    tb = sdf.triangle_bounds(torch.from_numpy(v), torch.from_numpy(f))
    assert torch.isinf(tb[sdf.G2, :4]).all() and torch.isfinite(tb[sdf.G2, 4])
    assert (tb[sdf.LO : sdf.LO + 3, :4] == float("-inf")).all() and (tb[sdf.HI : sdf.HI + 3, :4] == float("inf")).all()
    cv, cf = models.cube_mesh()
    cb = sdf.triangle_bounds(torch.from_numpy(cv), torch.from_numpy(cf))
    x_faces = torch.tensor([False] * 8 + [True] * 4)
    assert (cb[sdf.YLO, ~x_faces] == float("inf")).all() and (cb[sdf.YHI, ~x_faces] == float("-inf")).all()
    assert (cb[sdf.YLO, x_faces] < 0).all() and (cb[sdf.YLO, x_faces] > -1e-5).all()
    assert (cb[sdf.ZHI, x_faces] > 1).all() and (cb[sdf.ZHI, x_faces] < 1 + 1e-5).all()


@pytest.mark.parametrize("case", ["cube", "bunny", "far"])
def test_morton_order_changes_no_bit(case):
    """``prepare``'s order of the points and the triangles: the plain bake
    over the reordered inputs, mapped back, is the JAX numpy bake bit for
    bit; the kernel's inputs are the reordered triangles' terms and bounds;
    each group's bounds are its triangles' union, each tile's its groups',
    and the tiles' boxes of skippable triangles unite to ``skip_box``."""
    verts, tris, pts = CASES[case]()
    v, f, p = (torch.from_numpy(a) for a in (verts, tris, pts))
    order, tt, tb, groups, tiles = sdf.prepare(v, f, p)
    perm = torch.argsort(sdf.bounds(v, f)[1])
    assert sorted(order.tolist()) == list(range(len(pts))) and sorted(perm.tolist()) == list(range(len(tris)))
    got = np.empty_like(pts[:, 0])
    got[order.numpy()] = sdf.mesh_sdf_plain(v, f[perm], p[order]).numpy()
    np.testing.assert_array_equal(got.view(np.int32), _jax_numpy_sdf(verts, tris, pts).view(np.int32))
    assert torch.equal(tb, sdf.triangle_bounds(v, f[perm])) and torch.equal(tt, sdf.terms(v, f[perm]))
    box = sdf.skip_box(tb)
    assert torch.equal(tiles[sdf.SLO : sdf.SLO + 3].amin(1), box[:3])
    assert torch.equal(tiles[sdf.SHI : sdf.SHI + 3].amax(1), box[3:])
    is_min = torch.tensor([i in (0, 1, 2, sdf.YLO, sdf.ZLO) for i in range(sdf.FIELDS)])
    for fine, coarse in ((tb, groups), (groups, tiles[: sdf.FIELDS])):
        assert coarse.shape[1] == -(-fine.shape[1] // sdf.GROUP)
        for k in range(coarse.shape[1]):
            part = fine[:, k * sdf.GROUP : (k + 1) * sdf.GROUP]
            assert torch.equal(coarse[:, k], torch.where(is_min, part.amin(1), part.amax(1)))
    assert tiles.shape[0] == sdf.TILE_FIELDS


def test_unite_tiles():
    """``unite`` over several tiles (icosphere_mesh(4): 5,120 triangles, 160
    groups, 5 tiles): each tile's bounds are its groups' union and its box
    of skippable triangles theirs, the last tile's padding adds nothing."""
    v, f = (torch.from_numpy(a) for a in models.icosphere_mesh(4))
    tb, key, tt = sdf.bounds(v, f)
    tt_s, tb_s, groups, tiles = sdf.unite(tb, tt, torch.argsort(key))
    assert groups.shape == (sdf.FIELDS, 160) and tiles.shape == (sdf.TILE_FIELDS, 5)
    assert torch.equal(tiles[: sdf.FIELDS], sdf.group_bounds(groups))
    for k in range(5):
        part = tb_s[:, k * sdf.GROUP**2 : (k + 1) * sdf.GROUP**2]
        assert torch.equal(tiles[sdf.SLO :, k], sdf.skip_box(part))
    assert torch.equal(tt_s, tt[torch.argsort(key)])


def test_needed_pairs_against_numpy():
    """``pair_work``'s needed pairs against a count in numpy: the bound from
    the same f32 tables, the final minimum from the JAX package's numpy
    distances."""
    verts, tris = models.procedural_bunny()
    pts = _bunny_points()[::4]
    tb = sdf.triangle_bounds(torch.from_numpy(verts), torch.from_numpy(tris)).numpy()
    box = sdf.skip_box(torch.from_numpy(tb)).numpy()
    f32 = np.float32
    e = np.maximum(pts - box[:3], box[3:] - pts)
    r2 = ((e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]) * f32(sdf.ROUND_UP)
    r = np.sqrt(r2.astype(np.float64)).astype(f32) * f32(sdf.ROUND_UP)
    r4 = r2 * r2 * f32(sdf.ROUND_UP)
    g = [np.maximum(np.maximum(tb[sdf.LO + k] - pts[:, k, None], pts[:, k, None] - tb[sdf.HI + k]), f32(0))
         for k in range(3)]
    bound = ((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]) - (
        (tb[sdf.G2] * r4[:, None] + tb[sdf.H] * r2[:, None]) + tb[sdf.A] * r[:, None])
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    best = jmodels._point_tri_dist2(pts, a, b, c).min(axis=1)
    w = sdf.pair_work(*(torch.from_numpy(x) for x in (verts, tris, pts)))
    assert w.needed == int((~(bound > best[:, None])).sum())
    assert 0 < w.needed < w.points * w.triangles
