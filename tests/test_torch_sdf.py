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
- ``pair_work``, the data-dependent terms of the bound by operations.

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
    nudge picks one of each x face's two."""
    v, f = (torch.from_numpy(a) for a in models.cube_mesh())
    pts = torch.tensor([[0.5, 0.5, 0.5], [3.0, 0.5, 0.5], [0.5, 5.0, 0.5]])
    assert [sdf.pair_work(v, f, pts[i : i + 1]) for i in range(3)] == [(12, 2), (4, 2), (4, 0)]
    assert sdf.pair_work(v, f, pts) == (20, 4)
    assert sdf.ops(3, 12, 20, 4) == 3 * 12 * sdf.OPS_PER_PAIR + 20 * 7 + 4 * 12 + 3 * 4 + 12 * 48
