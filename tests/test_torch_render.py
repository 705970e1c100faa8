"""The port's renderer (blub_tpu_torch/render/) against the JAX package's
(blub_tpu/render/) on the same numpy-seeded inputs, at G = 32x16x16 with up
to 4000 particles and images of 160x120 or less.

- the copied numpy modules (camera, cubemap, environment, lines, mesh, png)
  bit for bit against their JAX twins, each case on its own;
- the PyTorch SSF filters against JAX's jitted ones, with
  tests/test_render.py::test_ssf_filters_jax_match_numpy's tolerances
  (rtol 2e-4 / atol 2e-3 and rtol 2e-5 / atol 1e-5), and the numpy oracles
  bit for bit;
- the PyTorch depth splat bit for bit against JAX's ``_splat_depth`` (a min
  does not depend on the order), and the renderer's device splat (packed
  64-bit keys, float64 point math) bit for bit against its numpy splat;
- the PyTorch fluid pass against JAX's ``fluid_pass_device`` and the cubemap
  compose against the numpy compose, with
  test_device_fluid_pass_matches_numpy's bounds on the tonemapped image
  (max 8 LSB, under 2 % of the pixels differ, 99th percentile 0): the
  thickness sums in another order and the compose runs in f32;
- ``SceneRenderer.draw`` on the CPU (the numpy path) against JAX's numpy
  path for the five (fluid, volume) pairs of test_draw_modes_smoke: the same
  image, and the smoke test's checks.

JAX's renderer runs its numpy path with its native helper switched off and
its SSF filters set to their numpy oracles, so both packages run the same
numpy. JAX's fluid pass compiles for ~20 s on a CPU: it starts in a second
process when the module's first test asks for the oracles, and its test
comes last.
"""

import multiprocessing
import os
import struct
import zlib
from concurrent.futures import ProcessPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blub_tpu.core import models as jmodels
from blub_tpu.core.types import CELL_FLUID
from blub_tpu.ops import native as jnative
from blub_tpu.render import camera as jcamera
from blub_tpu.render import cubemap as jcubemap
from blub_tpu.render import device_ssf as jdevice_ssf
from blub_tpu.render import environment as jenv
from blub_tpu.render import lines as jlines
from blub_tpu.render import mesh as jmesh
from blub_tpu.render import png as jpng
from blub_tpu.render import renderer as jrenderer
from blub_tpu.render import ssf as jssf
from blub_tpu_torch.core import models
from blub_tpu_torch.render import camera, cubemap, device_ssf, environment, lines, mesh, png, renderer, ssf

torch.set_num_threads(1)

G = (32, 16, 16)


def _cloud(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.stack(
        [1 + 14 * rng.random(n), 1 + 7 * rng.random(n), 1 + 14 * rng.random(n)], -1
    ).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32) * 50
    return pos, vel


def _image_bounds(a, b):
    """test_device_fluid_pass_matches_numpy's bounds on two uint8 images."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 8, d.max()
    assert (d > 0).mean() < 0.02, (d > 0).mean()
    assert np.percentile(d, 99) == 0


def _tonemapped(rgb):
    return (environment.tonemap(rgb) * 255).astype(np.uint8)


def _jax_fluid_pass():
    pos, _ = _cloud(1500, seed=5)
    r = jrenderer.SceneRenderer(G, jrenderer.RenderSettings(width=96, height=64))
    rgb, depth = r._background()
    out = jdevice_ssf.fluid_pass_device(pos, rgb, depth, r.camera, r.particle_radius, r.settings.grid_to_world_scale)
    return pos, rgb, depth, r.camera, r.particle_radius, r.settings.grid_to_world_scale, tuple(map(np.asarray, out))


class _Oracles:
    """JAX's fluid pass in a second process, started on first use (its
    trace and its ~20 s compile then overlap the tests that follow)."""

    def __init__(self):
        self.pool = self.fluid_pass = None

    def start(self):
        if self.pool is None:
            self.pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"))
            self.fluid_pass = self.pool.submit(_jax_fluid_pass)
        return self


@pytest.fixture(scope="module")
def oracles():
    o = _Oracles()
    yield o
    if o.pool is not None:
        o.pool.shutdown(wait=True)


@pytest.fixture(autouse=True)
def _start_oracles(oracles):
    """In one process the module's first test starts the oracles, so they
    run alongside the rest. Under pytest-xdist the tests of this module are
    spread over the workers, and only the worker that runs the fluid-pass
    test starts them."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        oracles.start()


@pytest.fixture
def numpy_path(monkeypatch):
    """JAX's renderer on its numpy path: no native helper, and its SSF
    filters are their numpy oracles (the port's plain version runs those)."""
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    monkeypatch.setattr(jssf, "narrow_range_filter", jssf.narrow_range_filter_np)
    monkeypatch.setattr(jssf, "thickness_filter", jssf.thickness_filter_np)


# -- the copied numpy modules ------------------------------------------------


def _camera_case():
    out = []
    for mod in (camera, jcamera):
        cam = mod.Camera.parse("10,20,30:64,32,32:60", (128, 64, 64))
        pts = np.random.default_rng(1).uniform(0, 64, (500, 3)).astype(np.float32)
        res = [cam.position.copy(), cam.target.copy(), *cam.project(pts, 160, 120), cam.focal_px(120)]
        cam.orbit(35.0, -10.0)
        cam.dolly(0.7)
        cam.fly(forward=3.0, right=-2.0, up=1.0)
        res += [cam.position, cam.target, *cam.basis(), *mod.Camera.framing(G).project(pts, 96, 64)]
        res.append(mod.Camera.parse("1,2,3", G).target)
        out.append(res)
    return out


def _cubemap_case():
    rng = np.random.default_rng(2)
    dirs = rng.normal(size=(600, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rgb = (rng.random((64, 3)).astype(np.float32) * 10.0) ** 3.0
    return [[m.procedural_cubemap(resolution=16).sample(dirs), m.encode_rgbe(rgb), m.decode_rgbe(m.encode_rgbe(rgb))]
            for m in (cubemap, jcubemap)]


def _environment_case():
    rng = np.random.default_rng(3)
    dirs = rng.normal(size=(40, 30, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    c = np.linspace(0.0, 1.0, 50)
    return [[m.sh3_evaluate(dirs, m.LIGHTING.sh3), m.sh3_evaluate_cosine(dirs, m.LIGHTING.sh3),
             m.fresnel_dielectric(c, 1.333), m.schlick_fresnel(c, 0.02), m.tonemap(c * 1.5),
             m.shade_surface(dirs, 0.7), m.sh_sky_color(dirs), *m.sample_background(np.array([0.3, 0.4, 0.9]), dirs)]
            for m in (environment, jenv)]


def _lines_case():
    cam = camera.Camera.framing(G)
    rng = np.random.default_rng(4)
    vel = rng.standard_normal(G + (3,)).astype(np.float32) * 40
    marker = np.where(rng.random(G) < 0.5, CELL_FLUID, -1).astype(np.int8)
    out = []
    for m in (lines, jlines):
        rgb = np.zeros((120, 160, 3), np.float32)
        depth = np.full((120, 160), 1e9, np.float32)
        depth[40:60, 50:90] = 20.0  # an occluder
        p0, p1, cols = m.velocity_lines(vel, marker, 0.01, max_lines=3000)
        m.draw_lines(rgb, depth, cam, p0, p1, cols)
        b = m.domain_bounds_lines(G)
        m.draw_lines(rgb, depth, cam, *b)
        out.append([rgb, depth, p0, p1, cols, *b, m.colormap_cool_to_warm(np.linspace(-2, 2, 9))])
    return out


def _mesh_case():
    cam = camera.Camera.framing(G)
    occ = np.zeros(G, np.float32)
    occ[4:8, 4:9, 3:8] = 1.0
    occ[20:23, 2:4, 10:14] = 1.0
    tex = np.random.default_rng(5).random((4, 4, 3)).astype(np.float32)
    out = []
    for m in (mesh, jmesh):
        rgb = np.zeros((120, 160, 3), np.float32)
        depth = np.full((120, 160), 1e9, np.float32)
        v, f = m.cube_mesh()
        m.rasterize_mesh(rgb, depth, cam, v * 8.0 + np.array([12, 4, 4], np.float32), f, albedo=1.0)
        sv, sf = m.icosphere_mesh(2)
        uv = np.random.default_rng(6).random((len(sf), 3, 2)).astype(np.float32)
        m.rasterize_mesh(rgb, depth, cam, sv * 6.0 + np.array([22, 6, 8], np.float32), sf, face_uv=uv, texture=tex)
        verts, faces, cells = m.voxel_surface_mesh(occ)
        m.rasterize_mesh(rgb, depth, cam, verts, faces, albedo=np.abs(cells) * 0.05, cull_backfaces=False)
        out.append([rgb, depth, verts, faces, cells, sv, sf])
    return out


def _png_filtered(img, color):
    """A PNG of ``img`` with rows cycling through filter types 0-4 (the
    encoder side of the spec)."""
    h, w, nch = img.shape
    stride = w * nch
    raw = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        ftype = y % 5
        raw.append(ftype)
        a = np.concatenate([np.zeros(nch, np.int32), cur[:-nch]])
        c = np.concatenate([np.zeros(nch, np.int32), prev[:-nch]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        pred = [0, a, prev, (a + prev) >> 1, np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))][ftype]
        raw += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", ihdr) + png._chunk(b"IDAT", zlib.compress(bytes(raw)))
            + png._chunk(b"IEND", b""))


def _png_case():
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    imgs = {nch: rng.integers(0, 256, (10, 7, nch), dtype=np.uint8) for nch in (1, 2, 3, 4)}
    out = []
    for m in (png, jpng):
        res = [np.frombuffer(m.encode_png(rgb), np.uint8), m.decode_png(m.encode_png(rgb))]
        for nch, color in ((3, 2), (4, 6), (1, 0), (2, 4)):
            img = imgs[nch]
            got = m.decode_png(_png_filtered(img, color))
            want = {1: np.repeat(img, 3, axis=2),
                    2: np.concatenate([np.repeat(img[..., :1], 3, axis=2), img[..., 1:]], axis=2)}.get(nch, img)
            assert np.array_equal(got, want), (nch, color)
            res.append(got)
        assert m.decode_png(b"\x89PNG\r\n\x1a\nnot really") is None
        out.append(res)
    np.testing.assert_array_equal(out[0][1], rgb)
    return out


NUMPY_CASES = {"camera": _camera_case, "cubemap": _cubemap_case, "environment": _environment_case,
               "lines": _lines_case, "mesh": _mesh_case, "png": _png_case}


@pytest.mark.parametrize("case", sorted(NUMPY_CASES))
def test_numpy_module_matches_jax(case):
    """Each copied numpy module against its JAX twin on the same inputs:
    every output bit for bit."""
    ours, theirs = NUMPY_CASES[case]()
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{case} output {i}")


def test_png_file_round_trip_and_texture(tmp_path):
    """write_png / read_png, and core/models._load_texture on a PNG, a PPM
    and garbage, against the JAX package's loader."""
    img = np.random.default_rng(8).integers(0, 256, (9, 6, 3), dtype=np.uint8)
    png.write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(png.read_png(tmp_path / "a.png"), img)
    (tmp_path / "b.ppm").write_bytes(b"P6 6 9 255\n" + img.tobytes())
    (tmp_path / "c.png").write_bytes(b"\x89PNG\r\n\x1a\nnot really")
    for name in ("a.png", "b.ppm", "c.png"):
        got = models._load_texture(tmp_path / name, (1.0, 0.5, 0.25))
        np.testing.assert_array_equal(got, jmodels._load_texture(tmp_path / name, (1.0, 0.5, 0.25)), err_msg=name)
    np.testing.assert_allclose(models._load_texture(tmp_path / "a.png", None), img / np.float32(255.0))


# -- the SSF filters and the splats --------------------------------------------


def test_ssf_filters_match_jax():
    """The PyTorch filters against JAX's jitted ones (test_render.py's
    tolerances), and the copied numpy oracles bit for bit."""
    rng = np.random.default_rng(7)
    h, w = 48, 64
    depth = rng.uniform(5.0, 40.0, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.3] = ssf._FAR
    r = 0.35
    got = ssf.narrow_range_filter(torch.from_numpy(depth), r).numpy()
    np.testing.assert_allclose(got, jssf.narrow_range_filter(depth, r), rtol=2e-4, atol=2e-3)
    np.testing.assert_array_equal(ssf.narrow_range_filter_np(depth, r), jssf.narrow_range_filter_np(depth, r))

    thick = rng.uniform(0.0, 2.0, (h, w)).astype(np.float32)
    thick[rng.random((h, w)) < 0.5] = 0.0
    got = ssf.thickness_filter(torch.from_numpy(thick)).numpy()
    np.testing.assert_allclose(got, jssf.thickness_filter(thick), rtol=2e-5, atol=1e-5)
    np.testing.assert_array_equal(ssf.thickness_filter_np(thick), jssf.thickness_filter_np(thick))


def test_splat_depth_bit_equal_to_jax():
    """The PyTorch depth splat and JAX's on the same f32 inputs, screen
    edges included: bit for bit."""
    pos, _ = _cloud(800, seed=6)
    w, h = 80, 60
    r = jrenderer.SceneRenderer(G, jrenderer.RenderSettings(width=w, height=h))
    px, py, z, valid = r.camera.project(pos, w, h)
    f = r.camera.focal_px(h)
    r_px = np.clip(f * r.particle_radius / np.maximum(z, 1e-3), 0.6, 8.0)
    args = [np.asarray(a, np.float32) for a in (px, py, z, r_px)]
    want = np.asarray(jdevice_ssf._splat_depth(*map(jnp.asarray, args), jnp.asarray(valid), w, h, jnp.float32(f)))
    got = device_ssf.splat_depth(*map(torch.from_numpy, args), torch.from_numpy(valid), w, h, f).numpy()
    assert (got < ssf._FAR).mean() > 0.05
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", ["scalar", "per_point"])
def test_device_splat_matches_numpy(radius):
    """The renderer's device splat (run here on CPU tensors) against its
    numpy splat: depth and winner bit for bit (min of the packed keys), with
    particles off every screen edge and behind the camera."""
    pos, _ = _cloud(3000, seed=9)
    pos[:200] -= 40.0  # some behind the camera or off the screen
    r = renderer.SceneRenderer(G, renderer.RenderSettings(width=120, height=90), device="cpu")
    rad = 0.5 if radius == "scalar" else np.random.default_rng(10).uniform(0.0, 0.9, len(pos)).astype(np.float32)
    want_d, want_w = r._splat(pos, rad, values=np.zeros((len(pos), 3)))
    got_d, got_w = r._splat_device(torch.from_numpy(pos), rad, True)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    assert (want_w >= 0).mean() > 0.05
    nokey_d, _ = r._splat_device(torch.from_numpy(pos), rad, False)
    np.testing.assert_array_equal(nokey_d.numpy(), r._splat(pos, rad)[0])


def test_splat_raises_beyond_2_pow_24_points():
    r = renderer.SceneRenderer(G, renderer.RenderSettings(width=16, height=12), device="cpu")
    many = np.broadcast_to(np.zeros(3, np.float32), (renderer.MAX_SPLAT_POINTS, 3))
    with pytest.raises(ValueError, match="at most"):
        r._splat(many, 0.5, values=np.zeros(1))


def test_cubemap_compose_matches_numpy():
    """With a cubemap installed, the PyTorch compose samples it from the
    uint8 faces (cubemap_sample) and matches the numpy compose, whose sky
    samples the same Cubemap on the host."""
    pos, _ = _cloud(1500, seed=11)
    r = renderer.SceneRenderer(G, renderer.RenderSettings(width=96, height=64), device="cpu")
    cm = cubemap.procedural_cubemap(resolution=32)
    rng = np.random.default_rng(12)
    dirs = rng.normal(size=(2000, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    np.testing.assert_array_equal(device_ssf.cubemap_sample(torch.from_numpy(cm.faces), torch.from_numpy(dirs))
                                  .numpy(), cm.sample(dirs))
    environment.set_sky_cubemap(cm)
    try:
        rgb, depth = r._background()
        pdepth = ssf.narrow_range_filter_np(r._splat(pos, r.particle_radius)[0], r.particle_radius)
        thick = ssf.thickness_filter_np(r._thickness(pos, r.particle_radius))
        want = ssf.compose(rgb, depth, pdepth, thick, r.camera, 0.01)
        h, w = depth.shape
        t = [torch.as_tensor(np.asarray(a, np.float32)) for a in (rgb, depth, pdepth, thick)]
        cam_t = [torch.as_tensor(np.asarray(a, np.float32)) for a in (r.camera.position, *r.camera.basis())]
        sky = device_ssf._Sky(environment.LIGHTING, "cpu")
        assert sky.faces is not None
        got = device_ssf.compose(*t, *cam_t, torch.tensor(r.camera.focal_px(h)), r.camera.near, 0.01, sky, w, h)
    finally:
        environment.set_sky_cubemap(None)
    has_fluid = (thick > 0) & (pdepth < depth)
    assert has_fluid.mean() > 0.05
    _image_bounds(_tonemapped(got.numpy()), _tonemapped(want))


# -- SceneRenderer.draw ------------------------------------------------------------


@pytest.mark.parametrize(
    "fluid_mode,volume_mode",
    [
        ("particles_velocity", "none"),
        ("screen_space_fluid", "none"),
        ("none", "pressure_from_velocity"),
        ("none", "velocity"),
        ("none", "marker"),
    ],
)
def test_draw_matches_jax(numpy_path, fluid_mode, volume_mode):
    """test_draw_modes_smoke's scene through both renderers' numpy paths:
    the same image, of the right shape and type, unlike the background."""
    pos, vel = _cloud()
    rng = np.random.default_rng(1)
    field = rng.standard_normal(G).astype(np.float32)
    vgrid = np.zeros(G + (3,), np.float32)
    vgrid[..., 1] = -50.0
    marker = np.full(G, CELL_FLUID, np.int8)
    if volume_mode == "marker":
        field = marker.astype(np.float32)
    v, f = mesh.cube_mesh()
    solid = (v * 4.0 + np.array([24, 1, 1], np.float32), f)
    occ = np.zeros(G, np.float32)
    occ[24:28, 1:5, 1:5] = 1.0
    kw = dict(field=field, solid_meshes=[solid], solid_occupancy=occ, velocity_grid=vgrid, marker=marker)
    ours = renderer.SceneRenderer(G, renderer.RenderSettings(
        width=160, height=120, fluid_mode=renderer.FluidRenderingMode(fluid_mode),
        volume_mode=renderer.VolumeVisualizationMode(volume_mode), show_voxel_debug=True), device="cpu")
    theirs = jrenderer.SceneRenderer(G, jrenderer.RenderSettings(
        width=160, height=120, fluid_mode=jrenderer.FluidRenderingMode(fluid_mode),
        volume_mode=jrenderer.VolumeVisualizationMode(volume_mode), show_voxel_debug=True,
        device_fluid_pass=False))
    img = ours.draw(torch.from_numpy(pos), torch.from_numpy(vel), **kw)
    np.testing.assert_array_equal(img, theirs.draw(pos, vel, **kw))
    assert img.shape == (120, 160, 3) and img.dtype == np.uint8
    bg_only = renderer.SceneRenderer(G, renderer.RenderSettings(
        width=160, height=120, fluid_mode=renderer.FluidRenderingMode.NONE, show_solid_meshes=False,
        show_bounds_box=False), device="cpu").draw(np.zeros((0, 3), np.float32))
    assert (img != bg_only).any()


def test_renderer_device_rule():
    """The renderer takes the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the rule's raise needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        renderer.SceneRenderer(G)


def test_fluid_pass_matches_jax(oracles):
    """The PyTorch fluid pass against JAX's fluid_pass_device (the same
    inputs as test_device_fluid_pass_matches_numpy): the tonemapped images
    within its bounds, depths within 1e-4 of the view depth."""
    pos, rgb, depth, jcam, radius, g2w, (want_rgb, want_depth) = oracles.start().fluid_pass.result()
    cam = camera.Camera(position=jcam.position, target=jcam.target, up=jcam.up, fov_y_deg=jcam.fov_y_deg,
                        near=jcam.near)
    got_rgb, got_depth = device_ssf.fluid_pass(torch.from_numpy(pos), rgb, depth, cam, radius, g2w)
    assert (got_depth.numpy() < depth).mean() > 0.05
    np.testing.assert_allclose(got_depth.numpy(), want_depth, rtol=1e-4)
    _image_bounds(_tonemapped(got_rgb.numpy()), _tonemapped(want_rgb))
