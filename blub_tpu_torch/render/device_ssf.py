"""The screen-space-fluid pass on the renderer's device, in PyTorch: a port of
``blub_tpu/render/device_ssf.py`` (``_fluid_pass`` and its helpers, one
jitted program there):

  project -> z-buffer sphere splat (``scatter_reduce`` "amin" over the
  footprint offsets) -> narrow-range filter -> additive thickness splat
  (``index_add_``) -> gaussian thickness filter -> refract / absorb /
  scatter / Fresnel compose with the sky

Reference analog: shader/screenspace_fluid/* (sphere_particles.vert/frag,
particles.frag, narrow_range_filter_*.comp, fluid_render.comp), where the
splat is the rasterizer's job. The numpy sequence of ``render/renderer.py``
and ``render/ssf.py`` is the plain version this pass is held to, so it runs
at numpy's precision: the point math, the splats and the compose (the JAX
package's transliteration of ``ssf.compose``, same constants) in float64,
the depth, the thickness and both filters in float32, as numpy stores them.
The JAX package's device pass is float32 throughout, which moves more
refracted pixels' gathers (a pixel whose exit point rounds the other way
takes its neighbour's colour).

Each splat loops over the footprint offsets within the largest pixel radius
of this draw (the 197 offsets of ``_offsets()`` at the 8-pixel clip), one
scatter of N values per offset: it never holds N x offsets values at once.
Pixels off the screen are clipped to one and masked to _FAR / 0, as the JAX
package does, so a masked value never wins. The depth splat is a min, so its
order does not matter: the same f32 inputs give the JAX splat's bits. The
thickness sum runs in no fixed order on the card.

Deviation from the JAX package: when ``environment.set_sky_cubemap`` has
installed a cubemap, the compose samples it here (``cubemap_sample``, a
gather from the ``[6, R, R, 4]`` uint8 faces on the device) where the JAX
renderer falls back to its numpy compose. Host scalars divide as device
tensors, where JAX divides truly (PyTorch divides a CUDA tensor by a host
scalar through its reciprocal).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import environment
from .environment import _B0, _B1, _B2N, _B2Z, LIGHTING, SKY_EXPOSURE, Lighting
from .ssf import ETA_WATER, EXTINCT, HG_G, SCATTER, _tshift, narrow_range_filter, thickness_filter

_FAR = 1e9
_RMAX = 8  # r_px clip ceiling in renderer._splat
IDX_BITS = 24  # a point's index in the low bits of the packed splat key
MAX_SPLAT_POINTS = 1 << IDX_BITS
_NO_KEY = torch.iinfo(torch.int64).max


def _offsets():
    """Static footprint offsets within the splat radius circle."""
    out = []
    for dy in range(-_RMAX, _RMAX + 1):
        for dx in range(-_RMAX, _RMAX + 1):
            if dx * dx + dy * dy <= _RMAX * _RMAX:
                out.append((dy, dx))
    return tuple(out)


def footprint(r_px: torch.Tensor, valid: torch.Tensor):
    """The offsets a splat can reach: those within the ceiling of the
    largest pixel radius among the valid points (one 4-byte read). Every
    other offset of ``_offsets()`` is masked for every point."""
    top = torch.where(valid, r_px, 0.0).max().item() if r_px.numel() else 0.0
    rmax = min(math.ceil(top), _RMAX)
    return [(dy, dx) for dy, dx in _offsets() if dx * dx + dy * dy <= rmax * rmax]


def project(pos, cam_pos, right, up, fwd, f, near, w: int, h: int):
    """render/camera.Camera.project on tensors: -> (px, py, z, valid). The
    dot products are written out, so they sum in one order on every
    device."""
    rel = pos - cam_pos[None]

    def dot(v):
        return rel[:, 0] * v[0] + rel[:, 1] * v[1] + rel[:, 2] * v[2]

    x, y, z = dot(right), dot(up), dot(fwd)
    valid = z > near
    zs = torch.where(valid, z, 1.0)
    px = w / 2.0 + f * x / zs
    py = h / 2.0 - f * y / zs
    return px, py, z, valid


def _footprint_index(ix, iy, dy: int, dx: int, w: int, h: int):
    """(pixel index clipped to the screen, in-screen mask) of offset (dy, dx)."""
    x = ix + dx
    y = iy + dy
    inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    return y.clamp(0, h - 1) * w + x.clamp(0, w - 1), inb


def screen_points(pos, radius, camera, w: int, h: int, device):
    """renderer._splat's point math on ``device`` in float64, as numpy
    computes it: -> (px, py, z, r_px, valid, f). ``radius`` is a scalar or
    f32 per point; f * radius is float32 (numpy multiplies its float32 radius
    array by a Python float), the rest float64."""
    f64 = torch.float64
    pos = torch.as_tensor(pos, device=device).to(f64)
    right, up, fwd = (torch.as_tensor(v, dtype=f64, device=device) for v in camera.basis())
    cam = torch.as_tensor(camera.position, dtype=f64, device=device)
    f = camera.focal_px(h)
    f_t = torch.tensor(f, dtype=f64, device=device)
    px, py, z, valid = project(pos, cam, right, up, fwd, f_t, camera.near, w, h)
    rad = torch.as_tensor(np.asarray(radius, np.float32), device=device).expand(pos.shape[0])
    r_px = torch.clamp((rad * f).to(f64) / torch.clamp_min(z, 1e-3), 0.6, 8.0)
    return px, py, z, r_px, valid & (rad > 1e-6), f_t


def splat_depth(px, py, z, r_px, valid, w: int, h: int, f, keys: bool = False):
    """Z-buffered sphere splat: min over the footprint of z - sphere offset
    (the JAX package's ``_splat_depth``; renderer._splat's math, with its
    clip and round-half-to-even), in the inputs' type. -> f32 [h, w], _FAR
    where empty. With ``keys`` the min runs over packed 64-bit keys (the f32
    depth's bits above the point's 24-bit index, renderer._splat's winner
    trick) -> (depth, winner i64 [h, w], -1 where empty); the caller keeps
    the points below 2^24."""
    f = torch.as_tensor(f, dtype=z.dtype, device=z.device)
    ix = torch.round(px).to(torch.int64)
    iy = torch.round(py).to(torch.int64)
    idx = torch.arange(z.shape[0], dtype=torch.int64, device=z.device)
    flat = torch.full((h * w,), _NO_KEY if keys else _FAR, dtype=torch.int64 if keys else torch.float32,
                      device=z.device)
    r2 = r_px * r_px
    for dy, dx in footprint(r_px, valid):
        d2 = float(dx * dx + dy * dy)
        lin, inb = _footprint_index(ix, iy, dy, dx, w, h)
        m = valid & (d2 <= r2) & inb
        zoff = torch.sqrt(torch.clamp_min(r2 - d2, 0.0)) * z / f
        zz = (z - zoff).to(torch.float32)
        if keys:  # z > 0, so its float bits order as the depths do
            val = torch.where(m, ((zz.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) << IDX_BITS) | idx, _NO_KEY)
        else:
            val = torch.where(m, zz, _FAR)
        flat.scatter_reduce_(0, lin, val, "amin")
    if not keys:
        return flat.reshape(h, w)
    hit = flat != _NO_KEY
    depth = torch.where(hit, (flat >> IDX_BITS).to(torch.int32).view(torch.float32), _FAR)
    return depth.reshape(h, w), torch.where(hit, flat & (MAX_SPLAT_POINTS - 1), -1).reshape(h, w)


def splat_thickness(px, py, z, r_px, valid, w: int, h: int, f, chord_scale: float, radius: float) -> torch.Tensor:
    """Additive thickness splat (renderer._thickness; the JAX package's
    ``_splat_thickness``): per pixel the sphere chord * chord_scale /
    radius, computed in the inputs' type and summed in float32. -> f32
    [h, w]."""
    f = torch.as_tensor(f, dtype=z.dtype, device=z.device)
    scale = torch.as_tensor(chord_scale, dtype=z.dtype, device=z.device)
    rad = torch.as_tensor(max(radius, 1e-6), dtype=z.dtype, device=z.device)
    ix = torch.round(px).to(torch.int64)
    iy = torch.round(py).to(torch.int64)
    buf = torch.zeros((h * w,), dtype=torch.float32, device=z.device)
    r2 = r_px * r_px
    for dy, dx in footprint(r_px, valid):
        d2 = float(dx * dx + dy * dy)
        lin, inb = _footprint_index(ix, iy, dy, dx, w, h)
        m = valid & (d2 <= r2) & inb
        chord = 2.0 * torch.sqrt(torch.clamp_min(r2 - d2, 0.0)) * z / f
        buf.index_add_(0, lin, torch.where(m, chord * scale / rad, 0.0).to(torch.float32))
    return buf.reshape(h, w)


# --- compose (the JAX package's transliteration of ssf.compose) ---------------


def _sh3_evaluate(dirs, coeffs):
    """environment.sh3_evaluate (sh.glsl:20-32), its order of operations
    and its clamp at 0 (the JAX package's device pass drops the clamp)."""
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    r = (
        coeffs[0] * _B0
        + coeffs[1] * (-_B1) * y
        + coeffs[2] * _B1 * z
        + coeffs[3] * (-_B1) * x
        + coeffs[4] * _B2N * y * x
        + coeffs[5] * (-_B2N) * y * z
        + coeffs[6] * _B2Z * (3.0 * z * z - 1.0)
        + coeffs[7] * (-_B2N) * x * z
        + coeffs[8] * _B2N * 0.5 * (x * x - y * y)
    )
    return torch.clamp_min(r, 0.0)


def cubemap_sample(faces: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """``render/cubemap.Cubemap.sample`` on the device: ``faces`` uint8
    [6, R, R, 4] RGBE, ``dirs`` [..., 3] unit -> [..., 3] f32 radiance (the
    reference's dir.zyx swizzle, GL face selection, nearest texel, RGBE
    decode)."""
    d = dirs.to(torch.float32).flip(-1)  # .zyx swizzle
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    ma = torch.clamp_min(torch.where(is_x, ax, torch.where(is_y, ay, az)), 1e-20)
    face = torch.where(
        is_x, torch.where(x >= 0, 0, 1),
        torch.where(is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)),
    )
    sc = torch.where(is_x, torch.where(x >= 0, -z, z), torch.where(is_y, x, torch.where(z >= 0, x, -x)))
    tc = torch.where(is_y, torch.where(y >= 0, z, -z), -y)
    r = faces.shape[1]
    u = ((sc / ma + 1.0) * 0.5 * r).to(torch.int32).clamp(0, r - 1).long()
    v = ((tc / ma + 1.0) * 0.5 * r).to(torch.int32).clamp(0, r - 1).long()
    rgbe = faces[face.long(), v, u]
    e = rgbe[..., 3:4].to(torch.int32)
    out = rgbe[..., :3].to(torch.float32) * torch.exp2(e.to(torch.float32) - 136.0)
    return torch.where(e == 0, 0.0, out)


class _Sky:
    """The lighting as device tensors, and the installed cubemap's faces."""

    def __init__(self, lt: Lighting, device):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.sh3, self.dir, self.rad = t(lt.sh3), t(lt.dir_light_direction), t(lt.dir_light_radiance)
        cm = environment._SKY_CUBEMAP
        self.faces = torch.as_tensor(cm.faces, device=device) if cm is not None else None

    def __call__(self, dirs):
        """The sky along unit ``dirs``: the cubemap when one is installed,
        else the SH stand-in with the sun (environment.sh_sky_color)."""
        if self.faces is not None:
            return cubemap_sample(self.faces, dirs)
        base = _sh3_evaluate(dirs, self.sh3) * SKY_EXPOSURE
        cos_sun = torch.sum(dirs * -self.dir, dim=-1, keepdim=True)
        disk = torch.clamp((cos_sun - 0.9995) / 0.0005, 0.0, 1.0) ** 2
        glow = torch.clamp(cos_sun, 0.0, 1.0) ** 64
        return base + self.rad * (3.0 * disk + 0.15 * glow)


def _grid_box_filter(p, ddx, ddy, n: float):
    p = p + 0.5 / n
    wdt = torch.maximum(ddx.abs(), ddy.abs()) + 0.01
    a = p + 0.5 * wdt
    b = p - 0.5 * wdt
    i = (torch.floor(a) + torch.clamp_max((a - torch.floor(a)) * n, 1.0)
         - torch.floor(b) - torch.clamp_max((b - torch.floor(b)) * n, 1.0)) / (n * wdt)
    return (1.0 - i[..., 0]) * (1.0 - i[..., 1])


def _gradient(a, axis: int):
    """np.gradient (central differences, one-sided edges)."""
    n = a.shape[axis]
    lead = a.narrow(axis, 1, 1) - a.narrow(axis, 0, 1)
    mid = 0.5 * (a.narrow(axis, 2, n - 2) - a.narrow(axis, 0, n - 2))
    tail = a.narrow(axis, n - 1, 1) - a.narrow(axis, n - 2, 1)
    return torch.cat([lead, mid, tail], dim=axis)


def _sample_background(position_w, dirs, sky: _Sky):
    dy = dirs[..., 1]
    d = -(position_w[1] / torch.where(dy.abs() < 1e-9, -1e-9, dy))
    plane_pos = position_w[None, None, :] + dirs * d[..., None]
    plane_size = 10.0
    on_plane = (d > 0.0) & (plane_pos[..., 0].abs() < plane_size) & (plane_pos[..., 2].abs() < plane_size)
    pxz = plane_pos[..., [0, 2]]
    ddx = _gradient(pxz, 1)
    ddy = _gradient(pxz, 0)
    ddx = torch.where(~torch.isfinite(ddx) | (ddx.abs() > 1e3), 0.0, ddx)
    ddy = torch.where(~torch.isfinite(ddy) | (ddy.abs() > 1e3), 0.0, ddy)

    albedo = torch.full_like(dirs, 0.8)
    g1 = _grid_box_filter(pxz * 10.0, ddx * 10.0, ddy * 10.0, 50.0)[..., None]
    albedo = 0.6 + (albedo - 0.6) * g1
    g2 = _grid_box_filter(pxz, ddx, ddy, 80.0)[..., None]
    albedo = 0.2 + (albedo - 0.2) * g2
    ground = albedo * sky.rad * (-sky.dir[1])
    # environment.sample_background returns float32
    return torch.where(on_plane[..., None], ground, sky(dirs)).to(torch.float32)


def _reconstruct(depth, cam_pos, right, up, fwd, f, w: int, h: int):
    """ssf.reconstruct_normals_positions: ``depth`` as stored (float32: the
    neighbour choice compares its differences in that type), the rays and
    positions in the camera's type."""
    dev, dt = depth.device, cam_pos.dtype
    xs = (torch.arange(w, dtype=dt, device=dev) - w / 2.0 + 0.5) / f
    ys = -(torch.arange(h, dtype=dt, device=dev) - h / 2.0 + 0.5) / f
    ray = fwd[None, None] + xs[None, :, None] * right[None, None] + ys[:, None, None] * up[None, None]

    def pos_at(d, ray_d):
        return cam_pos[None, None] + ray_d * d[..., None]

    p = pos_at(depth, ray)
    d_up = _tshift(depth, -1, 0)
    d_down = _tshift(depth, 1, 0)
    d_left = _tshift(depth, -1, 1)
    d_right = _tshift(depth, 1, 1)
    use_right = (d_right - depth).abs() < (d_left - depth).abs()
    use_down = (d_down - depth).abs() < (d_up - depth).abs()

    p_r = pos_at(d_right, torch.roll(ray, -1, dims=1)) - p
    p_l = pos_at(d_left, torch.roll(ray, 1, dims=1)) - p
    p_u = pos_at(d_up, torch.roll(ray, 1, dims=0)) - p
    p_d = pos_at(d_down, torch.roll(ray, -1, dims=0)) - p
    ur = use_right[..., None]
    ud = use_down[..., None]
    p1 = torch.where(ud, torch.where(ur, p_d, p_l), torch.where(ur, p_r, p_u))
    p2 = torch.where(ud, torch.where(ur, p_r, p_d), torch.where(ur, p_u, p_l))
    n = torch.linalg.cross(p2, p1, dim=-1)
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-9)
    to_cam = -ray / torch.clamp_min(torch.linalg.norm(ray, dim=-1, keepdim=True), 1e-9)
    flip = torch.sum(n * to_cam, dim=-1, keepdim=True) < 0.0
    return torch.where(flip, -n, n), p


def _hg_phase(g, cos_theta):
    g2 = g * g
    return (1.0 - g2) * (1.0 + g2 - 2.0 * g * cos_theta) ** (-1.5) / (4.0 * np.pi)


def _fresnel_dielectric(c, eta: float):
    """environment.fresnel_dielectric (brdf.glsl:4-13), in float32 as it
    computes."""
    c = c.to(torch.float32)
    temp = eta * eta + c * c - 1.0
    g = torch.sqrt(torch.clamp_min(temp, 0.0))
    num = 0.5 * ((g - c) / torch.clamp_min(g + c, 1e-9)) ** 2
    den = (g - c) * c + 1.0
    frac = ((g + c) * c - 1.0) / torch.where(den.abs() < 1e-9, 1e-9, den)
    out = num * (1.0 + frac**2)
    return torch.where(temp < 0.0, 1.0, out)


def compose(rgb, scene_depth, fluid_depth, thickness_w, cam_pos, right, up, fwd, f, near,
            grid_to_world: float, sky: _Sky, w: int, h: int):
    """ssf.compose on tensors: refract + absorb + scatter + reflect +
    Fresnel, in the camera's type (the images and depths as stored). Depths
    in grid units; thickness_w in world units."""
    dev = rgb.device
    g2w = torch.tensor(grid_to_world, dtype=cam_pos.dtype, device=dev)
    has_fluid = (thickness_w > 0.0) & (fluid_depth < _FAR) & (fluid_depth < scene_depth)
    normal, position = _reconstruct(fluid_depth, cam_pos, right, up, fwd, f, w, h)
    to_cam = cam_pos[None, None] - position
    to_cam = to_cam / torch.clamp_min(torch.linalg.norm(to_cam, dim=-1, keepdim=True), 1e-9)

    cos_i = torch.clamp(torch.sum(to_cam * normal, dim=-1, keepdim=True), -1.0, 1.0)
    eta_inv = 1.0 / ETA_WATER
    sin2_t = eta_inv**2 * torch.clamp_min(1.0 - cos_i**2, 0.0)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    refr = eta_inv * (-to_cam) + (eta_inv * cos_i - cos_t) * normal

    exit_est = position + (thickness_w / g2w)[..., None] * refr
    px, py, _, _ = project(exit_est.reshape(-1, 3), cam_pos, right, up, fwd, f, near, w, h)
    ix = torch.round(px).to(torch.int64).clamp(0, w - 1).reshape(h, w)
    iy = torch.round(py).to(torch.int64).clamp(0, h - 1).reshape(h, w)
    refr_rgb = rgb[iy, ix]
    refr_is_bg = scene_depth[iy, ix] >= _FAR
    world_cam = cam_pos * g2w
    bg_refr = _sample_background(world_cam, refr, sky)
    refr_rgb = torch.where(refr_is_bg[..., None], bg_refr, refr_rgb)

    wd = torch.maximum(thickness_w, thickness_w[iy, ix]) * 3.0
    extinct = torch.as_tensor(EXTINCT, device=dev)
    transmit = torch.exp(-wd[..., None] * extinct)
    refr_rgb = refr_rgb * transmit
    cos_cam_light = torch.sum(to_cam * sky.dir[None, None], dim=-1, keepdim=True)
    scattered = torch.as_tensor(SCATTER, device=dev) * sky.rad * _hg_phase(torch.as_tensor(HG_G, device=dev),
                                                                           cos_cam_light)
    refraction_color = scattered + (refr_rgb - scattered) * transmit

    refl = -to_cam - 2.0 * torch.sum(-to_cam * normal, dim=-1, keepdim=True) * normal
    refl_rgb = _sample_background(world_cam, refl, sky)
    fresnel = _fresnel_dielectric(torch.clamp(cos_i[..., 0], 0.0, 1.0), ETA_WATER)[..., None]
    color = refraction_color + (refl_rgb - refraction_color) * fresnel
    return torch.where(has_fluid[..., None], color, rgb)


def fluid_pass(positions, rgb, scene_depth, camera, radius: float, grid_to_world: float,
               lighting: Lighting = None, device=None):
    """The whole SSF fluid pass on ``device`` (default: that of
    ``positions``, a tensor, or the CPU for numpy input): the renderer's
    numpy sequence (_splat -> narrow_range_filter -> _thickness ->
    thickness_filter -> ssf.compose) in PyTorch, the JAX package's
    ``_fluid_pass``, at numpy's precision (module docstring). ``rgb``
    [H, W, 3] and ``scene_depth`` [H, W] are numpy arrays or tensors. ->
    (rgb f64 [H, W, 3], depth f32 [H, W]) tensors on the device."""
    if device is None:
        device = positions.device if isinstance(positions, torch.Tensor) else torch.device("cpu")
    f64 = torch.float64

    def t(a, dtype=f64):
        return torch.as_tensor(a, device=device).to(dtype)

    scene_depth = t(scene_depth, torch.float32)
    h, w = scene_depth.shape
    r, u, fw = (t(v) for v in camera.basis())
    cam_pos = t(camera.position)
    f = camera.focal_px(h)
    sky = _Sky(lighting or LIGHTING, device)

    px, py, z, r_px, valid, f_t = screen_points(positions, radius, camera, w, h, device)
    pdepth = splat_depth(px, py, z, r_px, valid, w, h, f_t)
    pdepth = narrow_range_filter(pdepth, float(radius))
    r_px_t = torch.clamp(f * radius / torch.clamp_min(z, 1e-3), 0.6, 6.0)
    thick = splat_thickness(px, py, z, r_px_t, valid, w, h, f_t, 0.25 * grid_to_world, radius)
    thick = thickness_filter(thick)
    out = compose(t(rgb, torch.float32), scene_depth, pdepth, thick.to(f64), cam_pos, r, u, fw, f_t, camera.near,
                  grid_to_world, sky, w, h)
    m = (pdepth < scene_depth) & (thick > 0.0)
    return out, torch.where(m, pdepth, scene_depth)
