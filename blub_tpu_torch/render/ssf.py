"""Screen-space fluid: narrow-range filtered depth + gaussian-filtered
thickness + physically-based compose.

Ports of shader/screenspace_fluid/*:
- narrow_range_filter.glsl:1-175 ("A Narrow-Range Filter for Screen-Space
  Fluid Rendering", Truong et al. 2018, with the reference's flavoring):
  1D-Y, 1D-X (half size 32), then 2D (half size 6) passes with the dynamic
  depth-range clamp, vectorized over the image instead of per-workgroup
  shared memory;
- thickness_filter.comp: separable gaussian (half size 16, sigma 6.4),
  zero-sample rejection;
- particles.frag:12-25: thickness = sphere chord length * 0.25*s_g/radius;
- fluid_render.comp:64-186: refraction exit estimate + backbuffer resample,
  Beer-Lambert extinction, Henyey-Greenstein single-scattering mix, background
  reflection, dielectric Fresnel (eta water/air) — including the reference's
  made-up extinction color (fluid_render.comp:58-61) and the *3 water depth
  fudge (fluid_render.comp:104-106).

A port of ``blub_tpu/render/ssf.py``. The numpy versions
(``narrow_range_filter_np``, ``thickness_filter_np``,
``reconstruct_normals_positions``, ``compose``) are copied: they are the
renderer's plain version on the CPU and the oracle of the PyTorch filters,
``narrow_range_filter`` and ``thickness_filter``, which take a tensor and run
on its device (the JAX package's jitted filters ``_nr_filter_jit`` and
``_thickness_filter_jit``, op for op).
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import Camera
from .environment import Lighting, LIGHTING, fresnel_dielectric, sample_background

_FAR = 1e9

ETA_WATER = 1.333 / 1.00029
HG_G = np.asarray([0.726, 0.820, 0.921], np.float32)  # Mission Bay 10ft 30min
SCATTER = np.asarray([0.2415, 0.2762, 0.3256], np.float32)  # Mission Bay surface
EXTINCT = np.asarray([0.46, 0.18, 0.06], np.float32) + SCATTER  # "made up completely"


def narrow_range_filter_np(depth: np.ndarray, particle_radius: float) -> np.ndarray:
    """Numpy oracle for `narrow_range_filter` (the same algorithm)."""
    d = np.where(depth < _FAR, depth, 99999.0).astype(np.float32)
    d = _nr_pass_1d(d, particle_radius, axis=0)  # Y first (push const 1)
    d = _nr_pass_1d(d, particle_radius, axis=1)
    d = _nr_pass_2d(d, particle_radius)
    return np.where(depth < _FAR, d, depth)


def narrow_range_filter(depth: torch.Tensor, particle_radius: float) -> torch.Tensor:
    """The three filter passes over a view-space depth image (grid units;
    _FAR where empty) on its device: the PyTorch version of the JAX
    package's ``_nr_filter_jit``; ``narrow_range_filter_np`` is its
    oracle."""
    d = torch.where(depth < _FAR, depth, 99999.0)
    d = _tnr_pass_1d(d, particle_radius, axis=0)  # Y first (push const 1)
    d = _tnr_pass_1d(d, particle_radius, axis=1)
    d = _tnr_pass_2d(d, particle_radius)
    return torch.where(depth < _FAR, d, depth)


def _tshift(a: torch.Tensor, off: int, axis: int) -> torch.Tensor:
    """out[i] = a[i + off] along ``axis``, 99999 where i + off leaves the
    image (outside the screen there is no fluid): the JAX package's
    ``_jshift``, a roll whose shifted-in rows are filled."""
    n = a.shape[axis]
    out = torch.full_like(a, 99999.0)
    if abs(off) < n:
        src = a.narrow(axis, max(off, 0), n - abs(off))
        out.narrow(axis, max(-off, 0), n - abs(off)).copy_(src)
    return out


def _tshift2(a, dy: int, dx: int):
    return _tshift(_tshift(a, dy, 0), dx, 1)


def _tnr_state(center, particle_radius: float, half_max: int, h: int):
    """_nr_state on tensors. Its divisions by and of host scalars divide
    truly, as numpy does (PyTorch takes a reciprocal for a scalar divisor on
    the card, and for a scalar dividend everywhere)."""
    def full(v):
        return torch.full_like(center, v)

    world_sigma = 1.5 * particle_radius
    sigma = full(h * world_sigma) / (torch.clamp_min(center, 1e-6) * 2.0)
    filter_size_f = torch.clamp_max(sigma * 3.0, float(half_max))
    sigma = filter_size_f / full(3.0)
    k = full(0.5) / torch.clamp_min(sigma, 1e-6) ** 2
    return filter_size_f, k


def _tnr_accum(samples_a, samples_b, weight, r, filter_size_f, state):
    lo, hi, total_w, acc, bound, thr = state
    active = r <= torch.ceil(filter_size_f)
    ok = (samples_a >= lo) & (samples_b >= lo) & active
    sa = torch.where(samples_a > hi, bound, samples_a)
    sb = torch.where(samples_b > hi, bound, samples_b)
    lo = torch.where(ok, torch.minimum(lo, torch.minimum(sa, sb) - thr), lo)
    hi = torch.where(ok, torch.maximum(hi, torch.maximum(sa, sb) + thr), hi)
    total_w = total_w + torch.where(ok, weight * 2.0, 0.0)
    acc = acc + torch.where(ok, (sa + sb) * weight, 0.0)
    return lo, hi, total_w, acc, bound, thr


def _tnr_pass_1d(d, particle_radius: float, axis: int):
    half = 32
    h = d.shape[0]
    fsize, k = _tnr_state(d, particle_radius, half, h)
    valid = (d > 0.0) & (d < 9999.0)
    thr = 10.0 * particle_radius
    mu = 1.0 * particle_radius
    state = (d - thr, d + thr, torch.ones_like(d), d, d + mu, thr)
    for r in range(1, half + 1):
        w = torch.exp(-(r * r) * k)
        state = _tnr_accum(_tshift(d, -r, axis), _tshift(d, r, axis), w, r, fsize, state)
    lo, hi, total_w, acc, bound, _ = state
    out = acc / torch.clamp_min(total_w, 1e-9)
    return torch.where(valid, out, d)


def _tnr_pass_2d(d, particle_radius: float):
    half = 6
    h = d.shape[0]
    fsize, k = _tnr_state(d, particle_radius, half, h)
    valid = (d > 0.0) & (d < 9999.0)
    thr = 10.0 * particle_radius
    mu = 1.0 * particle_radius
    state = (d - thr, d + thr, torch.ones_like(d), d, d + mu, thr)
    for r in range(1, half + 1):
        for i in range(2 * r):
            w = torch.exp(-((r * r) + (r - i) ** 2) * k)
            state = _tnr_accum(_tshift2(d, r - i, r), _tshift2(d, -(r - i), -r), w, r, fsize, state)
            state = _tnr_accum(_tshift2(d, -r, r - i), _tshift2(d, r, -(r - i)), w, r, fsize, state)
    lo, hi, total_w, acc, bound, _ = state
    out = acc / torch.clamp_min(total_w, 1e-9)
    return torch.where(valid, out, d)


def _nr_state(center: np.ndarray, particle_radius: float, half_max: int, h: int):
    """Per-pixel filter size + gaussian k (narrow_range_filter.glsl:44-47,
    131-136): worldSpaceSigma = 1.5r, clamped to the max half size, sigma
    corrected back so the kernel never degenerates to a box."""
    world_sigma = 1.5 * particle_radius
    sigma = h * world_sigma / (np.maximum(center, 1e-6) * 2.0)
    filter_size_f = np.minimum(float(half_max), sigma * 3.0)
    sigma = filter_size_f / 3.0
    k = 0.5 / np.maximum(sigma, 1e-6) ** 2
    return filter_size_f, k


def _nr_accum(samples_a, samples_b, weight, r, filter_size_f, state):
    """narrowRangeFilter (glsl:53-71) for a symmetric sample pair, vectorized
    with per-pixel state = (lo, hi, total_w, acc, higher_bound, thr, active)."""
    lo, hi, total_w, acc, bound, thr = state
    active = r <= np.ceil(filter_size_f)
    ok = (samples_a >= lo) & (samples_b >= lo) & active
    sa = np.where(samples_a > hi, bound, samples_a)
    sb = np.where(samples_b > hi, bound, samples_b)
    lo = np.where(ok, np.minimum(lo, np.minimum(sa, sb) - thr), lo)
    hi = np.where(ok, np.maximum(hi, np.maximum(sa, sb) + thr), hi)
    total_w = total_w + np.where(ok, weight * 2.0, 0.0)
    acc = acc + np.where(ok, (sa + sb) * weight, 0.0)
    return lo, hi, total_w, acc, bound, thr


def _nr_pass_1d(d: np.ndarray, particle_radius: float, axis: int) -> np.ndarray:
    half = 32
    h = d.shape[0]
    fsize, k = _nr_state(d, particle_radius, half, h)
    valid = (d > 0.0) & (d < 9999.0)
    thr = 10.0 * particle_radius
    mu = 1.0 * particle_radius
    state = (d - thr, d + thr, np.ones_like(d), d.copy(), d + mu, thr)
    for r in range(1, half + 1):
        w = np.exp(-(r * r) * k)
        sa = _shift(d, -r, axis)
        sb = _shift(d, r, axis)
        state = _nr_accum(sa, sb, w, r, fsize, state)
    lo, hi, total_w, acc, bound, _ = state
    out = acc / np.maximum(total_w, 1e-9)
    return np.where(valid, out, d)


def _nr_pass_2d(d: np.ndarray, particle_radius: float) -> np.ndarray:
    half = 6
    h = d.shape[0]
    fsize, k = _nr_state(d, particle_radius, half, h)
    valid = (d > 0.0) & (d < 9999.0)
    thr = 10.0 * particle_radius
    mu = 1.0 * particle_radius
    state = (d - thr, d + thr, np.ones_like(d), d.copy(), d + mu, thr)
    # sample the square ring at radius r, 4 equidistant points at a time
    # (narrow_range_filter.glsl:139-155)
    for r in range(1, half + 1):
        for i in range(2 * r):
            w = np.exp(-((r * r) + (r - i) ** 2) * k)
            sa = _shift2(d, r - i, r)
            sb = _shift2(d, -(r - i), -r)
            state = _nr_accum(sa, sb, w, r, fsize, state)
            sa = _shift2(d, -r, r - i)
            sb = _shift2(d, r, -(r - i))
            state = _nr_accum(sa, sb, w, r, fsize, state)
    lo, hi, total_w, acc, bound, _ = state
    out = acc / np.maximum(total_w, 1e-9)
    return np.where(valid, out, d)


def _shift(a: np.ndarray, off: int, axis: int) -> np.ndarray:
    """Shifted view with edge clamp (texelFetch out-of-range -> edge here)."""
    out = np.roll(a, -off, axis=axis)
    if off > 0:
        idx = tuple(slice(-off, None) if ax == axis else slice(None) for ax in range(a.ndim))
    else:
        idx = tuple(slice(None, -off) if ax == axis else slice(None) for ax in range(a.ndim))
    out[idx] = 99999.0  # outside the screen there is no fluid
    return out


def _shift2(a: np.ndarray, dy: int, dx: int) -> np.ndarray:
    return _shift(_shift(a, dy, 0), dx, 1)


def thickness_filter(thick: torch.Tensor) -> torch.Tensor:
    """thickness_filter.comp on the tensor's device: separable gaussian,
    half size 16, sigma = 16*0.4, samples of exactly 0 carry no weight (the
    JAX package's ``_thickness_filter_jit``, cyclic rolls included);
    ``thickness_filter_np`` is its oracle."""
    half, k = 16, 0.5 / (16 * 0.4) ** 2
    out = thick
    for axis in (0, 1):
        acc = out
        total_w = torch.ones_like(out)
        for r in range(1, half + 1):
            w = float(np.exp(-(r * r) * k))
            for s in (-r, r):
                sample = torch.roll(out, -s, dims=axis)
                nz = sample != 0.0
                acc = acc + torch.where(nz, sample * w, 0.0)
                total_w = total_w + torch.where(nz, w, 0.0)
        nz_center = out != 0.0
        out = torch.where(nz_center, acc / total_w, out)
    return out


def thickness_filter_np(thick: np.ndarray) -> np.ndarray:
    """Numpy oracle for `thickness_filter`."""
    half, k = 16, 0.5 / (16 * 0.4) ** 2
    out = thick
    for axis in (0, 1):
        acc = out.copy()
        total_w = np.ones_like(out)
        for r in range(1, half + 1):
            w = float(np.exp(-(r * r) * k))
            for s in (-r, r):
                sample = np.roll(out, -s, axis=axis)
                nz = sample != 0.0
                acc = acc + np.where(nz, sample * w, 0.0)
                total_w = total_w + np.where(nz, w, 0.0)
        nz_center = out != 0.0
        out = np.where(nz_center, acc / total_w, out)
    return out


def reconstruct_normals_positions(depth: np.ndarray, camera: Camera):
    """fluid_render.comp:118-165: position from view-space depth; normal from
    the cross product of the two best (closest-depth) neighbor offsets."""
    h, w = depth.shape
    right, up, fwd = camera.basis()
    f = camera.focal_px(h)
    xs = (np.arange(w) - w / 2.0 + 0.5) / f
    ys = -(np.arange(h) - h / 2.0 + 0.5) / f
    ray = (
        fwd[None, None]
        + xs[None, :, None] * right[None, None]
        + ys[:, None, None] * up[None, None]
    )

    def pos_at(d, ray_d):
        return camera.position[None, None] + ray_d * d[..., None]

    p = pos_at(depth, ray)
    d_up = _shift(depth, -1, 0)
    d_down = _shift(depth, 1, 0)
    d_left = _shift(depth, -1, 1)
    d_right = _shift(depth, 1, 1)
    use_right = np.abs(d_right - depth) < np.abs(d_left - depth)
    use_down = np.abs(d_down - depth) < np.abs(d_up - depth)

    # each neighbor reconstructs along ITS OWN pixel ray (comp:125-136)
    p_r = pos_at(d_right, np.roll(ray, -1, axis=1)) - p
    p_l = pos_at(d_left, np.roll(ray, 1, axis=1)) - p
    p_u = pos_at(d_up, np.roll(ray, 1, axis=0)) - p
    p_d = pos_at(d_down, np.roll(ray, -1, axis=0)) - p
    # the four best-neighbor cases of comp:139-160: (p1, p2) =
    # (right,up):(p_r,p_u) (right,down):(p_d,p_r) (left,up):(p_u,p_l)
    # (left,down):(p_l,p_d); normal = cross(p2, p1)
    ur = use_right[..., None]
    ud = use_down[..., None]
    p1 = np.where(ud, np.where(ur, p_d, p_l), np.where(ur, p_r, p_u))
    p2 = np.where(ud, np.where(ur, p_r, p_d), np.where(ur, p_u, p_l))
    n = np.cross(p2, p1)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    # orient towards the camera (winding sign shortcuts above are approximate)
    to_cam = -ray / np.maximum(np.linalg.norm(ray, axis=-1, keepdims=True), 1e-9)
    flip = np.sum(n * to_cam, axis=-1, keepdims=True) < 0.0
    n = np.where(flip, -n, n)
    return n, p


def _hg_phase(g: np.ndarray, cos_theta: float) -> np.ndarray:
    """brdf.glsl:33-36."""
    g2 = g * g
    return (1.0 - g2) * (1.0 + g2 - 2.0 * g * cos_theta) ** (-1.5) / (4.0 * np.pi)


def compose(
    rgb: np.ndarray,
    scene_depth: np.ndarray,
    fluid_depth: np.ndarray,
    thickness_w: np.ndarray,
    camera: Camera,
    grid_to_world: float,
    lighting: Lighting = None,
) -> np.ndarray:
    """fluid_render.comp main: refract + absorb + scatter + reflect + Fresnel.
    fluid_depth/scene_depth in grid units; thickness_w in WORLD units."""
    lt = lighting or LIGHTING
    h, w = fluid_depth.shape
    has_fluid = (thickness_w > 0.0) & (fluid_depth < _FAR) & (fluid_depth < scene_depth)
    if not has_fluid.any():
        return rgb

    normal, position = reconstruct_normals_positions(fluid_depth, camera)
    to_cam = camera.position[None, None] - position
    to_cam = to_cam / np.maximum(np.linalg.norm(to_cam, axis=-1, keepdims=True), 1e-9)

    # --- refraction (fluid_render.comp:64-116) --------------------------------
    cos_i = np.clip(np.sum(to_cam * normal, axis=-1, keepdims=True), -1.0, 1.0)
    eta_inv = 1.0 / ETA_WATER
    sin2_t = eta_inv**2 * np.maximum(1.0 - cos_i**2, 0.0)
    cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 0.0))
    refr = eta_inv * (-to_cam) + (eta_inv * cos_i - cos_t) * normal

    water_depth_here = thickness_w  # view-space accumulated thickness (world)
    exit_est = position + (water_depth_here / grid_to_world)[..., None] * refr
    px, py, pz, _ = camera.project(exit_est.reshape(-1, 3), w, h)
    ix = np.clip(np.round(px).astype(np.int64), 0, w - 1).reshape(h, w)
    iy = np.clip(np.round(py).astype(np.int64), 0, h - 1).reshape(h, w)
    refr_rgb = rgb[iy, ix]
    refr_is_bg = scene_depth[iy, ix] >= _FAR
    # background pixels get "perfect" refraction: resample the sky along refr
    world_cam = camera.position * grid_to_world
    bg_refr, _ = sample_background(world_cam, refr, lt)
    refr_rgb = np.where(refr_is_bg[..., None], bg_refr, refr_rgb)

    wd = np.maximum(thickness_w, thickness_w[iy, ix]) * 3.0  # comp:104-106
    transmit = np.exp(-wd[..., None] * EXTINCT)
    refr_rgb = refr_rgb * transmit
    cos_cam_light = np.sum(to_cam * lt.dir_light_direction[None, None], axis=-1, keepdims=True)
    scattered = SCATTER * lt.dir_light_radiance * _hg_phase(HG_G, cos_cam_light)
    refraction_color = scattered + (refr_rgb - scattered) * transmit

    # --- reflection + Fresnel (comp:119-124, 181-186) -------------------------
    refl = -to_cam - 2.0 * np.sum(-to_cam * normal, axis=-1, keepdims=True) * normal
    refl_rgb, _ = sample_background(world_cam, refl, lt)
    fresnel = fresnel_dielectric(np.clip(cos_i[..., 0], 0.0, 1.0), ETA_WATER)[..., None]
    color = refraction_color + (refl_rgb - refraction_color) * fresnel

    return np.where(has_fluid[..., None], color, rgb)
