"""Z-tested 3D line rasterization — the StaticLineRenderer analog
(src/renderer/static_line_renderer.rs, shader/lines.vert +
vertex_color.frag): world-space line lists with per-vertex color, depth-tested
against the scene.

Also builds the two line lists the reference draws with it:
- the domain bounds box (scene_renderer.rs:134-171, black);
- the per-cell staggered velocity lines
  (shader/volume_visualization/velocity.vert).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .camera import Camera

_FAR = 1e9


def draw_lines(
    rgb: np.ndarray,
    depth: np.ndarray,
    camera: Camera,
    p0: np.ndarray,
    p1: np.ndarray,
    colors: np.ndarray,
) -> None:
    """Rasterize segments p0->p1 (grid space, f32[N,3]) into rgb/depth in
    place. colors: f32[N,3] per segment (constant along the line — the two
    reference line users draw constant-color segments)."""
    if len(p0) == 0:
        return
    h, w = depth.shape
    x0, y0, z0, v0 = camera.project(p0, w, h)
    x1, y1, z1, v1 = camera.project(p1, w, h)
    ok = v0 & v1
    if not ok.any():
        return
    x0, y0, z0 = x0[ok], y0[ok], z0[ok]
    x1, y1, z1 = x1[ok], y1[ok], z1[ok]
    cols = colors[ok]

    # per-segment parameter spacing ~ 1 sample/pixel: t_i = min(i/len, 1), so
    # short segments collapse their surplus samples onto the endpoint
    length = np.hypot(x1 - x0, y1 - y0)
    n_max = int(min(max(np.ceil(length.max()) + 1, 2), 2048))
    idx = np.arange(n_max, dtype=np.float32)[None, :]  # [1, S]
    t = np.minimum(idx / np.maximum(length, 1.0)[:, None], 1.0)  # [N, S]

    xs = x0[:, None] + (x1 - x0)[:, None] * t
    ys = y0[:, None] + (y1 - y0)[:, None] * t
    # depth interpolates linearly in 1/z under perspective
    iz = 1.0 / z0[:, None] + (1.0 / z1[:, None] - 1.0 / z0[:, None]) * t
    zs = 1.0 / np.maximum(iz, 1e-9)

    ix = np.round(xs).astype(np.int64)
    iy = np.round(ys).astype(np.int64)
    m = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    if not m.any():
        return
    seg_idx = np.broadcast_to(np.arange(len(x0))[:, None], m.shape)[m]
    lin = (iy[m] * w + ix[m]).astype(np.int64)
    zf = zs[m].astype(np.float32)

    flat_d = depth.reshape(-1)
    # z-test with a small bias so lines on surfaces win
    zbuf = np.full(h * w, _FAR, np.float32)
    np.minimum.at(zbuf, lin, zf)
    win = zf <= np.maximum(zbuf[lin], 0.0)  # this draw's closest sample
    passed = zf < flat_d[lin] * 1.001
    sel = win & passed
    if not sel.any():
        return
    flat_rgb = rgb.reshape(-1, 3)
    flat_rgb[lin[sel]] = cols[seg_idx[sel]]
    flat_d[lin[sel]] = zf[sel]


def domain_bounds_lines(grid_dim: Tuple[int, int, int]):
    """The 12 domain edges, black (scene_renderer.rs:134-171)."""
    x, y, z = (float(v) for v in grid_dim)
    lo = np.zeros(3)
    hi = np.asarray([x, y, z])
    c = lambda a, b, d: np.array([a, b, d], np.float32)  # noqa: E731
    p0, p1 = [], []
    for (a, b) in (
        # far face (z = max), near face (z = min)
        ((lo[0], lo[1], hi[2]), (hi[0], lo[1], hi[2])),
        ((hi[0], lo[1], hi[2]), (hi[0], hi[1], hi[2])),
        ((hi[0], hi[1], hi[2]), (lo[0], hi[1], hi[2])),
        ((lo[0], hi[1], hi[2]), (lo[0], lo[1], hi[2])),
        ((lo[0], lo[1], lo[2]), (hi[0], lo[1], lo[2])),
        ((hi[0], lo[1], lo[2]), (hi[0], hi[1], lo[2])),
        ((hi[0], hi[1], lo[2]), (lo[0], hi[1], lo[2])),
        ((lo[0], hi[1], lo[2]), (lo[0], lo[1], lo[2])),
        # between
        ((lo[0], lo[1], lo[2]), (lo[0], lo[1], hi[2])),
        ((hi[0], lo[1], lo[2]), (hi[0], lo[1], hi[2])),
        ((hi[0], hi[1], lo[2]), (hi[0], hi[1], hi[2])),
        ((lo[0], hi[1], lo[2]), (lo[0], hi[1], hi[2])),
    ):
        p0.append(c(*a))
        p1.append(c(*b))
    n = len(p0)
    return np.asarray(p0), np.asarray(p1), np.zeros((n, 3), np.float32)


def colormap_cool_to_warm(t: np.ndarray) -> np.ndarray:
    """utilities.glsl:31 colormapCoolToWarm: white at 0, blue at -1, red +1."""
    t = np.clip(np.asarray(t, np.float32), -1.0, 1.0)[..., None]
    white = np.ones(3, np.float32)
    blue = np.array([0.0, 0.0, 1.0], np.float32)
    red = np.array([1.0, 0.0, 0.0], np.float32)
    return np.where(t < 0.0, white + (blue - white) * (-t), white + (red - white) * t)


def velocity_lines(
    velocity: np.ndarray,
    marker: np.ndarray,
    viz_scale: float,
    max_lines: int = 60000,
):
    """Per-cell staggered velocity lines (velocity.vert:29-69): for each of the
    3 staggered components, a segment from the face center along that axis,
    length clamp(v*scale, -1, 1) cells, cool-to-warm colored. Lines where
    neither side of the face is fluid (or v is NaN) are dropped; the densest
    cells are subsampled to max_lines."""
    from ..core.types import CELL_FLUID

    p0s, p1s, cols = [], [], []
    fluid = marker == CELL_FLUID
    for c in range(3):
        v = velocity[..., c]
        nbr = np.roll(fluid, -1, axis=c)
        nbr[tuple(slice(-1, None) if a == c else slice(None) for a in range(3))] = False
        show = (fluid | nbr) & np.isfinite(v) & (v != 0.0)
        idx = np.argwhere(show)
        if len(idx) == 0:
            continue
        scale = np.clip(v[show] * viz_scale, -1.0, 1.0)
        base = idx.astype(np.float32) + 0.5
        base[:, c] += 0.5  # face center
        tip = base.copy()
        tip[:, c] += scale
        p0s.append(base)
        p1s.append(tip)
        cols.append(colormap_cool_to_warm(scale))
    if not p0s:
        return (np.zeros((0, 3), np.float32),) * 3
    p0 = np.concatenate(p0s)
    p1 = np.concatenate(p1s)
    col = np.concatenate(cols)
    if len(p0) > max_lines:
        sel = np.random.default_rng(0).choice(len(p0), max_lines, replace=False)
        p0, p1, col = p0[sel], p1[sel], col[sel]
    return p0, p1, col
