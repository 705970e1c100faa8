"""Offline scene renderer — the capability set of src/renderer/
(SceneRenderer, ParticleRenderer, ScreenSpaceFluid, VolumeRenderer,
VoxelRenderer, MeshRenderer, StaticLineRenderer, Background) behind the
state-readback boundary: the simulation hands over particle and grid arrays
and this module turns them into images, off the simulation's hot path.

Technique mapping:
- ParticleRenderer's ray-cast sphere impostors (sphere_particles.frag) ->
  z-buffered point splats with spherical depth offsets, sun+SH-lit;
- ScreenSpaceFluid -> narrow-range depth filter + gaussian thickness +
  refraction/Beer-Lambert/HG-scatter/reflection/Fresnel compose (render/ssf.py,
  render/device_ssf.py);
- MeshRenderer -> host triangle rasterizer over the scene's solid meshes
  (render/mesh.py), mesh.frag shading;
- VoxelRenderer -> exposed-face cubes of the voxelized occupancy, albedo =
  |voxel velocity| * viz scale (voxel_visualization.frag);
- VolumeRenderer -> SIGNED cool-to-warm billboards scaled by |value|
  (volume_visualization_with_billboards.vert) + staggered velocity line lists
  (velocity.vert) via the line rasterizer (render/lines.py);
- StaticLineRenderer -> domain bounds box, black (scene_renderer.rs:134-171);
- Background -> grid ground plane + SH sky + sun, reference lighting constants
  (render/environment.py).

Draw order mirrors scene_renderer.rs draw(): background -> solids (mesh /
voxel debug) -> fluid -> volume visualization -> bounds lines, then the
HDR->sRGB tonemap (hdr_backbuffer.rs:92).

A port of ``blub_tpu/render/renderer.py`` on a device (``device="cuda"``
unless the caller asks for the CPU). On the card the particle splats and the
screen-space fluid pass run in PyTorch (``_splat_device``,
``render/device_ssf.fluid_pass``); ``draw`` takes positions and velocities as
numpy arrays or as tensors on the device and brings only images back to the
host. On the CPU the numpy path is the plain version those are held to. The
background (kept while the camera and size stay), meshes, lines and the
tonemap are numpy on the host either way. Nothing falls back: a failure on
the device raises.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from . import device_ssf, environment, ssf
from .camera import Camera
from .environment import sample_background, shade_surface, tonemap
from .lines import colormap_cool_to_warm, domain_bounds_lines, draw_lines, velocity_lines
from .mesh import rasterize_mesh, voxel_surface_mesh


class FluidRenderingMode(enum.Enum):
    NONE = "none"
    SCREEN_SPACE_FLUID = "screen_space_fluid"
    PARTICLES_VELOCITY = "particles_velocity"
    PARTICLES_INDEX = "particles_index"


class VolumeVisualizationMode(enum.Enum):
    NONE = "none"
    VELOCITY = "velocity"  # staggered line list (velocity.vert)
    DIVERGENCE_ERROR = "divergence_error"
    PRESSURE_FROM_VELOCITY = "pressure_from_velocity"
    PRESSURE_FROM_DENSITY = "pressure_from_density"
    MARKER = "marker"
    DEBUG = "debug"


_FAR = 1e9
IDX_BITS, MAX_SPLAT_POINTS = device_ssf.IDX_BITS, device_ssf.MAX_SPLAT_POINTS


@dataclasses.dataclass
class RenderSettings:
    width: int = 640
    height: int = 480
    fluid_mode: FluidRenderingMode = FluidRenderingMode.PARTICLES_VELOCITY
    volume_mode: VolumeVisualizationMode = VolumeVisualizationMode.NONE
    particle_radius_factor: float = 1.0  # GUI knob (scene_renderer.rs:173-176)
    velocity_viz_scale: float = 0.01  # reference VelocityVisualizationScale
    grid_to_world_scale: float = 0.01  # scene fluid.grid_to_world_scale
    show_solid_meshes: bool = True  # MeshRenderer on/off
    show_voxel_debug: bool = False  # VoxelRenderer (debug view)
    show_bounds_box: bool = True  # StaticLineRenderer bounds


def _as_numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _check_key_room(n: int) -> None:
    """The packed splat key holds a point's index in its low 24 bits."""
    if n >= MAX_SPLAT_POINTS:
        raise ValueError(f"splat: {n} points, the packed key holds at most {MAX_SPLAT_POINTS - 1}")


class SceneRenderer:
    def __init__(self, grid_dim: Tuple[int, int, int], settings: RenderSettings | None = None,
                 camera: Camera | None = None, device="cuda"):
        self.grid_dim = grid_dim
        self.settings = settings or RenderSettings()
        self.camera = camera or Camera.framing(grid_dim)
        self.device = resolve_device(device)
        # 8 particles/cell at rest -> radius = 0.5 / cbrt(8) * 2 ~ half of the
        # inter-particle spacing (reference: scale / 8^(1/3) * factor, in
        # world units; here grid space).
        self.particle_radius = 0.5 * self.settings.particle_radius_factor
        self._bg_key = None
        self._bg = None

    # ------------------------------------------------------------------ core

    def _splat(self, pos, radius, values: Optional[np.ndarray] = None):
        """Z-buffered sphere splatting. radius: scalar or per-point f32[N].

        Returns (depth f32[H,W], winner i64[H,W] or None): depth buffer with
        spherical offsets, and per-pixel winning point index when ``values``
        colorization is needed (packed 64-bit min: the f32 depth bits above
        the point's 24-bit index). On the card the splat runs in PyTorch
        (``_splat_device``); on the CPU in numpy. Raises for 2^24 points or
        more with ``values`` (the key's index field)."""
        if values is not None:
            _check_key_room(len(pos))
        if self.device.type == "cuda":
            depth, winner = self._splat_device(pos, radius, values is not None)
            return depth.cpu().numpy(), (winner.cpu().numpy() if winner is not None else None)
        pos = _as_numpy(pos)
        s = self.settings
        w, h = s.width, s.height
        px, py, z, valid = self.camera.project(pos, w, h)
        f = self.camera.focal_px(h)
        radius = np.broadcast_to(np.asarray(radius, np.float32), (len(pos),))
        r_px = np.clip(f * radius / np.maximum(z, 1e-3), 0.6, 8.0)
        valid = valid & (radius > 1e-6)

        depth = np.full(h * w, _FAR, np.float32)
        keys = np.full(h * w, np.iinfo(np.int64).max, np.int64) if values is not None else None

        ix = np.round(px).astype(np.int64)
        iy = np.round(py).astype(np.int64)
        rmax = int(np.ceil(r_px.max())) if len(r_px) else 0
        idx_all = np.arange(pos.shape[0], dtype=np.int64)
        for dy in range(-rmax, rmax + 1):
            for dx in range(-rmax, rmax + 1):
                d2 = dx * dx + dy * dy
                m = valid & (d2 <= r_px * r_px)
                if not m.any():
                    continue
                x = ix[m] + dx
                y = iy[m] + dy
                inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                if not inb.any():
                    continue
                x, y = x[inb], y[inb]
                sel = np.nonzero(m)[0][inb]
                # spherical depth offset (sphere impostor, sphere_particles.frag)
                rr = r_px[sel]
                zoff = np.sqrt(np.maximum(rr * rr - d2, 0.0)) * z[sel] / f
                zz = (z[sel] - zoff).astype(np.float32)
                lin = y * w + x
                np.minimum.at(depth, lin, zz)
                if keys is not None:
                    zbits = zz.view(np.uint32).astype(np.int64)  # z>0: bits monotone
                    np.minimum.at(keys, lin, (zbits << IDX_BITS) | (idx_all[sel] & (MAX_SPLAT_POINTS - 1)))
        depth = depth.reshape(h, w)
        winner = None
        if keys is not None:
            winner = (keys & (MAX_SPLAT_POINTS - 1)).astype(np.int64).reshape(h, w)
            winner[depth >= _FAR] = -1
        return depth, winner

    def _splat_device(self, pos, radius, keys: bool):
        """The splat of ``_splat`` on the renderer's device, as tensors:
        (depth f32 [H,W], winner i64 [H,W] or None). The point math runs in
        float64, as numpy computes it (``device_ssf.screen_points``), and the
        splat is one ``scatter_reduce`` "amin" per footprint offset
        (``device_ssf.splat_depth``), over the packed keys with ``keys``. A
        min does not depend on the order, so this is numpy's splat up to the
        last bit of a float64 dot product, which moves an f32 depth or a
        rounded pixel about once in 2^29 points."""
        s = self.settings
        px, py, z, r_px, valid, f = device_ssf.screen_points(pos, radius, self.camera, s.width, s.height,
                                                             self.device)
        if keys:
            return device_ssf.splat_depth(px, py, z, r_px, valid, s.width, s.height, f, keys=True)
        return device_ssf.splat_depth(px, py, z, r_px, valid, s.width, s.height, f), None

    def _thickness(self, pos: np.ndarray, radius: float) -> np.ndarray:
        """Additive thickness splats (particles.frag:12-25): per pixel the
        sphere chord length * 0.25 * s_g / radius, in WORLD units."""
        s = self.settings
        w, h = s.width, s.height
        px, py, z, valid = self.camera.project(pos, w, h)
        f = self.camera.focal_px(h)
        r_px = np.clip(f * radius / np.maximum(z, 1e-3), 0.6, 6.0)
        buf = np.zeros(h * w, np.float32)
        ix = np.round(px).astype(np.int64)
        iy = np.round(py).astype(np.int64)
        rmax = int(np.ceil(r_px.max())) if len(r_px) else 0
        chord_scale = 0.25 * s.grid_to_world_scale
        for dy in range(-rmax, rmax + 1):
            for dx in range(-rmax, rmax + 1):
                d2 = dx * dx + dy * dy
                m = valid & (d2 <= r_px * r_px)
                if not m.any():
                    continue
                inb = (ix[m] + dx >= 0) & (ix[m] + dx < w) & (iy[m] + dy >= 0) & (iy[m] + dy < h)
                sel = np.nonzero(m)[0][inb]
                if not len(sel):
                    continue
                rr = r_px[sel]
                # chord through the sphere at this pixel, in grid units
                chord = 2.0 * np.sqrt(np.maximum(rr * rr - d2, 0.0)) * z[sel] / f
                lin = (iy[sel] + dy) * w + (ix[sel] + dx)
                np.add.at(buf, lin, chord * chord_scale / max(radius, 1e-6))
        return buf.reshape(h, w)

    def _ssf_pass(self, rgb, depth, positions):
        """Screen-space-fluid pass: on the card ``device_ssf.fluid_pass``
        (PyTorch, the sky's cubemap included); on the CPU the numpy sequence
        (splat -> narrow-range filter -> thickness -> gaussian -> compose),
        the plain version the card's pass is held to."""
        s = self.settings
        if self.device.type == "cuda":
            out, d = device_ssf.fluid_pass(positions, rgb, depth, self.camera, self.particle_radius,
                                           s.grid_to_world_scale, device=self.device)
            return out.cpu().numpy(), d.cpu().numpy()
        positions = _as_numpy(positions)
        pdepth, _ = self._splat(positions, self.particle_radius)
        pdepth = ssf.narrow_range_filter_np(pdepth, self.particle_radius)
        thick = self._thickness(positions, self.particle_radius)
        thick = ssf.thickness_filter_np(thick)
        rgb = ssf.compose(rgb, depth, pdepth, thick, self.camera, s.grid_to_world_scale)
        m = (pdepth < depth) & (thick > 0.0)
        depth = np.where(m, pdepth, depth)
        return rgb, depth

    # ------------------------------------------------------------ background

    def _background(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rgb f32[H,W,3] linear HDR, view-depth f32[H,W] grid units) — the
        Background analog: grid ground plane at world y=0 + SH sky + sun.
        Computed again only when the camera, the size, the scale or the sky
        changed; the caller gets copies."""
        s = self.settings
        cam = self.camera
        key = (tuple(cam.position), tuple(cam.target), tuple(cam.up), cam.fov_y_deg, s.width, s.height,
               s.grid_to_world_scale, id(environment._SKY_CUBEMAP))
        if key != self._bg_key:
            self._bg, self._bg_key = self._compute_background(), key
        return self._bg[0].copy(), self._bg[1].copy()

    def _compute_background(self) -> Tuple[np.ndarray, np.ndarray]:
        s = self.settings
        w, h = s.width, s.height
        right, up, fwd = self.camera.basis()
        f = self.camera.focal_px(h)
        xs = (np.arange(w) - w / 2.0 + 0.5) / f
        ys = -(np.arange(h) - h / 2.0 + 0.5) / f
        dirs = (
            fwd[None, None]
            + xs[None, :, None] * right[None, None]
            + ys[:, None, None] * up[None, None]
        )
        cosv = np.linalg.norm(dirs, axis=-1)  # |dir| = 1/cos(view angle)
        dirs = dirs / cosv[..., None]

        world_cam = self.camera.position * s.grid_to_world_scale
        rgb, t_world = sample_background(world_cam.astype(np.float32), dirs)
        # ray distance (world) -> view-space z (grid units)
        depth = np.where(
            np.isfinite(t_world), t_world / s.grid_to_world_scale / cosv, _FAR
        ).astype(np.float32)
        return rgb.astype(np.float32), depth

    # --------------------------------------------------------------- shading

    @staticmethod
    def _normals_from_depth(depth: np.ndarray) -> np.ndarray:
        gx = np.gradient(depth, axis=1)
        gy = np.gradient(depth, axis=0)
        n = np.stack([-gx, -gy, np.full_like(depth, 0.6)], axis=-1)
        return n / np.linalg.norm(n, axis=-1, keepdims=True)

    @staticmethod
    def _heatmap(t: np.ndarray) -> np.ndarray:
        """Cool-warm-ish velocity colormap (utilities.glsl heatmap)."""
        t = np.clip(t, 0.0, 1.0)[..., None]
        c0 = np.array([0.1, 0.25, 0.8])
        c1 = np.array([0.3, 0.85, 0.4])
        c2 = np.array([0.95, 0.15, 0.1])
        return np.where(t < 0.5, c0 + (c1 - c0) * (t * 2), c1 + (c2 - c1) * (t * 2 - 1))

    def _particle_colors(self, velocities, idx) -> np.ndarray:
        """The particle colormap of the fluid modes, of ``velocities`` [..., 3]
        or, without them or in index mode, of the indices ``idx``."""
        s = self.settings
        if s.fluid_mode == FluidRenderingMode.PARTICLES_VELOCITY and velocities is not None:
            return self._heatmap(np.linalg.norm(velocities, axis=-1) * s.velocity_viz_scale)
        return self._heatmap((idx % 4096) / 4096.0)

    def _screen_normals_to_grid(self, n_screen: np.ndarray) -> np.ndarray:
        right, up, fwd = self.camera.basis()
        return (
            n_screen[..., 0:1] * right[None, None]
            + n_screen[..., 1:2] * up[None, None]
            - n_screen[..., 2:3] * fwd[None, None]
        )

    def _draw_particles(self, positions, velocities):
        """(pdepth, winner, per-pixel colors) of the particle modes. On the
        card only the winners' velocities come back to the host; the
        colormap is elementwise, so coloring the winners gives numpy's
        colors of every particle indexed by the winners."""
        if self.device.type == "cuda":
            _check_key_room(len(positions))
            pdepth, winner = self._splat_device(positions, self.particle_radius, True)
            vel = None
            if velocities is not None:
                vel = torch.as_tensor(velocities, device=self.device)[winner.clamp_min(0)].cpu().numpy()
            winner = winner.cpu().numpy()
            return pdepth.cpu().numpy(), winner, self._particle_colors(vel, np.maximum(winner, 0))
        positions = _as_numpy(positions)
        velocities = _as_numpy(velocities) if velocities is not None else None
        colors = self._particle_colors(velocities, np.arange(len(positions)))
        pdepth, winner = self._splat(positions, self.particle_radius, values=colors)
        return pdepth, winner, colors[np.maximum(winner, 0)]

    # ------------------------------------------------------------------ draw

    def draw(
        self,
        positions,
        velocities=None,
        field: Optional[np.ndarray] = None,
        field_is_vector: bool = False,
        solid_meshes: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
        solid_occupancy: Optional[np.ndarray] = None,
        solid_velocity: Optional[np.ndarray] = None,
        velocity_grid: Optional[np.ndarray] = None,
        marker: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Render one frame. Returns uint8[H,W,3].

        positions / velocities: f32[N,3] numpy arrays or tensors (on the
        card: tensors on the device, which never come to the host).
        solid_meshes: [(verts grid-space f32[N,3], faces i32[M,3])] for the
        MeshRenderer pass; solid_occupancy/_velocity feed the voxel debug
        view; velocity_grid+marker feed VolumeVisualizationMode.VELOCITY;
        ``field`` feeds the billboard modes (SIGNED values).
        """
        s = self.settings
        rgb, depth = self._background()

        # --- solids (MeshRenderer / VoxelRenderer) ---------------------------
        if s.show_solid_meshes and solid_meshes:
            for entry in solid_meshes:
                verts, faces = entry[0], entry[1]
                albedo = entry[2] if len(entry) > 2 and entry[2] is not None else 1.0
                face_uv = entry[3] if len(entry) > 3 else None
                texture = entry[4] if len(entry) > 4 else None
                rasterize_mesh(
                    rgb, depth, self.camera, verts, faces, albedo=albedo,
                    face_uv=face_uv, texture=texture,
                )
        if s.show_voxel_debug and solid_occupancy is not None:
            verts, faces, cells = voxel_surface_mesh(_as_numpy(solid_occupancy))
            if len(faces):
                if solid_velocity is not None:
                    v = _as_numpy(solid_velocity)[cells[:, 0], cells[:, 1], cells[:, 2]]
                    albedo = np.abs(v) * s.velocity_viz_scale
                else:
                    albedo = np.zeros((len(faces), 3), np.float32)
                rasterize_mesh(
                    rgb, depth, self.camera, verts, faces, albedo=albedo,
                    cull_backfaces=False,
                )

        # --- fluid -----------------------------------------------------------
        mode = s.fluid_mode
        if positions is not None and len(positions) and mode != FluidRenderingMode.NONE:
            if mode == FluidRenderingMode.SCREEN_SPACE_FLUID:
                rgb, depth = self._ssf_pass(rgb, depth, positions)
            else:
                pdepth, winner, colors = self._draw_particles(positions, velocities)
                n = self._normals_from_depth(np.where(pdepth < _FAR, pdepth, 0.0))
                n_grid = self._screen_normals_to_grid(n)
                lit = shade_surface(n_grid, np.pi)  # albedo pi -> unit brdf
                pcol = np.where(
                    (winner >= 0)[..., None],
                    colors * np.clip(lit, 0.0, 2.0),
                    0.0,
                )
                m = (pdepth < depth) & (winner >= 0)
                rgb = np.where(m[..., None], pcol, rgb)
                depth = np.where(m, pdepth, depth)

        # --- volume visualization ---------------------------------------------
        if s.volume_mode == VolumeVisualizationMode.VELOCITY and velocity_grid is not None:
            if marker is None:
                from ..core.types import CELL_FLUID

                marker = np.full(velocity_grid.shape[:3], CELL_FLUID, np.int8)
            p0, p1, cols = velocity_lines(
                _as_numpy(velocity_grid), _as_numpy(marker), s.velocity_viz_scale
            )
            draw_lines(rgb, depth, self.camera, p0, p1, cols)
        elif field is not None and s.volume_mode not in (
            VolumeVisualizationMode.NONE,
            VolumeVisualizationMode.VELOCITY,
        ):
            rgb = self._draw_volume(rgb, depth, _as_numpy(field), field_is_vector)

        # --- domain bounds (StaticLineRenderer) --------------------------------
        if s.show_bounds_box:
            p0, p1, cols = domain_bounds_lines(self.grid_dim)
            draw_lines(rgb, depth, self.camera, p0, p1, cols)

        return (tonemap(rgb) * 255).astype(np.uint8)

    def _draw_volume(self, rgb, depth, field, is_vector) -> np.ndarray:
        """SIGNED value billboards at cell centers
        (volume_visualization_with_billboards.vert:39-99): radius = |scale|*0.5
        cells, color cool-to-warm of the signed value; NaN guard built in."""
        s = self.settings
        val = np.linalg.norm(field, axis=-1) if is_vector else np.asarray(field, np.float32)
        val = np.where(np.isfinite(val), val, 0.0)
        if s.volume_mode == VolumeVisualizationMode.MARKER:
            from ..core.types import CELL_AIR, CELL_FLUID

            scale = np.where(val == CELL_AIR, 0.0, 1.0)
            colors_full = np.zeros(val.shape + (3,), np.float32)
            colors_full[val == CELL_FLUID] = (0.0, 0.0, 1.0)
        else:
            top = np.percentile(np.abs(val)[val != 0], 99.0) if (val != 0).any() else 1.0
            signed = np.clip(val / max(top, 1e-12), -1.0, 1.0)
            scale = np.abs(signed)
            colors_full = colormap_cool_to_warm(signed)
        sel = scale > 0.02
        if not sel.any():
            return rgb
        cells = np.argwhere(sel).astype(np.float32) + 0.5
        colors = colors_full[sel]
        radii = (scale[sel] * 0.5).astype(np.float32)
        pdepth, winner = self._splat(cells, radii, values=colors)
        m = (pdepth < depth) & (winner >= 0)
        out = np.where(m[..., None], colors[np.maximum(winner, 0)], rgb)
        return out
