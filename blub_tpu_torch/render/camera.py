"""Perspective camera — the analog of src/camera.rs (view-projection build,
grid-space framing). The renderer is decoupled behind the state-readback
boundary (SURVEY.md §7.1), so the camera is plain numpy host code."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class Camera:
    position: np.ndarray  # world/grid space
    target: np.ndarray
    up: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    fov_y_deg: float = 45.0
    near: float = 0.1

    @staticmethod
    def framing(grid_dim: Tuple[int, int, int], azimuth_deg: float = 35.0, elevation_deg: float = 22.0) -> "Camera":
        """Default camera framing the whole fluid box (grid space)."""
        dim = np.asarray(grid_dim, np.float64)
        center = dim / 2.0
        radius = float(np.linalg.norm(dim)) * 0.9
        az = math.radians(azimuth_deg)
        el = math.radians(elevation_deg)
        offset = radius * np.array(
            [math.cos(el) * math.sin(az), math.sin(el), math.cos(el) * math.cos(az)]
        )
        return Camera(position=center + offset, target=center)

    @staticmethod
    def parse(spec: str, grid_dim: Tuple[int, int, int]) -> "Camera":
        """Parse a `--camera` CLI spec: ``px,py,pz[:tx,ty,tz[:fov_deg]]`` in
        grid units. Target defaults to the domain center. The headless analog
        of placing the reference's fly camera (src/camera.rs:104-165)."""
        parts = spec.split(":")
        pos = np.array([float(v) for v in parts[0].split(",")], np.float64)
        if len(pos) != 3:
            raise ValueError(f"--camera position needs 3 comma-separated values, got {parts[0]!r}")
        if len(parts) > 1 and parts[1]:
            target = np.array([float(v) for v in parts[1].split(",")], np.float64)
        else:
            target = np.asarray(grid_dim, np.float64) / 2.0
        fov = float(parts[2]) if len(parts) > 2 else 45.0
        return Camera(position=pos, target=target, fov_y_deg=fov)

    def orbit(self, d_azimuth_deg: float, d_elevation_deg: float) -> None:
        """Rotate the position around the target (terminal-friendly analog of
        the reference's mouse-drag rotation, src/camera.rs:120-141)."""
        rel = self.position - self.target
        r = float(np.linalg.norm(rel))
        az = math.atan2(rel[0], rel[2])
        el = math.asin(float(np.clip(rel[1] / max(r, 1e-9), -1.0, 1.0)))
        az += math.radians(d_azimuth_deg)
        el = float(np.clip(el + math.radians(d_elevation_deg), -1.55, 1.55))
        self.position = self.target + r * np.array(
            [math.cos(el) * math.sin(az), math.sin(el), math.cos(el) * math.cos(az)]
        )

    def dolly(self, factor: float) -> None:
        """Move toward (<1) / away from (>1) the target."""
        self.position = self.target + (self.position - self.target) * factor

    def fly(self, forward: float = 0.0, right: float = 0.0, up: float = 0.0) -> None:
        """Translate position AND target along the view basis (the WASD part
        of src/camera.rs:104-118)."""
        rb, ub, fb = self.basis()
        d = forward * fb + right * rb + up * ub
        self.position = self.position + d
        self.target = self.target + d

    def basis(self):
        fwd = self.target - self.position
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, self.up)
        right = right / np.linalg.norm(right)
        up = np.cross(right, fwd)
        return right, up, fwd

    def project(self, points: np.ndarray, width: int, height: int):
        """Project grid-space points f32[N,3] to (px f32[N], py f32[N],
        depth f32[N], valid bool[N])."""
        right, up, fwd = self.basis()
        rel = points - self.position
        x = rel @ right
        y = rel @ up
        z = rel @ fwd
        valid = z > self.near
        zs = np.where(valid, z, 1.0)
        f = (height / 2.0) / math.tan(math.radians(self.fov_y_deg) / 2.0)
        px = width / 2.0 + f * x / zs
        py = height / 2.0 - f * y / zs
        return px, py, z, valid

    def focal_px(self, height: int) -> float:
        return (height / 2.0) / math.tan(math.radians(self.fov_y_deg) / 2.0)
