"""Particle seeding: fluid cubes with stratified 2x2x2 jitter (copy of
``blub_tpu/core/seeding.py::add_fluid_cube`` and ``seed_scene``, bit for
bit, numpy only).

Each cell of the clamped cube receives 8 particles at stratified positions
``(s%2, s/2%2, s/4%2) * 0.5 + U[0,0.5)^3`` (reference
hybrid_fluid.rs:609-678), snapped to the rel16 position grid.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .config import SceneConfig

PARTICLES_PER_GRID_CELL = 8  # reference hybrid_fluid.rs:90


def clamp_to_grid(p, grid_dim) -> np.ndarray:
    """Clamp to [1, dim-1] integer cells (hybrid_fluid.rs:609-617)."""
    p = np.asarray(p, np.float64)
    lo = np.ones(3)
    hi = np.asarray(grid_dim, np.float64) - 1.0
    return np.clip(p.astype(np.uint32), lo, hi).astype(np.int64)


def add_fluid_cube(
    grid_dim: Tuple[int, int, int],
    min_grid,
    max_grid,
    max_num_particles: int,
    existing: int = 0,
    seed: int | None = None,
) -> np.ndarray:
    """Particle positions f32[n, 3] for one fluid cube."""
    mn = clamp_to_grid(min_grid, grid_dim)
    mx = clamp_to_grid(max_grid, grid_dim)
    extent = np.maximum(mx - mn, 0)
    n = int(extent.prod()) * PARTICLES_PER_GRID_CELL
    n = min(n, max(max_num_particles - existing, 0))
    if n == 0:
        return np.zeros((0, 3), np.float32)

    i = np.arange(n, dtype=np.int64)
    cell_linear = i // PARTICLES_PER_GRID_CELL
    # reference cell ordering: x fastest, then y, then z (hybrid_fluid.rs:648-652)
    cx = mn[0] + cell_linear % extent[0]
    cy = mn[1] + (cell_linear // extent[0]) % extent[1]
    cz = mn[2] + (cell_linear // (extent[0] * extent[1]))
    cell = np.stack([cx, cy, cz], axis=-1).astype(np.float32)

    s = (i % PARTICLES_PER_GRID_CELL).astype(np.float32)
    strat = np.stack([s % 2, (s // 2) % 2, (s // 4) % 2], axis=-1) * 0.5

    # seed keyed on the running particle count like the reference (rs:639)
    rng = np.random.default_rng(existing + n if seed is None else seed)
    jitter = rng.random((n, 3), np.float32) * 0.5
    pos = (cell + strat + jitter).astype(np.float32)
    return (np.round(pos * np.float32(8192.0)) * np.float32(2.0 ** -13)).astype(np.float32)


def seed_scene(scene: SceneConfig, seed: int | None = None) -> np.ndarray:
    """Seed all fluid cubes of a scene, f32[num_particles, 3]; each cube's
    default seed is keyed on the particles seeded before it."""
    dim = scene.fluid.grid_dimension
    parts = []
    count = 0
    for mn, mx in scene.fluid_cubes_grid():
        p = add_fluid_cube(dim, mn, mx, scene.fluid.max_num_particles, existing=count, seed=seed)
        count += p.shape[0]
        parts.append(p)
    if not parts:
        return np.zeros((0, 3), np.float32)
    return np.concatenate(parts, axis=0)
