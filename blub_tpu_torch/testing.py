"""Seeded inputs for checking the kernels against their plain versions (used
by ``tests/test_torch_kernels.py`` and ``chip_smoke.py``)."""

from __future__ import annotations

import numpy as np
import torch

from .core.models import box_sdf
from .core.seeding import add_fluid_cube
from .core.types import SolidState
from .sim.slot_major import SlotMajorTable, pack_dyn, pack_posq, valid_mask
from .sim.table import from_positions
from .sim.voxelize import voxelize_step


def random_table(grid, k: int, seed: int, hi=None, device="cpu") -> SlotMajorTable:
    """A fluid cube from (1,1,1) to ``hi`` (default: half the grid in x, two
    cells short of the far walls in y and z), jiggled off its seeding lattice
    by up to 0.45 cells, with random velocity (x5) and affine bf16 pairs on
    the valid slots. The same ``seed`` gives the same table."""
    rng = np.random.default_rng(seed)
    x, y, z = grid
    hi = (x // 2, y - 2, z - 2) if hi is None else hi
    pos = add_fluid_cube(grid, (1, 1, 1), hi, 10**9)
    pos = np.clip(pos + rng.uniform(-0.45, 0.45, pos.shape).astype(np.float32), 1.001, np.array(grid) - 1.001)
    t = from_positions(pos, grid, k, device=device)
    v = valid_mask(t.posq)
    vals = [torch.from_numpy(rng.standard_normal((k,) + tuple(grid)).astype(np.float32)).to(t.posq.device)
            for _ in range(12)]
    vals = [torch.where(v, a * (5.0 if i < 3 else 1.0), 0.0) for i, a in enumerate(vals)]
    t.dyn = torch.stack(pack_dyn(vals[:3], vals[3:]), dim=1).contiguous()
    return t


def crowded_table(grid, k: int, seed: int, fill: float = 0.85, reach: float = 0.5, device="cpu") -> SlotMajorTable:
    """A table whose every slot is valid with probability ``fill`` (holes
    anywhere, so the upper slots of a cell are used too), with rel16 offsets
    uniform within +-``reach`` cells of the bin (0.5: on its bin; 2.4: off
    it, within a +-2 rebin window) and random velocity and affine pairs."""
    rng = np.random.default_rng(seed)
    shape = (k,) + tuple(grid)
    lim = int(reach * 8192)
    valid = torch.from_numpy(rng.random(shape) < fill)
    rel = [torch.from_numpy(rng.integers(-lim, lim, shape, dtype=np.int32)) for _ in range(3)]
    rel = [torch.where(valid, r, 0) for r in rel]
    ch0, ch1 = pack_posq(rel[0], rel[1], rel[2], valid.to(torch.int32))
    vals = [torch.where(valid, torch.from_numpy(rng.standard_normal(shape).astype(np.float32)), 0.0) for _ in range(12)]
    dyn = torch.stack(pack_dyn(vals[:3], vals[3:]), dim=1)
    return SlotMajorTable(posq=torch.stack([ch0, ch1], dim=1).contiguous().to(device), dyn=dyn.contiguous().to(device),
                          lost=torch.zeros((), dtype=torch.int32, device=device), grid_dim=tuple(grid))


def moving_box(grid, lo, hi, velocity, device="cpu") -> SolidState:
    """A box of cells [lo, hi) moving at ``velocity`` (grid units per
    second), voxelized as a scene object is: its SDF baked on the grid padded
    by one cell (two above), resampled a quarter cell off the lattice."""
    pad_lo = np.ones(3, np.int64)
    shape = np.asarray(grid) + 3
    centers = np.indices(shape).reshape(3, -1).T.astype(np.float32) - pad_lo + 0.5
    baked = box_sdf(centers, lo, hi).reshape(shape)
    center = (np.asarray(lo, np.float32) + np.asarray(hi, np.float32)) / 2
    return voxelize_step(
        [torch.from_numpy(baked).to(device)], [tuple(pad_lo)], np.float32([[0.25, 0.0, 0.0]]),
        np.float32([velocity]), np.zeros((1, 3), np.float32), np.float32([center]), tuple(grid),
    )


def z_wall_inputs(grid, k: int, seed: int, device="cpu") -> dict:
    """Inputs whose every kind of G2P read meets the z walls: a jiggled pool
    over the whole grid whose positions span every z bin (0.5 to Z + 0.5,
    beyond the wall clamps), with random velocity and affine pairs; two
    moving boxes spanning z, one pushed along -z and one along +z (so
    escapes and pushes reach both walls); random face and change grids up
    to their borders; a random marker, SOLID in the boxes only. -> dict of
    table, occupancy, solid_velocity, faces, change, marker."""
    rng = np.random.default_rng(seed)
    x, y, z = grid
    pos = add_fluid_cube(grid, (1, 1, 0), (x - 1, y - 1, z), 10**9)
    pos = pos + rng.uniform(-0.45, 0.45, pos.shape).astype(np.float32)
    pos = np.clip(pos, np.float32([1.001, 1.001, 0.5005]), np.float32([x - 1.001, y - 1.001, z + 0.4995]))
    t = from_positions(pos.astype(np.float32), grid, k, device="cpu")
    v = valid_mask(t.posq)
    vals = [torch.where(v, torch.from_numpy(rng.standard_normal((k,) + tuple(grid)).astype(np.float32)) * sc, 0.0)
            for sc in [5.0] * 3 + [1.0] * 9]
    t.dyn = torch.stack(pack_dyn(vals[:3], vals[3:]), dim=1).contiguous()
    a = moving_box(grid, (1, 1, 0), (x // 2, y // 2, z), (3.0, -2.0, -41.0))
    b = moving_box(grid, (x // 2, y // 2, 0), (x - 1, y - 1, z), (-4.0, 1.0, 37.0))
    occ = torch.maximum(a.occupancy, b.occupancy)
    vel = torch.where(b.occupancy > 0, b.velocity, a.velocity)
    faces = [torch.from_numpy((rng.standard_normal(grid) * 60.0).astype(np.float32)) for _ in range(3)]
    change = [torch.from_numpy((rng.standard_normal(grid) * 0.3).astype(np.float32)) for _ in range(3)]
    marker = torch.from_numpy(np.where(rng.random(grid) < 0.7, 1, -1).astype(np.int8))
    marker = torch.where(occ > 0, torch.zeros((), dtype=torch.int8), marker)
    table = SlotMajorTable(posq=t.posq.to(device), dyn=t.dyn.to(device), lost=t.lost.to(device), grid_dim=t.grid_dim)
    return {"table": table, "occupancy": occ.to(device), "solid_velocity": vel.to(device),
            "faces": [f.to(device) for f in faces], "change": [c.to(device) for c in change],
            "marker": marker.to(device)}


def x_window(a: torch.Tensor, dim: int, x0: int, xl: int, h: int, wrap: bool) -> torch.Tensor:
    """Planes x0 - h .. x0 + xl + h of ``a`` along ``dim`` (a mesh rank's
    slab with its halo, cut in one process): cyclic over the domain
    (``wrap``: G2P's grids) or zeros beyond it (tables, gridfix's and the
    glue's grids)."""
    x = a.shape[dim]
    idx = torch.arange(x0 - h, x0 + xl + h, device=a.device)
    got = a.index_select(dim, torch.remainder(idx, x))
    if not wrap:
        keep = ((idx >= 0) & (idx < x)).reshape([-1 if d == dim else 1 for d in range(a.dim())])
        got = torch.where(keep, got, torch.zeros((), dtype=a.dtype, device=a.device))
    return got.contiguous()
