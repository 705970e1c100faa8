"""Per-substep solid voxelization: SDF resampling and the rigid velocity
field (port of ``blub_tpu/sim/voxelize.py``, plain PyTorch on the device:
the JAX package leaves this to XLA, with no Pallas kernel).

Each object's SDF is baked once over the fluid domain extended by its
translation range (``core/models.py``) and moved to the device once. Per
substep it is resampled at the animated translation, one window slice plus
an 8-corner trilinear blend with constant weights, or, for an object with a
runtime rotation, at rotated coordinates (8-corner gather, far outside
filled with 1e6). Occupancy is ``field <= 0.5`` voxel; the solid velocity is
v_trans + omega x r at cell centers. Later objects overwrite earlier ones.
"""

from __future__ import annotations

from itertools import product
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.models import SolidObject
from ..core.types import SolidState

OCC_ISO = 0.5  # voxels
OUTSIDE = 1e6  # field value beyond the bake (map_coordinates cval)


def _centers(grid_dim, axis: int, device) -> torch.Tensor:
    """Cell-center coordinate along ``axis``, broadcastable to [X,Y,Z]."""
    view = [1, 1, 1]
    view[axis] = grid_dim[axis]
    return (torch.arange(grid_dim[axis], dtype=torch.float32, device=device) + 0.5).reshape(view)


def _f32(a, device) -> torch.Tensor:
    """An animation parameter as an f32 tensor on ``device``: a device
    tensor passes through unchanged (no copy, so a CUDA graph reads it at
    replay); host arrays are copied once."""
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def resample_sdf(baked: torch.Tensor, pad_lo, shift, grid_dim) -> torch.Tensor:
    """out[i] = trilerp(baked[i + pad_lo - shift]) over the [X,Y,Z] grid.
    ``shift`` is an f32[3] tensor on the bake's device (host arrays are
    copied there). The window start is clamped into the bake on the device,
    as ``jax.lax.dynamic_slice`` clamps it, and the window is one gather; the
    corner weights are the f32 products of JAX, in its order."""
    dev = baked.device
    shift = _f32(shift, dev)
    sizes = [d + 1 for d in grid_dim]
    lo, hi, idx = [], [], []
    for a in range(3):
        o = float(pad_lo[a]) - shift[a]
        base = torch.floor(o)
        frac = o - base
        lo.append(1.0 - frac)
        hi.append(frac)
        start = base.to(torch.int64).clamp(0, baked.shape[a] - sizes[a])
        idx.append(start + torch.arange(sizes[a], device=dev))
    sy, sz = baked.shape[1], baked.shape[2]
    lin = (idx[0].view(-1, 1, 1) * sy + idx[1].view(1, -1, 1)) * sz + idx[2].view(1, 1, -1)
    window = baked.reshape(-1)[lin]
    x, y, z = grid_dim
    out = torch.zeros(tuple(grid_dim), dtype=torch.float32, device=dev)
    for cx, cy, cz in product((0, 1), (0, 1), (0, 1)):
        w = ((hi if cx else lo)[0] * (hi if cy else lo)[1]) * (hi if cz else lo)[2]
        out = out + w * window[cx:cx + x, cy:cy + y, cz:cz + z]
    return out


def resample_sdf_rotated(baked: torch.Tensor, pad_lo, q_mat, origin_v, origin0_v, grid_dim) -> torch.Tensor:
    """field[v] = the bake at the reference-pose coordinate of voxel center v
    under the animated rotation: u = origin0 + Q (v - origin(t)), read at
    baked index u + pad_lo - 0.5, trilinear; a corner outside the bake reads
    1e6 (``map_coordinates(order=1, mode="constant", cval=1e6)``, corners
    summed in its order). ``q_mat`` f32[3,3], ``origin_v`` and
    ``origin0_v`` f32[3] are tensors on the bake's device."""
    dev = baked.device
    q, origin_v, origin0_v = (_f32(a, dev) for a in (q_mat, origin_v, origin0_v))
    rel = [_centers(grid_dim, a, dev) - origin_v[a] for a in range(3)]
    idx = []
    for a in range(3):
        u = origin0_v[a] + (q[a, 0] * rel[0] + q[a, 1] * rel[1] + q[a, 2] * rel[2])
        idx.append((u + float(np.float32(pad_lo[a]))) - 0.5)
    nodes = []
    for a in range(3):
        lower = torch.floor(idx[a])
        upper_w = idx[a] - lower
        i0 = lower.to(torch.int64)
        nodes.append(((i0, 1.0 - upper_w), (i0 + 1, upper_w)))
    flat = baked.reshape(-1)
    sx, sy, sz = baked.shape
    out = None
    for (ix, wx), (iy, wy), (iz, wz) in product(*nodes):
        valid = (ix >= 0) & (ix < sx) & (iy >= 0) & (iy < sy) & (iz >= 0) & (iz < sz)
        lin = (ix.clamp(0, sx - 1) * sy + iy.clamp(0, sy - 1)) * sz + iz.clamp(0, sz - 1)
        term = (wx * wy) * wz * torch.where(valid, flat[lin], OUTSIDE)
        out = term if out is None else out + term
    return out


def rigid_velocity_field(grid_dim, v_trans, omega, center, device) -> torch.Tensor:
    """f32[3,X,Y,Z]: v_trans + omega x (x - center) at cell centers (voxel
    space, grid units per second); the parameters are f32[3] tensors on
    ``device``."""
    v, w, c = (_f32(a, device) for a in (v_trans, omega, center))
    r = [_centers(grid_dim, a, device) - c[a] for a in range(3)]
    tangential = (
        w[1] * r[2] - w[2] * r[1],
        w[2] * r[0] - w[0] * r[2],
        w[0] * r[1] - w[1] * r[0],
    )
    shape = tuple(grid_dim)
    return torch.stack([(tangential[a] + v[a]).expand(shape) for a in range(3)])


def voxelize_step(
    sdfs: Sequence[torch.Tensor],
    pad_los: Sequence[Tuple[int, int, int]],
    shifts,
    v_trans,
    omegas,
    centers,
    grid_dim,
    rot_q=None,
    origins0=None,
    rotating: Tuple[bool, ...] = (),
) -> SolidState:
    """All objects combined into one SolidState on the SDFs' device. The
    parameters are ``solid_params_at``'s arrays as f32 tensors on that
    device (host arrays are copied there first): nothing reaches the host,
    so the voxelization can be captured in a CUDA graph that reads new
    parameters at every replay. Objects flagged in ``rotating`` use the
    rotated resample."""
    dev = sdfs[0].device
    shifts, v_trans, omegas, centers = (_f32(a, dev) for a in (shifts, v_trans, omegas, centers))
    if any(rotating):
        rot_q, origins0 = _f32(rot_q, dev), _f32(origins0, dev)
    solids = SolidState.empty(grid_dim, dev)
    occupancy, velocity = solids.occupancy, solids.velocity
    for i, (baked, pad_lo) in enumerate(zip(sdfs, pad_los)):
        if i < len(rotating) and rotating[i]:
            field = resample_sdf_rotated(baked, pad_lo, rot_q[i], centers[i], origins0[i], grid_dim)
        else:
            field = resample_sdf(baked, pad_lo, shifts[i], grid_dim)
        occ_i = field <= OCC_ISO
        vel_i = rigid_velocity_field(grid_dim, v_trans[i], omegas[i], centers[i], dev)
        occupancy = torch.where(occ_i, 1.0, occupancy)
        velocity = torch.where(occ_i, vel_i, velocity)
    return SolidState(occupancy=occupancy, velocity=velocity)


def solid_params_at(objects: List[SolidObject], t: float, dt: float):
    """Host-side per-substep parameters for ``voxelize_step``: (shifts,
    v_trans, omegas, centers, rot_q, origins0), f32[n,3] each except rot_q
    f32[n,3,3]."""
    shifts, vts, oms, cts, qs, o0s = [], [], [], [], [], []
    for obj in objects:
        shifts.append(obj.voxel_shift_at(t))
        vt, om, ct = obj.velocity_params_at(t, dt)
        vts.append(vt)
        oms.append(om)
        cts.append(ct)
        qs.append(obj.resample_rotation_at(t))
        o0s.append(obj.origin_voxel_at(0.0))
    return (
        np.asarray(shifts, np.float32),
        np.asarray(vts, np.float32),
        np.asarray(oms, np.float32),
        np.asarray(cts, np.float32),
        np.asarray(qs, np.float32),
        np.asarray(o0s, np.float32),
    )


def rotating_flags(objects: List[SolidObject]) -> Tuple[bool, ...]:
    return tuple(o.has_runtime_rotation for o in objects)
