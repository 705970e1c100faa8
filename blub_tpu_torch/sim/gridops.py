"""Dense grid helpers (port of ``blub_tpu/sim/gridops.py``).

``shift`` reproduces the reference's out-of-bounds texel fetches returning 0
(which decodes as CELL_SOLID): out-of-domain reads take ``fill``. It acts on
the LAST three dims, so it serves grids ``[X,Y,Z]`` and tables
``[K,C,X,Y,Z]`` alike.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

Offset = Tuple[int, int, int]

AXES: Tuple[Offset, ...] = ((1, 0, 0), (0, 1, 0), (0, 0, 1))


def neg(off: Sequence[int]) -> Offset:
    return tuple(-o for o in off)


def shift(a: torch.Tensor, offset: Sequence[int], fill=0) -> torch.Tensor:
    """out[i] = a[i + offset] where in bounds, else ``fill``."""
    out = a
    for i, off in enumerate(offset):
        if off == 0:
            continue
        dim = a.dim() - 3 + i
        n = out.shape[dim]
        pad = torch.full_like(out.narrow(dim, 0, abs(off)), fill)
        if off > 0:
            out = torch.cat([out.narrow(dim, off, n - off), pad], dim=dim)
        else:
            out = torch.cat([pad, out.narrow(dim, 0, n + off)], dim=dim)
    return out


def roll(a: torch.Tensor, offset: Sequence[int]) -> torch.Tensor:
    """Cyclic read on the last three dims: out[i] = a[(i + offset) mod dim]."""
    return torch.roll(a, shifts=tuple(-o for o in offset), dims=(-3, -2, -1))


def border_mask(grid_dim, device, x_start: int = 0, x_len=None) -> torch.Tensor:
    """bool[X,Y,Z]: True on the outermost cell ring (marked SOLID every step,
    transfer_set_boundary_marker.comp:13-15). ``x_start``/``x_len``: the
    mask of the x-slab [x_start, x_start + x_len) of the ``grid_dim`` domain
    (a mesh shard), which holds the domain's border only where the slab
    does."""
    x, y, z = grid_dim
    xl = x if x_len is None else x_len
    ix = torch.arange(x_start, x_start + xl, device=device).reshape(xl, 1, 1)
    iy = torch.arange(y, device=device).reshape(1, y, 1)
    iz = torch.arange(z, device=device).reshape(1, 1, z)
    return (
        (ix == 0) | (ix == x - 1) | (iy == 0) | (iy == y - 1) | (iz == 0) | (iz == z - 1)
    )
