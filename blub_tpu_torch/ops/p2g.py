"""P2G: particle-to-grid gather over the dual-bin window (port of
``blub_tpu/ops/pallas_p2g.py::_kernel``).

For every cell g the kernel visits the slots of the dual bins g + o over the
20-offset union window (8 offsets, {-1,0}^3, in density mode) and sums

  velocity mode, 7 channels: Shepard weight sums per face component (0..2),
      weighted APIC velocity sums (3..5), primal-cell fluid count (6);
  density mode, 2 channels: particle density at the cell centre (0),
      primal-cell fluid count (1).

A neighbour outside [0, dim) contributes nothing. Sums run in a fixed order
(offsets, then slots ascending) with no atomics, so they are repeatable;
the plain version below sums in the same order with the same expressions,
and the kernel (built with -fmad=false) matches it bit for bit.

``p2g`` takes the plain version for CPU tensors and launches ``csrc/p2g.cu``
for CUDA tensors, which keeps each cell's valid slots as a mask word: 32-bit
up to 32 slots, 64-bit up to ``MAX_SLOTS`` = 64, and it raises beyond (the
JAX package takes any capacity).
"""

from __future__ import annotations

import torch

from ..core.types import CELL_FLUID, CELL_SOLID
from ..sim.gridops import shift
from ..sim.slot_major import CH_XY, CH_ZV, NUM_DYN, NUM_POSQ, POS_INV, sext16, unpack_dyn
from . import cuda

OFFSETS = tuple(
    (ox, oy, oz)
    for ox in (-1, 0, 1)
    for oy in (-1, 0, 1)
    for oz in (-1, 0, 1)
    if (ox, oy, oz).count(1) <= 1
)
DENSITY_OFFSETS = tuple(o for o in OFFSETS if all(v <= 0 for v in o))

_SIG = {
    "p2g_launch": [cuda.P, cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I, cuda.P],
    "p2g_smem_bytes": [cuda.I, cuda.I, cuda.I],
}
MAX_SLOTS = 64  # the widest slot-mask word


def _tent(d):
    return torch.clamp(1.0 - torch.abs(d), 0.0, 1.0)


def p2g_plain(posq: torch.Tensor, dyn: torch.Tensor | None, density: bool) -> torch.Tensor:
    """Plain PyTorch version: f32[7, X, Y, Z] (velocity) or f32[2, X, Y, Z]
    (density, ``dyn`` unused)."""
    k = posq.shape[0]
    grid = posq.shape[2:]
    acc = [torch.zeros(grid, dtype=torch.float32, device=posq.device) for _ in range(2 if density else 7)]
    for off in DENSITY_OFFSETS if density else OFFSETS:
        ox, oy, oz = off
        pq = shift(posq, off)  # zero fill: out-of-domain slots are invalid
        b0, b1 = pq[:, CH_XY], pq[:, CH_ZV]
        rx, ry, rz = b0 >> 16, sext16(b0), b1 >> 16
        valid = (b1 & 1) == 1
        validf = valid.to(torch.float32)
        dx5 = (-0.5 - ox) - rx.to(torch.float32) * POS_INV
        dy5 = (-0.5 - oy) - ry.to(torch.float32) * POS_INV
        dz5 = (-0.5 - oz) - rz.to(torch.float32) * POS_INV
        fx5, fy5, fz5 = _tent(dx5), _tent(dy5), _tent(dz5)
        terms = []
        if density:
            terms.append((0, fx5 * fy5 * fz5 * validf))
        else:
            dx1, dy1, dz1 = dx5 + 0.5, dy5 + 0.5, dz5 + 0.5
            fx1, fy1, fz1 = _tent(dx1), _tent(dy1), _tent(dz1)
            ds = ((dx1, dy5, dz5), (dx5, dy1, dz5), (dx5, dy5, dz1))
            ws = (fx1 * (fy5 * fz5) * validf, fx5 * (fy1 * fz5) * validf, (fx5 * fy5) * fz1 * validf)
            vel, aff = unpack_dyn([shift(dyn[:, c], off) for c in range(NUM_DYN)])
            for c in range(3):
                dx, dy, dz = ds[c]
                val = ws[c] * (vel[c] + aff[3 * c] * dx + aff[3 * c + 1] * dy + aff[3 * c + 2] * dz)
                terms += [(c, ws[c]), (3 + c, val)]
        if all(v <= 0 for v in off):
            prim = (
                valid
                & ((rx >= 0) if ox else (rx < 0))
                & ((ry >= 0) if oy else (ry < 0))
                & ((rz >= 0) if oz else (rz < 0))
            )
            terms.append((len(acc) - 1, prim.to(torch.float32)))
        # slot by slot, in the kernel's summation order
        for q in range(k):
            for ch, t in terms:
                acc[ch] = acc[ch] + t[q]
    return torch.stack(acc)


def p2g(posq: torch.Tensor, dyn: torch.Tensor | None, density: bool = False) -> torch.Tensor:
    """Raw P2G accumulators, f32[7|2, X, Y, Z]."""
    if not posq.is_cuda:
        return p2g_plain(posq, dyn, density)
    k, _, x, y, z = posq.shape
    if not 0 < k <= MAX_SLOTS:
        raise ValueError(f"p2g on the card takes up to {MAX_SLOTS} slots (64-bit slot masks), got {k}")
    cuda.require(posq, torch.int32, (k, NUM_POSQ, x, y, z), "p2g posq")
    if not density:
        cuda.require(dyn, torch.int32, (k, NUM_DYN, x, y, z), "p2g dyn")
    out = torch.empty((2 if density else 7, x, y, z), dtype=torch.float32, device=posq.device)
    lib = cuda.library("p2g", _SIG)
    err = lib.p2g_launch(
        cuda.ptr(posq), cuda.ptr(posq if density else dyn), cuda.ptr(out),
        k, x, y, z, int(density), cuda.stream(),
    )
    cuda.count_launch("p2g")
    cuda.check(lib, err, "p2g")
    return out


def smem_bytes(k: int, grid) -> int:
    """Dynamic shared memory per block of the kernel at ``k`` slots and
    ``grid``: the valid masks of its tile and halo in three x planes."""
    return cuda.library("p2g", _SIG).p2g_smem_bytes(k, grid[1], grid[2])


def normalize_velocity(acc, marker, gravity_grid, dt):
    """Marker-gated Shepard normalization + gravity (the dense tail of P2G,
    ``pallas_p2g.py:471``)."""
    markerf = marker.to(torch.float32)
    dt = float(dt)
    vel_out = []
    for c in range(3):
        e = [0, 0, 0]
        e[c] = 1
        b = shift(markerf, tuple(e))
        writes = (markerf == CELL_FLUID) | (b == CELL_FLUID)
        computes = (markerf != CELL_SOLID) & (b != CELL_SOLID)
        wsum = acc[c]
        vnorm = torch.where(wsum > 0.0, acc[3 + c] / torch.where(wsum > 0.0, wsum, 1.0), 0.0)
        vel_out.append(torch.where(writes & computes, vnorm + float(gravity_grid[c]) * dt, 0.0))
    return tuple(vel_out)
