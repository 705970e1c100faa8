"""Slot-major particle table: the resident layout (port of
``blub_tpu/sim/slot_major.py``, bit-exact).

The table is two int32 arrays, 32 bytes per slot:

  posq int32[K, 2, X, Y, Z]   cell-relative 16-bit fixed-point positions +
                              the valid flag:
                                ch 0: rx << 16 | (ry & 0xFFFF)
                                ch 1: rz << 16 | valid   (valid = bit 0)
  dyn  int32[K, 6, X, Y, Z]   velocity + APIC affine rows as twelve bf16
                              values, two per channel (hi | lo):
                                0: vx|vy   1: vz|c00  2: c01|c02
                                3: c10|c11 4: c12|c20 5: c21|c22

A slot at cell b stores r_a = round((pos_a - (b_a + 1)) * 8192); decoding
``b_a + 1 + r_a * 2^-13`` is exact f32 for |r| < 4 cells and positions below
1024 cells, so every position store quantizes to the 2^-13 grid.

Unlike the JAX package the arrays are stored as int32 (they hold bit
patterns and never pass through float add or multiply), carry no z lane
padding, and keep the scene's axis order.

Invariants: a valid slot at cell (x, y, z) holds a particle with
floor(pos - 0.5) == (x, y, z), i.e. r in [-4096, 4096) per axis; invalid
slots are all-zero in both arrays.

Signed 16-bit fields decode as ``((b & 0xFFFF) ^ 0x8000) - 0x8000`` and encode
by multiplying by 65536: no left shift of a negative int32 anywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

CH_XY = 0  # rx << 16 | ry
CH_ZV = 1  # rz << 16 | valid
NUM_POSQ = 2
NUM_DYN = 6
BYTES_PER_SLOT = (NUM_POSQ + NUM_DYN) * 4

POS_SCALE = 8192.0  # 2^13: rel16 resolution 2^-13 cells, signed range +-4
POS_INV = 2.0 ** -13

HI_MASK = -65536  # 0xFFFF0000 as int32
LO_MASK = 0xFFFF


def sext16(b: torch.Tensor) -> torch.Tensor:
    """Low 16 bits of an int32 tensor, sign-extended."""
    return ((b & LO_MASK) ^ 0x8000) - 0x8000


def quantize_pos(pos: torch.Tensor) -> torch.Tensor:
    """Snap positions to the rel16 grid (round half to even, exact f32)."""
    return torch.round(pos * POS_SCALE) * POS_INV


def pos_to_rel(pos_a: torch.Tensor, cell_a: torch.Tensor) -> torch.Tensor:
    """f32 position + f32 integer cell coordinate -> int32 rel16 field."""
    return torch.round((pos_a - cell_a - 1.0) * POS_SCALE).to(torch.int32)


def rel_to_pos(r_a: torch.Tensor, cell_a: torch.Tensor) -> torch.Tensor:
    """int32 rel16 field + f32 integer cell coordinate -> f32 position."""
    return cell_a + 1.0 + r_a.to(torch.float32) * POS_INV


def pack_posq(rx, ry, rz, vbit) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 rels + int32 0/1 valid -> the two posq channels (int32)."""
    ch0 = (rx * 65536) | (ry & LO_MASK)
    ch1 = (rz * 65536) | vbit
    return ch0, ch1


def unpack_posq(ch0: torch.Tensor, ch1: torch.Tensor):
    """posq channels -> (rx, ry, rz, vbit), int32."""
    return ch0 >> 16, sext16(ch0), ch1 >> 16, ch1 & 1


def valid_mask(posq: torch.Tensor) -> torch.Tensor:
    """bool[K, X, Y, Z] valid mask of a posq array."""
    return (posq[:, CH_ZV] & 1) == 1


def pack_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two f32 tensors -> one int32 holding round-to-nearest-even bf16(hi) in
    the high half and bf16(lo) in the low half. ``+ 0.0`` turns -0.0 into
    +0.0 so that a masked slot packs to exact zero bits."""
    hb = (hi.to(torch.bfloat16).to(torch.float32) + 0.0).view(torch.int32)
    lb = (lo.to(torch.bfloat16).to(torch.float32) + 0.0).view(torch.int32)
    return (hb & HI_MASK) | ((lb >> 16) & LO_MASK)


def unpack_hi(p: torch.Tensor) -> torch.Tensor:
    return (p & HI_MASK).view(torch.float32)


def unpack_lo(p: torch.Tensor) -> torch.Tensor:
    return (sext16(p) * 65536).view(torch.float32)


def pack_dyn(vel, aff):
    """vel: 3 tensors, aff: 9 tensors (row-major c[i][j]) -> 6 packed."""
    v0, v1, v2 = vel
    return [
        pack_pair(v0, v1),
        pack_pair(v2, aff[0]),
        pack_pair(aff[1], aff[2]),
        pack_pair(aff[3], aff[4]),
        pack_pair(aff[5], aff[6]),
        pack_pair(aff[7], aff[8]),
    ]


def unpack_dyn(dyn):
    """6 packed tensors -> (3 velocity tensors, 9 affine tensors), f32."""
    vel = [unpack_hi(dyn[0]), unpack_lo(dyn[0]), unpack_hi(dyn[1])]
    aff = [
        unpack_lo(dyn[1]), unpack_hi(dyn[2]), unpack_lo(dyn[2]),
        unpack_hi(dyn[3]), unpack_lo(dyn[3]), unpack_hi(dyn[4]),
        unpack_lo(dyn[4]), unpack_hi(dyn[5]), unpack_lo(dyn[5]),
    ]
    return vel, aff


def cell_coord(shape, axis: int, device, dtype=torch.float32) -> torch.Tensor:
    """Cell coordinate along grid ``axis`` broadcastable to [.., X, Y, Z]
    (``shape`` is the trailing (X, Y, Z))."""
    view = [1, 1, 1]
    view[axis] = shape[axis]
    return torch.arange(shape[axis], device=device, dtype=dtype).reshape(view)


def zpad(z: int) -> int:
    """The JAX table's z extent, padded to whole 128-lane rows. The port
    stores no padding, but G2P reads z as if it did (``ops/g2p.py``)."""
    return max(128, ((z + 127) // 128) * 128)


@dataclasses.dataclass
class SlotMajorTable:
    """posq int32[K,2,X,Y,Z]; dyn int32[K,6,X,Y,Z]; lost int32 scalar tensor
    (cumulative overflow drops)."""

    posq: torch.Tensor
    dyn: torch.Tensor
    lost: torch.Tensor
    grid_dim: Tuple[int, int, int]

    @property
    def capacity(self) -> int:
        return self.posq.shape[0]

    def num_particles(self) -> torch.Tensor:
        return valid_mask(self.posq).sum(dtype=torch.int32)

    def max_speed(self) -> torch.Tensor:
        vel, _ = unpack_dyn([self.dyn[:, c] for c in range(NUM_DYN)])
        sq = vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2]
        sq = torch.where(valid_mask(self.posq), sq, 0.0)
        return torch.sqrt(sq.max())

    def particles(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(positions, velocities): f32[N, 3] grid-space positions and
        velocities (grid units per second, bf16 stored) of the valid slots,
        in cell-major order (x, y, z, then slot: the JAX package's
        ``to_positions`` order), as new tensors on the table's device."""
        valid = valid_mask(self.posq).permute(1, 2, 3, 0)

        def cell_major(a):
            return a.permute(1, 2, 3, 0)[valid]

        rx, ry, rz, _ = unpack_posq(self.posq[:, CH_XY], self.posq[:, CH_ZV])
        pos = [rel_to_pos(r, cell_coord(self.grid_dim, a, r.device)) for a, r in enumerate((rx, ry, rz))]
        vel, _ = unpack_dyn([self.dyn[:, c] for c in range(NUM_DYN)])
        return tuple(torch.stack([cell_major(a) for a in v], dim=-1) for v in (pos, vel))
