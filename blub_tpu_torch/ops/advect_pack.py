"""G2P fused with the x pack: advect + x pack and correct + x pack in one
launch each (port of ``blub_tpu/ops/pallas_advect.py::_advect_pack_kernel``
and ``_correct_pack_kernel``, with their ``with_solids`` and ``with_xs``
forms).

``advect_pack`` computes what ``g2p.advect`` followed by ``rebin.pack``
along x (reach ``g2p.ADVECT_SHIFT``) computes, bit for bit, and
``correct_pack`` what ``g2p.correct`` followed by the x pack (reach
``g2p.CORRECT_SHIFT``, the payload the input's dyn) computes; the moved
K-slot table is never written. ``advect_pack_plain`` and
``correct_pack_plain`` are exactly that composition of the plain versions:
the CPU path and the kernels' oracle. A CUDA tensor launches
``csrc/advect_pack.cu``'s kernel or raises; its launches count as
``advect_pack`` (``advect_pack_solids`` with occupancy and solid velocity,
``_xs`` on an x-window) and ``correct_pack`` (``correct_pack_xs``).

``x_start`` and ``domain``: the table is an x-window of the ``domain`` grid
whose column 0 is global x plane ``x_start`` (the mesh's windows,
``parallel/sharded_sm.py``), as for ``g2p.advect`` and ``rebin.pack``.

The fused kernels keep the x pack's masks and codes in shared memory and,
in what is left of it, the moved words of as many of the tile's valid slots
as fit (the rest run G2P again; ``advect_pack.cu``'s head comment), so they
take every table the card's packs take (up to ``rebin.MAX_SLOTS`` slots) and
the step runs them at every shape: JAX's shape gate (``LocalPhases.fused``,
``pallas_advect.fused_supports``) has no false case here. ``launch_config``
reports a form's launch on the card (tile, shared memory, resident blocks,
registers, cached slots).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..sim.slot_major import NUM_DYN, NUM_POSQ
from . import cuda, g2p, rebin

_P, _I, _F = cuda.P, cuda.I, cuda.F
_SIG = {
    "advect_pack_launch": [_P] * 12 + [_F] + [_I] * 11 + [_P],
    "correct_pack_launch": [_P] * 9 + [_I] * 11 + [_P],
    "advect_pack_config": [_I] * 9 + [_P],
}


def _dim(domain):
    return None if domain is None else int(domain[0])


def advect_pack_plain(posq, vel, dt, occupancy, solid_velocity, k_out: int, x_start: int = 0, domain=None):
    """``g2p.advect_plain`` then ``rebin.pack_plain`` along x: -> (posq_mid,
    dyn_mid, max speed f32 0-dim, counts int32[2]: dropped, kept)."""
    p, d, ms = g2p.advect_plain(posq, vel, dt, occupancy, solid_velocity, x_start, domain)
    p, d, dropped, kept = rebin.pack_plain(p, d, 0, g2p.ADVECT_SHIFT, k_out, x_start, _dim(domain))
    return p, d, g2p._sqrt_rn(ms), torch.stack([dropped, kept])


def correct_pack_plain(posq, dyn, change, marker, k_out: int, x_start: int = 0, domain=None):
    """``g2p.correct_plain`` then ``rebin.pack_plain`` along x (the payload
    the input's dyn): -> (posq_mid, dyn_mid, counts int32[2])."""
    p = g2p.correct_plain(posq, change, marker, x_start, domain)
    p, d, dropped, kept = rebin.pack_plain(p, dyn, 0, g2p.CORRECT_SHIFT, k_out, x_start, _dim(domain))
    return p, d, torch.stack([dropped, kept])


def _outputs(posq, k_out: int, what: str):
    """Validate the table and the slot counts; -> empty output tables and
    zeroed counts on the card."""
    k_in, _, x, y, z = posq.shape
    if not (0 < k_in <= rebin.MAX_SLOTS and 0 < k_out <= rebin.MAX_SLOTS):
        raise ValueError(f"{what} on the card takes up to {rebin.MAX_SLOTS} slots (k_in={k_in}, k_out={k_out})")
    if max(k_in, k_out) * (NUM_POSQ + NUM_DYN) * x * y * z > 2**31 - 1:
        raise ValueError(f"{what}: a table of {max(k_in, k_out)} slots over {(x, y, z)} cells overflows the "
                         f"kernel's 32-bit offsets")
    cuda.require(posq, torch.int32, (k_in, NUM_POSQ, x, y, z), f"{what} posq")
    dev = posq.device
    return (torch.empty((k_out, NUM_POSQ, x, y, z), dtype=torch.int32, device=dev),
            torch.empty((k_out, NUM_DYN, x, y, z), dtype=torch.int32, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev))


def advect_pack(posq: torch.Tensor, vel, dt, occupancy, solid_velocity, k_out: int, x_start=None, domain=None,
                with_counts: bool = False):
    """G2P advect then the x pack into ``k_out`` slots: -> (posq_mid,
    dyn_mid, max_speed f32 0-dim), and the counts int32[2] (dropped, kept)
    with ``with_counts``. ``occupancy`` f32[X,Y,Z] and ``solid_velocity``
    f32[3,X,Y,Z] select the solids specialisation; ``x_start`` (an int) and
    ``domain`` the x-window form."""
    if (occupancy is None) != (solid_velocity is None):
        raise ValueError("advect_pack: occupancy and solid_velocity come together")
    window = g2p._window(posq, x_start, domain)
    if not posq.is_cuda:
        out = advect_pack_plain(posq, vel, dt, occupancy, solid_velocity, k_out, window[1],
                                window[2:] if window[0] else None)
        return out if with_counts else out[:3]
    k, _, x, y, z = posq.shape
    out_p, out_d, counts = _outputs(posq, k_out, "advect_pack")
    for c in range(3):
        cuda.require(vel[c], torch.float32, (x, y, z), f"advect_pack velocity {c}")
    if occupancy is not None:
        cuda.require(occupancy, torch.float32, (x, y, z), "advect_pack occupancy")
        cuda.require(solid_velocity, torch.float32, (3, x, y, z), "advect_pack solid velocity")
        solid = [cuda.ptr(occupancy)] + [cuda.ptr(solid_velocity[c]) for c in range(3)]
    else:
        solid = [None] * 4  # null: the specialisation without solids
    ms = torch.zeros((), dtype=torch.int32, device=posq.device)  # f32 bits of max |v|^2
    lib = cuda.library("advect_pack", _SIG)
    P = cuda.ptr
    err = lib.advect_pack_launch(
        P(posq), P(vel[0]), P(vel[1]), P(vel[2]), *solid, P(out_p), P(out_d), P(counts), P(ms),
        float(np.float32(dt)), k, k_out, g2p.ADVECT_SHIFT, x, y, z, *window, cuda.stream(),
    )
    cuda.count_launch(("advect_pack" if occupancy is None else "advect_pack_solids") + ("_xs" if window[0] else ""))
    cuda.check(lib, err, "advect_pack")
    out = (out_p, out_d, torch.sqrt(ms.view(torch.float32)))  # correctly rounded on the card
    return out + (counts,) if with_counts else out


def correct_pack(posq: torch.Tensor, dyn: torch.Tensor, change, marker: torch.Tensor, k_out: int, x_start=None,
                 domain=None, with_counts: bool = False):
    """G2P correct then the x pack into ``k_out`` slots (dyn moves with its
    slot, unchanged): -> (posq_mid, dyn_mid), and the counts int32[2]
    (dropped, kept) with ``with_counts``. ``x_start`` and ``domain``: the
    x-window form."""
    window = g2p._window(posq, x_start, domain)
    if not posq.is_cuda:
        out = correct_pack_plain(posq, dyn, change, marker, k_out, window[1], window[2:] if window[0] else None)
        return out if with_counts else out[:2]
    k, _, x, y, z = posq.shape
    out_p, out_d, counts = _outputs(posq, k_out, "correct_pack")
    cuda.require(dyn, torch.int32, (k, NUM_DYN, x, y, z), "correct_pack dyn")
    cuda.require(marker, torch.int8, (x, y, z), "correct_pack marker")
    for c in range(3):
        cuda.require(change[c], torch.float32, (x, y, z), f"correct_pack change {c}")
    lib = cuda.library("advect_pack", _SIG)
    P = cuda.ptr
    err = lib.correct_pack_launch(
        P(posq), P(dyn), P(change[0]), P(change[1]), P(change[2]), P(marker), P(out_p), P(out_d), P(counts),
        k, k_out, g2p.CORRECT_SHIFT, x, y, z, *window, cuda.stream(),
    )
    cuda.count_launch("correct_pack_xs" if window[0] else "correct_pack")
    cuda.check(lib, err, "correct_pack")
    return (out_p, out_d, counts) if with_counts else (out_p, out_d)


def launch_config(phase: str, k_in: int, k_out: int, grid, solids: bool = False, window: bool = False) -> dict:
    """The card's launch of a fused form (``phase`` "advect" or "correct")
    on a ``k_in``-slot table of ``grid`` cells into ``k_out`` slots: x planes
    of a tile, dynamic shared memory bytes, resident blocks per SM, registers
    a thread, threads a block, moved slots its cache holds (needs the
    card)."""
    s = g2p.ADVECT_SHIFT if phase == "advect" else g2p.CORRECT_SHIFT
    out = (ctypes.c_int * 6)()
    lib = cuda.library("advect_pack", _SIG)
    err = lib.advect_pack_config(int(phase == "advect"), int(solids), int(window), k_in, k_out, s, *grid,
                                 ctypes.cast(out, ctypes.c_void_p))
    cuda.check(lib, err, "advect_pack_config")
    return dict(zip(("tile_x", "smem_bytes", "blocks_per_sm", "registers", "threads", "cached_slots"), list(out)))
