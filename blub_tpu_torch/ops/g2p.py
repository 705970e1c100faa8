"""G2P: APIC advection and density position correction per slot (port of
``blub_tpu/ops/pallas_advect.py::_advect_pack_kernel`` and
``_correct_pack_kernel`` without their x-pack, which is ``ops/rebin.py``'s
pack along x; also computes what ``_advect_kernel``/``_correct_kernel`` do).

  mode advect: decode rel16, APIC G2P from the staggered face grids,
      RK4 with cell-confined probes, movement clamp +-1.99 and the +-2 cell
      window, wall clamp, re-encode rel16 and the bf16 velocity/affine pairs,
      and max |v| over valid slots (f32, before the bf16 store); with solids
      (occupancy + solid velocity) also the escape from occupied cells, the
      occupancy penetration test and the occupancy-gradient push;
  mode correct: trilinear position change from the change grids, clamp
      +-0.99 and the +-1 window, wall/solid-marker clamp, re-encode rel16;
      ``dyn`` is not touched.

The math is the slot-major XLA oracle's (``sim/sm_phases.py``
``advect_slot_major`` / ``correct_slot_major``). Grid reads, occupancy and
the marker included, are its rolls (``jnp.roll``): cyclic along x and y, and
along z over the JAX table's lane-padded extent ``zpad(Z)``, whose planes
past Z read 0 (``_zroll``, ``_gather``). So z = -1 and z = Z read 0 (the
marker's 0 is CELL_SOLID) unless Z is a multiple of 128, where z is cyclic.
Gridfix and the PCG zero-fill instead. Invalid slots come out all-zero. Advect with solids launches the
kernel's solids specialisation (counted as ``g2p_solids``).

``x_start`` and ``domain`` (the TPU kernels' ``with_xs`` variant, for the
mesh's x-windows, ``parallel/sharded_sm.py``): the grid is an x-window of the
``domain`` grid whose column 0 is global x plane ``x_start``. Positions and
cell coordinates are global, the wall clamps take the domain's dims, and x
reads stay cyclic over the window. The kernel's window instantiation is
counted as ``g2p_xs`` (``g2p_solids_xs`` with solids).
"""

from __future__ import annotations

from itertools import product

import numpy as np
import torch

from ..core.types import CELL_SOLID
from ..sim.gridops import roll
from ..sim.slot_major import (
    CH_XY, CH_ZV, NUM_DYN, NUM_POSQ, cell_coord, pack_dyn, pack_posq, pos_to_rel, rel_to_pos,
    unpack_posq, zpad,
)
from . import cuda

MAX_ADVECT_MOVE = 2 - 0.01  # cells per substep; the rebin window is +-2
MAX_CORRECT_MOVE = 0.99  # density correction; rebin window +-1
ADVECT_SHIFT = 2
CORRECT_SHIFT = 1

_P, _I, _F = cuda.P, cuda.I, cuda.F
_SIG = {
    "g2p_advect_launch": [_P] * 11 + [_F] + [_I] * 9 + [_P],
    "g2p_correct_launch": [_P] * 6 + [_I] * 9 + [_P],
}

_CORNERS = tuple(product((0, 1), (0, 1), (0, 1)))  # (cx, cy, cz)


def _mix(a, b, t):
    return a + (b - a) * t


def _tri(cc, ix, iy, iz):
    return _mix(
        _mix(_mix(cc[0, 0, 0], cc[1, 0, 0], ix), _mix(cc[0, 1, 0], cc[1, 1, 0], ix), iy),
        _mix(_mix(cc[0, 0, 1], cc[1, 0, 1], ix), _mix(cc[0, 1, 1], cc[1, 1, 1], ix), iy),
        iz,
    )


def _decode(posq, x_start: int = 0):
    """-> (pos[3] f32 [K,X,Y,Z], valid bool, cell coords gf[3] f32 and gi[3]
    int32, all global, and the window's own cell coords wi[3] int32: gi with
    x less ``x_start``, which index the window's grids)."""
    grid = posq.shape[2:]
    rx, ry, rz, vbit = unpack_posq(posq[:, CH_XY], posq[:, CH_ZV])
    wi = [cell_coord(grid, a, posq.device, torch.int32) for a in range(3)]
    gi = [wi[0] + x_start, wi[1], wi[2]] if x_start else wi
    gf = [cell_coord(grid, a, posq.device) for a in range(3)]
    if x_start:
        gf[0] = gf[0] + float(x_start)
    pos = [rel_to_pos(r, gf[a]) for a, r in enumerate((rx, ry, rz))]
    return pos, vbit == 1, gf, gi, wi


def _encode(new_pos, validb, gf):
    rels = [torch.where(validb, pos_to_rel(new_pos[a], gf[a]), 0) for a in range(3)]
    ch0, ch1 = pack_posq(rels[0], rels[1], rels[2], validb.to(torch.int32))
    return torch.stack([ch0, ch1], dim=1)


def _zroll(a, offset):
    """out[i] = a[i + offset] (``roll``'s read) with z rolled over
    ``zpad(Z)`` zero-padded planes, as the JAX package's padded grids."""
    z = a.shape[-1]
    zp = zpad(z)
    if zp == z:
        return roll(a, offset)
    return roll(torch.nn.functional.pad(a, (0, zp - z)), offset)[..., :z]


def _staggered(grids, pos, gf):
    """corners[c][(cx,cy,cz)] and interps[c] = (ix, iy, iz) for face grid c
    (sm_phases._staggered_corners_sm)."""
    xi = [torch.clamp(pos[a] - 0.5 - gf[a], 0.0, 1.0 - 1e-6) for a in range(3)]
    sel = [x >= 0.5 for x in xi]
    corners, interps = [], []
    for c in range(3):
        cc = {}
        for corner in _CORNERS:
            lo = list(corner)
            lo[c] -= 1
            cc[corner] = torch.where(sel[c], _zroll(grids[c], corner), _zroll(grids[c], lo))
        corners.append(cc)
        interps.append(tuple(
            xi[c] + torch.where(sel[c], -0.5, 0.5) if a == c else xi[a] for a in range(3)
        ))
    return corners, interps


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """f32 sqrt rounded once, as the kernel's sqrtf and XLA's: through f64
    (exact for f32 inputs). PyTorch's f32 sqrt on the CPU is not always
    correctly rounded (it can be one ulp off)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _clamp_step(pos, movement):
    """advect._clamp_step_to_cell, component-unrolled."""
    step_len = _sqrt_rn(movement[0] * movement[0] + movement[1] * movement[1] + movement[2] * movement[2]) + 1e-10
    direction = [m / step_len for m in movement]
    max_step = step_len
    for a in range(3):
        d = direction[a]
        ad = torch.abs(d)
        pic = pos[a] - torch.floor(pos[a])
        dist = torch.where(d > 0.0, 1.0 - pic, pic)
        per_axis = torch.where(ad > 0.0, dist / torch.where(ad > 0.0, ad, 1.0) - 0.001, float("inf"))
        max_step = torch.minimum(max_step, per_axis)
    return direction, max_step


def _gather(grid, idx):
    """grid[idx] with ``_zroll``'s indices (``jnp.roll`` reads: x and y
    cyclic, z over the padded extent, 0 past Z); ``idx`` is three int
    tensors that broadcast to the slot shape."""
    x, y, z = grid.shape
    iz = torch.remainder(idx[2], zpad(z)).long()
    inside = iz < z
    lin = (torch.remainder(idx[0], x).long() * y + torch.remainder(idx[1], y).long()) * z
    got = grid.reshape(-1)[lin + torch.where(inside, iz, 0)]
    return torch.where(inside, got, torch.zeros((), dtype=grid.dtype, device=grid.device))


def _escape(pos, gf, gi, occupancy, solid_velocity):
    """A particle whose primal cell is occupied moves one cell along the
    dominant axis of the solid velocity there, in its sign (ties go to the
    later axis, as ``sm_phases.advect_slot_major`` :269-288)."""
    pc = [gi[a] + ((pos[a] - 0.5 - gf[a]) >= 0.5).to(torch.int32) for a in range(3)]
    swallowed = _gather(occupancy, pc) > 0.0
    sv = [_gather(solid_velocity[a], pc) for a in range(3)]
    ab = [torch.abs(v) for v in sv]
    use_x = (ab[0] > ab[1]) & (ab[0] > ab[2])
    use_y = ~use_x & (ab[1] > ab[2])
    use = (use_x, use_y, ~use_x & ~use_y)
    return [torch.where(swallowed & use[a], pos[a] + torch.sign(sv[a]), pos[a]) for a in range(3)]


def _occupied_target(occupancy, new_pos, gi):
    """Penetration by occupancy: the target cell, its offset from the bin
    cell clipped to +-2, is occupied (positions and cells in the grid's own
    frame)."""
    d = [torch.clamp(torch.floor(new_pos[a]).to(torch.int32) - gi[a], -2, 2) for a in range(3)]
    return _gather(occupancy, [gi[a] + d[a] for a in range(3)]) > 0.0


def _push(occupancy, pos, gf, gi, scale):
    """dt*50 * the trilinear read at the (unclipped) xi of the central
    occupancy difference 0.5*(occ[g-e_a] - occ[g+e_a]), in
    ``_trilinear_center_sm``'s corner order."""
    xi = [pos[a] - 0.5 - gf[a] for a in range(3)]
    out = []
    for a in range(3):
        acc = 0.0
        for off in _CORNERS:
            w = 1.0
            for b in range(3):
                w = w * (xi[b] if off[b] else 1.0 - xi[b])
            lo = [gi[b] + off[b] - int(b == a) for b in range(3)]
            hi = [gi[b] + off[b] + int(b == a) for b in range(3)]
            acc = acc + w * (0.5 * (_gather(occupancy, lo) - _gather(occupancy, hi)))
        out.append(acc * scale)
    return out


def _f32(v) -> float:
    """A host scalar rounded to f32, as a Python float (exact)."""
    return float(np.float32(v))


def advect_plain(posq, vel, dt, occupancy=None, solid_velocity=None, x_start: int = 0, domain=None):
    """Plain PyTorch version: -> (posq_out, dyn_out, max |v|^2 as f32 0-dim).
    ``occupancy`` f32[X,Y,Z] and ``solid_velocity`` f32[3,X,Y,Z] come
    together or not at all. ``x_start``/``domain``: an x-window of the domain
    (module docstring)."""
    dom = posq.shape[2:] if domain is None else domain
    gmax = [_f32(float(dom[a]) - 1.001) for a in range(3)]
    dt32 = np.float32(dt)
    h, c6 = float(dt32 * np.float32(0.5)), float(dt32 * np.float32(1.0 / 6.0))
    pos, validb, gf, gi, wi = _decode(posq, x_start)
    if occupancy is not None:
        pos = _escape(pos, gf, wi, occupancy, solid_velocity)
    corners, interps = _staggered(vel, pos, gf)

    velocity, affine = [], []
    for c in range(3):
        s, (ix, iy, iz) = corners[c], interps[c]
        v_x00 = _mix(s[0, 0, 0], s[1, 0, 0], ix)
        v_x01 = _mix(s[0, 0, 1], s[1, 0, 1], ix)
        v_x10 = _mix(s[0, 1, 0], s[1, 1, 0], ix)
        v_x11 = _mix(s[0, 1, 1], s[1, 1, 1], ix)
        v_xy0 = _mix(v_x00, v_x10, iy)
        v_xy1 = _mix(v_x01, v_x11, iy)
        velocity.append(_mix(v_xy0, v_xy1, iz))
        cx = _mix(_mix(s[1, 0, 0], s[1, 1, 0], iy), _mix(s[1, 0, 1], s[1, 1, 1], iy), iz) - _mix(
            _mix(s[0, 0, 0], s[0, 1, 0], iy), _mix(s[0, 0, 1], s[0, 1, 1], iy), iz
        )
        cy = _mix(v_x10, v_x11, iz) - _mix(v_x00, v_x01, iz)
        cz = v_xy1 - v_xy0
        affine.append((cx, cy, cz))

    def probe(st):
        return [
            _tri(corners[c], *(torch.clamp(interps[c][a] + st[a], 0.0, 1.0) for a in range(3)))
            for c in range(3)
        ]

    k1 = velocity
    k2 = probe([h * k for k in k1])
    k3 = probe([h * k for k in k2])
    k4 = probe([float(dt32) * k for k in k3])
    movement = [c6 * (k1[a] + 2.0 * (k2[a] + k3[a]) + k4[a]) for a in range(3)]
    movement = [torch.clamp(m, -MAX_ADVECT_MOVE, MAX_ADVECT_MOVE) for m in movement]
    new_pos = [torch.clamp(pos[a] + movement[a], gf[a] - 1.499, gf[a] + 2.499) for a in range(3)]
    movement = [new_pos[a] - pos[a] for a in range(3)]
    pen = torch.zeros_like(validb)  # out of bounds, or into an occupied cell
    for a in range(3):
        pen = pen | (new_pos[a] < 1.001) | (new_pos[a] > gmax[a])
    if occupancy is not None:
        # in the window's frame: x less x_start (exact, an integer shift)
        pen = pen | _occupied_target(occupancy, [new_pos[0] - float(x_start)] + new_pos[1:] if x_start else new_pos, wi)
    direction, max_step = _clamp_step(pos, movement)
    cl = [direction[a] * max_step for a in range(3)]
    if occupancy is not None:
        stuck = torch.ones_like(validb)
        for a in range(3):
            stuck = stuck & (torch.floor(pos[a]).to(torch.int32) == torch.floor(new_pos[a]).to(torch.int32))
        push = _push(occupancy, pos, gf, wi, float(dt32 * np.float32(50.0)))
        cl = [torch.where(stuck & pen, cl[a] + push[a], cl[a]) for a in range(3)]
    # a true division, as the kernel's: PyTorch divides a CUDA tensor by a
    # host scalar through its reciprocal, which can differ by one ulp
    inv_dt = max_step / torch.full_like(max_step, float(dt32))
    for a in range(3):
        corrected = torch.clamp(pos[a] + cl[a], 1.001, gmax[a])
        new_pos[a] = torch.where(pen, corrected, new_pos[a])
        velocity[a] = torch.where(pen, direction[a] * inv_dt, velocity[a])

    vq = [torch.where(validb, velocity[a], 0.0) for a in range(3)]
    ms = torch.max(vq[0] * vq[0] + vq[1] * vq[1] + vq[2] * vq[2])
    aq = [torch.where(validb, affine[c][a], 0.0) for c in range(3) for a in range(3)]
    dyn = torch.stack(pack_dyn(vq, aq), dim=1)
    return _encode(new_pos, validb, gf), dyn, ms


def correct_plain(posq, change, marker, x_start: int = 0, domain=None):
    """Plain PyTorch version: -> posq_out (dyn is unchanged)."""
    dom = posq.shape[2:] if domain is None else domain
    gmax = [_f32(float(dom[a]) - 1.001) for a in range(3)]
    pos, validb, gf, gi, _ = _decode(posq, x_start)
    corners, interps = _staggered(change, pos, gf)
    movement = [_tri(corners[c], *interps[c]) for c in range(3)]
    movement = [torch.clamp(m, -MAX_CORRECT_MOVE, MAX_CORRECT_MOVE) for m in movement]
    new_pos = [torch.clamp(pos[a] + movement[a], gf[a] - 0.499, gf[a] + 1.999) for a in range(3)]
    movement = [new_pos[a] - pos[a] for a in range(3)]
    oob = torch.zeros_like(validb)
    for a in range(3):
        oob = oob | (new_pos[a] < 1.001) | (new_pos[a] > gmax[a])
    d = [torch.clamp(torch.floor(new_pos[a]).to(torch.int32) - gi[a], -1, 1) for a in range(3)]
    target = torch.zeros_like(pos[0])
    markerf = marker.to(torch.float32)
    for off in product((-1, 0, 1), repeat=3):
        hit = (d[0] == off[0]) & (d[1] == off[1]) & (d[2] == off[2])
        target = target + torch.where(hit, _zroll(markerf, off), 0.0)
    penetrates = oob | (target == float(CELL_SOLID))
    direction, max_step = _clamp_step(pos, movement)
    for a in range(3):
        corrected = torch.clamp(pos[a] + direction[a] * max_step, 1.001, gmax[a])
        new_pos[a] = torch.where(penetrates, corrected, new_pos[a])
    return _encode(new_pos, validb, gf)


def _window(posq, x_start, domain):
    """-> (window flag, x_start, DX, DY, DZ) of a launch; validated."""
    k, _, x, y, z = posq.shape
    if x_start is None:
        if domain is not None:
            raise ValueError("g2p: domain comes with x_start")
        return 0, 0, x, y, z
    dx, dy, dz = (int(v) for v in domain)
    if (dy, dz) != (y, z) or not (-x < int(x_start) < dx):
        raise ValueError(f"g2p: window {(x, y, z)} at x {x_start} does not lie in the domain {tuple(domain)}")
    return 1, int(x_start), dx, dy, dz


def advect(posq: torch.Tensor, vel, dt, occupancy=None, solid_velocity=None, x_start=None, domain=None):
    """-> (posq_out, dyn_out, max_speed f32 0-dim tensor). ``occupancy``
    f32[X,Y,Z] and ``solid_velocity`` f32[3,X,Y,Z] (a ``SolidState``'s
    fields) select the solids specialisation; ``x_start`` (an int) and
    ``domain`` the x-window variant."""
    if (occupancy is None) != (solid_velocity is None):
        raise ValueError("g2p advect: occupancy and solid_velocity come together")
    window = _window(posq, x_start, domain)
    if not posq.is_cuda:
        out_p, out_d, ms = advect_plain(posq, vel, dt, occupancy, solid_velocity, window[1], window[2:])
        return out_p, out_d, _sqrt_rn(ms)
    k, _, x, y, z = posq.shape
    cuda.require(posq, torch.int32, (k, NUM_POSQ, x, y, z), "g2p posq")
    for c in range(3):
        cuda.require(vel[c], torch.float32, (x, y, z), f"g2p velocity {c}")
    if occupancy is not None:
        cuda.require(occupancy, torch.float32, (x, y, z), "g2p occupancy")
        cuda.require(solid_velocity, torch.float32, (3, x, y, z), "g2p solid velocity")
        solid = [cuda.ptr(occupancy)] + [cuda.ptr(solid_velocity[c]) for c in range(3)]
    else:
        solid = [None] * 4  # null: the specialisation without solids
    out_p = torch.empty_like(posq)
    out_d = torch.empty((k, NUM_DYN, x, y, z), dtype=torch.int32, device=posq.device)
    ms = torch.zeros((), dtype=torch.int32, device=posq.device)  # f32 bits of max |v|^2
    lib = cuda.library("g2p", _SIG)
    P = cuda.ptr
    err = lib.g2p_advect_launch(
        P(posq), P(vel[0]), P(vel[1]), P(vel[2]), *solid, P(out_p), P(out_d), P(ms), float(np.float32(dt)),
        k, x, y, z, *window, cuda.stream(),
    )
    cuda.count_launch(("g2p" if occupancy is None else "g2p_solids") + ("_xs" if window[0] else ""))
    cuda.check(lib, err, "g2p advect")
    return out_p, out_d, torch.sqrt(ms.view(torch.float32))  # correctly rounded on the card


def correct(posq: torch.Tensor, change, marker: torch.Tensor, x_start=None, domain=None):
    """-> posq_out. ``x_start`` and ``domain``: the x-window variant."""
    window = _window(posq, x_start, domain)
    if not posq.is_cuda:
        return correct_plain(posq, change, marker, window[1], window[2:])
    k, _, x, y, z = posq.shape
    cuda.require(posq, torch.int32, (k, NUM_POSQ, x, y, z), "g2p posq")
    cuda.require(marker, torch.int8, (x, y, z), "g2p marker")
    for c in range(3):
        cuda.require(change[c], torch.float32, (x, y, z), f"g2p change {c}")
    out_p = torch.empty_like(posq)
    lib = cuda.library("g2p", _SIG)
    P = cuda.ptr
    err = lib.g2p_correct_launch(
        P(posq), P(change[0]), P(change[1]), P(change[2]), P(marker), P(out_p), k, x, y, z, *window, cuda.stream(),
    )
    cuda.count_launch("g2p_xs" if window[0] else "g2p")
    cuda.check(lib, err, "g2p correct")
    return out_p
