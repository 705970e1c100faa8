"""PCG pressure solve: one cooperative persistent CUDA kernel per solve,
``pcg_solve_kernel`` of ``csrc/pcg.cu`` (port of
``blub_tpu/ops/pallas_pcg.py::_kernel`` and
``blub_tpu/ops/pallas_pcg_blocked.py::_k1_kernel``/``_k2_kernel``, which
compute one solve).

The plain version is ``sim/pressure.solve_pressure_plain``. The kernel runs
the same iteration, check rule included (``i % freq == 0 or i == max_iter -
1``), inside one launch: the iteration count, the exit error and the
pressure stay on the device, and the wrapper reads nothing back, so a solve
never stalls the host. Its dot products sum one partial per 256 cells in the
order of the pass kernels' reduction, whatever the block count: a solve gives
the bits of the passes run one launch at a time. ``with_history=True``
launches the kernel's history instantiation, which also records max|r| at
every iteration (the ``with_history`` variant of the TPU kernels).

``pass_setup``, ``k1_pass`` and ``k2_pass`` run the setup and the two passes
of an iteration alone (``probes/pcg_passes.py`` times them): k1 (s, A s and
the partials of s.As), then k2, which sums those partials itself for alpha,
and the tail (beta, sigma, err). Their plain versions are built on
``sim/pressure.k1_step`` and ``k2_step``, the two halves of the plain
solve's iteration.

``slab_*`` are the same passes on an x slab, the mesh's solve
(``parallel/sharded_sm.py::solve_pressure_sharded`` runs them with the halo
exchanges and all-reduces between them; counted as ``pcg_slab``): the pass
kernels' instantiation for grids with one halo plane on each side along x
(``[X+2, Y, Z]``, the slab's X planes between), which also carries s and r
onto the halo planes. An iteration is three launches: ``slab_k1``,
``slab_k2`` (alpha from the all-reduced k1 partials, in every block) and
``slab_tail`` (beta, sigma, err and the loop predicate, which a CUDA WHILE
node reads). r and s are pairs of grids; the parity of the device
iteration count picks the older of each, so nothing is copied between
iterations. Their plain versions apply ``sim/pressure``'s functions to the
extended grids and keep the slab's planes; their partials are one sum per
rank.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..core.config import SolverConfig
from ..core.types import CELL_FLUID, SolverStats
from ..sim.pressure import (
    PressureSolveResult,
    apply_A,
    diag_coefficients,
    guarded_div,
    k1_step,
    k2_step,
    neighbor_masks,
    precondition,
    solve_pressure_plain,
    solve_tolerance,
)
from . import cuda

_P, _I, _F = cuda.P, cuda.I, cuda.F
_SIG = {
    "pcg_solve_blocks": [_I, _I, _I, _I],
    "pcg_solve_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _P],
    "pcg_setup_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    "pcg_init_launch": [_P] * 6 + [_I, _I, _I, _P],
    "pcg_k1_launch": [_P, _P, _P, _P, _I] + [_P] * 5 + [_I, _I, _I, _I, _P],
    "pcg_k2_launch": [_P] * 6 + [_I, _P, _P, _I] + [_P] * 5 + [_I, _I, _I, _I, _P],
    "pcg_tail_launch": [_P, _I, _P, _I, _P, _I, _P, _P, _F, _I, _I, _P],
    "pcg_pass_config": [_I, _I, _I, _I, _P],
    "pcg_solve_partials": [_I, _I, _I],
}
SIGMA, ALPHA, BETA, ERR = 0, 1, 2, 3  # slots of the scalar vector
SOLVE_THREADS = 256  # threads per block of pcg_solve_kernel (THREADS in csrc/pcg.cu)
_WORK_GRIDS = 8  # scratch grids of a solve: diag, dfl, z, As, r x2, s x2
_BLOCKS: Dict[Tuple[int, Tuple[int, ...], bool], int] = {}


def solve_blocks(shape, history: bool = False) -> int:
    """Blocks of the cooperative solve at ``shape`` on the current card: as
    many as it holds at once (occupancy x SMs), at most 1024 and one per
    ``SOLVE_THREADS`` cells; cached per card, shape and instantiation
    (``history``). Raises if the card has no cooperative launch."""
    key = (torch.cuda.current_device(), tuple(shape), history)
    nb = _BLOCKS.get(key)
    if nb is None:
        lib = cuda.library("pcg", _SIG)
        nb = lib.pcg_solve_blocks(*shape, int(history))
        if nb <= 0:
            cuda.check(lib, -nb, "pcg_solve_blocks")
        _BLOCKS[key] = nb
    return nb


def solve_pressure(
    initial_pressure: torch.Tensor, rhs: torch.Tensor, marker: torch.Tensor,
    config: SolverConfig, dt, with_history: bool = False,
) -> PressureSolveResult:
    """PCG solve of A p = rhs on fluid cells: the plain version for CPU
    tensors; for CUDA tensors one cooperative launch of the persistent
    kernel, with no host read (``stats.iterations`` is a 0-d int32 tensor on
    the device). ``with_history=True`` also returns ``history``, f32
    ``[max_num_iterations]`` of max|r| x dt at every iteration, +inf past
    the exit."""
    if not rhs.is_cuda:
        return solve_pressure_plain(initial_pressure, rhs, marker, config, dt, with_history)
    shape = tuple(rhs.shape)
    cuda.require(rhs, torch.float32, shape, "pcg rhs")
    cuda.require(initial_pressure, torch.float32, shape, "pcg initial pressure")
    cuda.require(marker, torch.int8, shape, "pcg marker")
    lib = cuda.library("pcg", _SIG)
    nb = solve_blocks(shape, with_history)
    dev = rhs.device
    p = torch.empty(shape, dtype=torch.float32, device=dev)
    work = torch.empty((_WORK_GRIDS,) + shape, dtype=torch.float32, device=dev)
    partial = torch.empty(lib.pcg_solve_partials(*shape), dtype=torch.float32, device=dev)
    scal = torch.empty(4, dtype=torch.float32, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    hist = torch.full((config.max_num_iterations,), float("inf"), device=dev) if with_history else None
    P = cuda.ptr
    err = lib.pcg_solve_launch(
        P(marker), P(initial_pressure), P(rhs), P(p), P(work), P(partial), P(scal), P(iters),
        P(hist) if with_history else None, solve_tolerance(config, dt), config.max_num_iterations,
        config.error_check_frequency, nb, *shape, cuda.stream(),
    )
    cuda.count_launch("pcg_history" if with_history else "pcg")
    cuda.check(lib, err, "pcg_solve_launch")
    return PressureSolveResult(pressure=p, stats=SolverStats(error=scal[ERR] * float(dt), iterations=iters),
                               history=hist * float(dt) if with_history else None)


def _call(fn: str, count: str, *args) -> None:
    """One C entry point of ``csrc/pcg.cu``, which launches one kernel."""
    lib = cuda.library("pcg", _SIG)
    err = getattr(lib, fn)(*args)
    cuda.count_launch(count)
    cuda.check(lib, err, fn)


def num_partials(shape) -> int:
    """Partials of a pass at ``shape``: one per chunk of 256 cells (k2's
    max|r|, one per block and 0 past them, takes as many)."""
    return -(-int(shape[0]) * int(shape[1]) * int(shape[2]) // SOLVE_THREADS)


def pass_config(shape, halo: int = 0) -> dict:
    """How the pass kernels launch at ``shape`` on the current card: blocks
    of k1 and k2 (at most as many as it holds at once), their dynamic shared
    memory per block, the tiles (2 chunks each) and the x planes each block
    marches through (1: single tiles)."""
    out = (ctypes.c_int * 7)()
    lib = cuda.library("pcg", _SIG)
    cuda.check(lib, lib.pcg_pass_config(halo, *shape, ctypes.cast(out, ctypes.c_void_p)), "pcg_pass_config")
    return {"k1_blocks": out[0], "k2_blocks": out[1], "k1_smem_bytes": out[2], "k2_smem_bytes": out[3],
            "tiles": out[4], "k1_march": out[5], "k2_march": out[6]}


def pass_setup(marker: torch.Tensor):
    """-> (diag, dfl): the non-solid neighbour count and dsafe on fluid
    cells, 0 elsewhere (``dfl > 0`` is the fluid mask)."""
    if not marker.is_cuda:
        diag = diag_coefficients(marker)
        return diag, torch.where(marker == CELL_FLUID, torch.where(diag > 0.0, diag, 1.0), 0.0)
    shape = tuple(marker.shape)
    cuda.require(marker, torch.int8, shape, "pcg marker")
    diag = torch.empty(shape, dtype=torch.float32, device=marker.device)
    dfl = torch.empty_like(diag)
    P = cuda.ptr
    _call("pcg_setup_launch", "pcg", P(marker), P(diag), P(dfl), 0, *shape, cuda.stream())
    return diag, dfl


def _plain_ops(diag, dfl):
    """(fluid, diag, nbr_pos, nbr_neg) of the plain steps, from the setup."""
    fluid = dfl > 0.0
    return (fluid, diag) + neighbor_masks(fluid)


def _alpha(part, scal):
    """alpha of the plain k2 passes: sigma / (sum of the partials +- 1e-10),
    or 0 without partials (the z0 pass)."""
    return torch.zeros((), dtype=torch.float32, device=scal.device) if part is None else guarded_div(
        scal[SIGMA], torch.sum(part))


def k1_pass_plain(z, s_old, scal, diag, dfl):
    s, As, sAs = k1_step(z, s_old, scal[BETA], *_plain_ops(diag, dfl))
    return s, As, sAs.reshape(1)


def k2_pass_plain(p, r_old, s, As, part, scal, diag, dfl):
    scal[ALPHA] = _alpha(part, scal)
    p_new, r, z, sigma = k2_step(p, r_old, s, As, scal[ALPHA], *_plain_ops(diag, dfl))
    p.copy_(p_new)
    scal[BETA] = 0.0 if part is None else guarded_div(sigma, scal[SIGMA])
    scal[SIGMA] = sigma
    scal[ERR] = torch.max(torch.abs(r))
    return r, z


def k1_pass(z, s_old, scal, diag, dfl):
    """One k1 pass: s = z + beta s_old, As = A s and the partials of s.As
    (one per 256 cells, each in the pass kernels' order of sums; on the CPU
    their one sum). -> (s, As, part); ``scal`` (f32 [sigma, alpha, beta,
    err]) gives beta. The CUDA pass reads the neighbours of z and s_old
    unmasked, so both must vanish off fluid."""
    if not z.is_cuda:
        return k1_pass_plain(z, s_old, scal, diag, dfl)
    shape = tuple(z.shape)
    for t, what in ((z, "z"), (s_old, "s_old"), (diag, "diag"), (dfl, "dfl")):
        cuda.require(t, torch.float32, shape, f"pcg k1 {what}")
    cuda.require(scal, torch.float32, (4,), "pcg scalars")
    s, As = torch.empty_like(z), torch.empty_like(z)
    part = torch.empty(num_partials(shape), dtype=torch.float32, device=z.device)
    P = cuda.ptr
    _call("pcg_k1_launch", "pcg", P(z), P(s_old), P(s), None, 0, P(scal), P(diag), P(dfl), P(As), P(part), 0,
          *shape, cuda.stream())
    return s, As, part


def k2_pass(p, r_old, s, As, part, scal, diag, dfl):
    """One k2 pass and the tail: alpha = sigma / (the ordered sum of k1's
    partials ``part`` +- 1e-10), or 0 with ``part`` None (the z0 pass); p +=
    alpha s (in place), r = r_old - alpha As, z = K K^T r; then scal gets
    alpha, beta (0 with ``part`` None), sigma = z.r and err = max|r|. Two
    launches. -> (r, z)."""
    if not r_old.is_cuda:
        return k2_pass_plain(p, r_old, s, As, part, scal, diag, dfl)
    shape = tuple(r_old.shape)
    for t, what in ((p, "p"), (r_old, "r_old"), (s, "s"), (As, "As"), (dfl, "dfl")):
        cuda.require(t, torch.float32, shape, f"pcg k2 {what}")
    cuda.require(scal, torch.float32, (4,), "pcg scalars")
    if part is not None:
        cuda.require(part, torch.float32, (part.numel(),), "pcg k2 partials")
    r, z = torch.empty_like(r_old), torch.empty_like(r_old)
    n = num_partials(shape)
    pz = torch.empty(n, dtype=torch.float32, device=r_old.device)
    pm = torch.empty_like(pz)
    P, st = cuda.ptr, cuda.stream()
    _call("pcg_k2_launch", "pcg", P(p), P(r_old), P(r), None, P(s), None, 0, P(As),
          None if part is None else P(part), 0 if part is None else part.numel(), P(scal), P(dfl), P(z), P(pz), P(pm),
          0, *shape, st)
    _call("pcg_tail_launch", "pcg", P(pz), n, P(pm), n, P(scal), int(part is None), None, None, 0.0, 0, 1, st)
    return r, z


# ---------------------------------------------------------------------------
# the passes on an x slab (the mesh's solve)


def _core(ext: torch.Tensor) -> torch.Tensor:
    return ext[1:-1]


def _pad(core: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(core, (0, 0, 0, 0, 1, 1))


def _slab_shape(ext: torch.Tensor, what: str):
    x2, y, z = ext.shape
    if x2 < 3:
        raise ValueError(f"pcg slab {what}: {tuple(ext.shape)} holds no plane between its two halo planes")
    return x2 - 2, y, z


def _require(tensors, dtype, shape, what: str) -> None:
    for t, name in tensors:
        cuda.require(t, dtype, shape, f"pcg slab {what} {name}")


def _slab_ops(dfl: torch.Tensor):
    fluid = dfl > 0.0
    return (fluid,) + neighbor_masks(fluid)


def _older_newer(pair, it):
    """(older, newer) of a pair of grids at iteration ``it`` (plain versions)."""
    return (pair[1], pair[0]) if int(it) % 2 else (pair[0], pair[1])


def _parity(it):
    """The kernels' (it pointer, flip): a device int32 count is read on the
    card, a host int is passed as its parity."""
    return (cuda.ptr(it), 0) if isinstance(it, torch.Tensor) else (None, int(it) % 2)


def slab_partials(shape, device) -> torch.Tensor:
    """A buffer for a slab pass's partials: one per 256 cells of the slab on
    the card (the pass kernels' chunks; k2's max|r| takes one per block, at
    most as many), the rank's one sum on the CPU."""
    dev = torch.device(device)
    return torch.zeros(num_partials(shape) if dev.type == "cuda" else 1, dtype=torch.float32, device=dev)


def slab_setup(marker):
    """-> (diag, dfl) of the slab's planes from the marker with its halo
    planes (all ``[X+2, Y, Z]``; the results' halo planes are 0: the caller
    fills dfl's from the neighbours)."""
    shape = _slab_shape(marker, "marker")
    if not marker.is_cuda:
        diag = diag_coefficients(marker)
        dfl = torch.where(marker == CELL_FLUID, torch.where(diag > 0.0, diag, 1.0), 0.0)
        return _pad(_core(diag)), _pad(_core(dfl))
    cuda.require(marker, torch.int8, tuple(marker.shape), "pcg slab marker")
    diag = torch.zeros(marker.shape, dtype=torch.float32, device=marker.device)
    dfl = torch.zeros_like(diag)
    P = cuda.ptr
    _call("pcg_setup_launch", "pcg_slab", P(marker), P(diag), P(dfl), 1, *shape, cuda.stream())
    return diag, dfl


def slab_init(pinit, rhs, diag, dfl):
    """-> (p, r): p0 = F p_init and r0 = F (rhs - A p0) on the slab's planes
    (``pinit`` and ``dfl`` with their halo planes; the results' are 0)."""
    shape = _slab_shape(dfl, "dfl")
    if not rhs.is_cuda:
        fluid, nbr_pos, nbr_neg = _slab_ops(dfl)
        p = torch.where(fluid, pinit, 0.0)
        r = torch.where(fluid, rhs - apply_A(p, fluid, diag, nbr_pos, nbr_neg), 0.0)
        return _pad(_core(p)), _pad(_core(r))
    _require(((pinit, "pinit"), (rhs, "rhs"), (diag, "diag"), (dfl, "dfl")), torch.float32, tuple(dfl.shape), "init")
    p, r = torch.zeros_like(dfl), torch.zeros_like(dfl)
    P = cuda.ptr
    _call("pcg_init_launch", "pcg_slab", P(pinit), P(rhs), P(diag), P(dfl), P(p), P(r), *shape, cuda.stream())
    return p, r


def slab_k1(z, s, it, scal, diag, dfl, As, part) -> None:
    """The k1 pass on the slab. ``s`` is a pair of grids (two tensors, or a
    ``[2, X+2, Y, Z]`` tensor): s_old is s[0] when ``it`` (a 0-d device
    int32, or a host int) is even, s[1] when it is odd; into the other goes
    s = z + beta s_old on every plane, halo planes included. As = A s on the
    slab's planes; the partials of s.As into ``part`` (``slab_partials``). z
    and s_old need their halo planes."""
    shape = _slab_shape(z, "z")
    if not z.is_cuda:
        s_old, s_new = _older_newer(s, it)
        fluid, nbr_pos, nbr_neg = _slab_ops(dfl)
        s_new.copy_(z + scal[BETA] * s_old)
        full = apply_A(s_new, fluid, diag, nbr_pos, nbr_neg)
        _core(As).copy_(_core(full))
        part.copy_(torch.sum(_core(s_new * full)).reshape(1))
        return
    _require(((z, "z"), (s[0], "s[0]"), (s[1], "s[1]"), (diag, "diag"), (dfl, "dfl"), (As, "As")),
             torch.float32, tuple(z.shape), "k1")
    cuda.require(scal, torch.float32, (4,), "pcg scalars")
    cuda.require(part, torch.float32, (num_partials(shape),), "pcg slab k1 partials")
    P = cuda.ptr
    _call("pcg_k1_launch", "pcg_slab", P(z), P(s[0]), P(s[1]), *_parity(it), P(scal), P(diag), P(dfl), P(As),
          P(part), 1, *shape, cuda.stream())


def slab_k2(p, r, s, it, As, part, scal, dfl, z, part_zr, part_max) -> None:
    """The k2 pass on the slab: alpha = sigma / (the ordered sum of the
    all-reduced k1 partials ``part`` +- 1e-10) into scal[ALPHA], or 0 with
    ``part`` None (the start's z0 pass); p += alpha s (the slab's planes, in
    place) with s the newer of the pair ``s``; r = r_old - alpha As from the
    older of the pair ``r`` into the newer (every plane, halo planes
    included); z = K K^T r into ``z`` (the slab's planes); the partials of
    z.r and max|r| into ``part_zr`` and ``part_max``. Pairs and ``it`` as
    ``slab_k1``'s; r_old, As and dfl need their halo planes."""
    shape = _slab_shape(dfl, "dfl")
    if not dfl.is_cuda:
        r_old, r_new = _older_newer(r, it)
        s_new = _older_newer(s, it)[1]
        fluid, nbr_pos, nbr_neg = _slab_ops(dfl)
        scal[ALPHA] = _alpha(part, scal)
        alpha = scal[ALPHA]
        _core(p).copy_(_core(p) + alpha * _core(s_new))
        r_new.copy_(r_old - alpha * As)
        # dfl is dsafe on fluid cells, the only cells whose t the sweep divides
        full = precondition(r_new, fluid, dfl, nbr_pos, nbr_neg)
        _core(z).copy_(_core(full))
        part_zr.copy_(torch.sum(_core(full * r_new)).reshape(1))
        part_max.copy_(torch.max(torch.abs(_core(r_new))).reshape(1))
        return
    _require(((p, "p"), (r[0], "r[0]"), (r[1], "r[1]"), (s[0], "s[0]"), (s[1], "s[1]"), (As, "As"), (dfl, "dfl"),
              (z, "z")), torch.float32, tuple(dfl.shape), "k2")
    cuda.require(scal, torch.float32, (4,), "pcg scalars")
    for t, what in ((part_zr, "z.r"), (part_max, "max")):
        cuda.require(t, torch.float32, (num_partials(shape),), f"pcg slab k2 {what} partials")
    if part is not None:
        cuda.require(part, torch.float32, (part.numel(),), "pcg slab k2 s.As partials")
    P = cuda.ptr
    _call("pcg_k2_launch", "pcg_slab", P(p), P(r[0]), P(r[1]), P(s[0]), P(s[1]), *_parity(it), P(As),
          None if part is None else P(part), 0 if part is None else part.numel(), P(scal), P(dfl), P(z), P(part_zr),
          P(part_max), 1, *shape, cuda.stream())


def slab_tail(part_zr, part_max, scal, first: bool = False, it=None, go=None, tol: float = 0.0, max_iter: int = 0,
              freq: int = 1) -> None:
    """After k2's (all-reduced) partials: sigma' = z.r and err = max|r| (the
    ordered sums), beta = sigma' / (sigma +- 1e-10) (0 if ``first``), sigma
    = sigma'. With ``it`` and ``go`` (0-d int32s) also the loop predicate
    after iteration ``it``, which is incremented in place: go = 1 unless the
    iteration checked (``it % freq == 0`` or ``it == max_iter - 1``) and err
    < tol, or it + 1 reaches max_iter: the JAX solver's ``cond`` after its
    ``body``. ``freq`` >= 1."""
    if not part_zr.is_cuda:
        sigma = torch.sum(part_zr)
        scal[BETA] = 0.0 if first else guarded_div(sigma, scal[SIGMA])
        scal[SIGMA] = sigma
        scal[ERR] = torch.max(part_max)
        if it is not None:
            check = (it % freq == 0) | (it == max_iter - 1)
            converged = check & (scal[ERR] < tol)
            it.add_(1)
            go.copy_(~converged & (it < max_iter))
        return
    cuda.require(scal, torch.float32, (4,), "pcg scalars")
    if it is not None:
        cuda.require(it, torch.int32, (), "pcg tail it")
        cuda.require(go, torch.int32, (), "pcg tail go")
    P = cuda.ptr
    _call("pcg_tail_launch", "pcg_slab", P(part_zr), part_zr.numel(), P(part_max), part_max.numel(), P(scal),
          int(first), None if it is None else P(it), None if go is None else P(go), tol, max_iter, freq,
          cuda.stream())
