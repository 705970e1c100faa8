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
of an iteration alone, one launch each (``probes/pcg_passes.py`` times
them), with plain versions built on ``sim/pressure.k1_step`` and
``k2_step``, the two halves of the plain solve's iteration.

``slab_*`` are the same passes on an x slab, the mesh's solve
(``parallel/sharded_sm.py::solve_pressure_sharded`` runs them with the halo
exchanges and all-reduces between them; counted as ``pcg_slab``): the pass
kernels' instantiation for grids with one halo plane on each side along x
(``[X+2, Y, Z]``, the slab's X planes between), which also carries s and r
onto the halo planes, and the reductions (``slab_alpha``, ``slab_beta``)
launched apart, after the caller has all-reduced the partials, and
``slab_continue``, the loop predicate after an iteration, computed on the
device (a CUDA WHILE node reads it). Their plain versions apply
``sim/pressure``'s functions to the extended grids and keep the slab's
planes; their partials are one sum per rank.
"""

from __future__ import annotations

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
    "pcg_k1_launch": [_P] * 8 + [_I, _I, _I, _I, _I, _P],
    "pcg_alpha_launch": [_P, _I, _P, _P],
    "pcg_k2_launch": [_P] * 10 + [_I, _I, _I, _I, _I, _I, _P],
    "pcg_beta_launch": [_P, _P, _I, _P, _I, _P],
    "pcg_continue_launch": [_P, _P, _P, _F, _I, _I, _P],
    "pcg_num_partials": [_I, _I, _I],
    "pcg_solve_partials": [_I, _I, _I],
}
SIGMA, ALPHA, BETA, ERR = 0, 1, 2, 3  # slots of the scalar vector
SOLVE_THREADS = 256  # threads per block of pcg_solve_kernel (THREADS in csrc/pcg.cu)
_WORK_GRIDS = 8  # scratch grids of a solve: diag, dfl, z, As, r x2, s x2
# kernels each C entry point launches: k1 + alpha and k2 + beta are two each
_KERNELS_PER_CALL = {"pcg_k1_launch": 2, "pcg_k2_launch": 2}
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


def _launch(lib, fn: str, shape, st, *args) -> None:
    err = getattr(lib, fn)(*args, *shape, st)
    for _ in range(_KERNELS_PER_CALL.get(fn, 1)):
        cuda.count_launch("pcg")
    cuda.check(lib, err, fn)


_WHOLE = (0, 1)  # (halo, reduce) of the probes' passes: the whole grid, each pass with its reduction


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
    _launch(cuda.library("pcg", _SIG), "pcg_setup_launch", shape, cuda.stream(), P(marker), P(diag), P(dfl), 0)
    return diag, dfl


def _plain_ops(diag, dfl):
    """(fluid, diag, nbr_pos, nbr_neg) of the plain steps, from the setup."""
    fluid = dfl > 0.0
    return (fluid, diag) + neighbor_masks(fluid)


def k1_pass_plain(z, s_old, scal, diag, dfl):
    s, As, scal[ALPHA] = k1_step(z, s_old, scal[BETA], scal[SIGMA], *_plain_ops(diag, dfl))
    return s, As


def k2_pass_plain(p, r_old, s, As, scal, diag, dfl, first: bool = False):
    p_new, r, z, sigma = k2_step(p, r_old, s, As, scal[ALPHA], *_plain_ops(diag, dfl))
    p.copy_(p_new)
    scal[BETA] = 0.0 if first else guarded_div(sigma, scal[SIGMA])
    scal[SIGMA] = sigma
    scal[ERR] = torch.max(torch.abs(r))
    return r, z


def k1_pass(z, s_old, scal, diag, dfl):
    """One k1 pass and its alpha reduction: s = z + beta s_old, As = A s,
    scal[ALPHA] = sigma / (s.As +- 1e-10). -> (s, As); ``scal`` (f32
    [sigma, alpha, beta, err]) is updated in place. The CUDA pass reads the
    neighbours of z and s_old unmasked, so both must vanish off fluid."""
    if not z.is_cuda:
        return k1_pass_plain(z, s_old, scal, diag, dfl)
    shape = tuple(z.shape)
    for t, what in ((z, "z"), (s_old, "s_old"), (diag, "diag"), (dfl, "dfl")):
        cuda.require(t, torch.float32, shape, f"pcg k1 {what}")
    cuda.require(scal, torch.float32, (4,), "pcg scalars")
    lib = cuda.library("pcg", _SIG)
    s, As = torch.empty_like(z), torch.empty_like(z)
    part = torch.empty(lib.pcg_num_partials(*shape), dtype=torch.float32, device=z.device)
    P = cuda.ptr
    _launch(lib, "pcg_k1_launch", shape, cuda.stream(), P(z), P(s_old), P(scal), P(diag), P(dfl), P(s), P(As),
            P(part), *_WHOLE)
    return s, As


def k2_pass(p, r_old, s, As, scal, diag, dfl, first: bool = False):
    """One k2 pass and its beta reduction: p += alpha s (in place), r =
    r_old - alpha As, z = K K^T r; scal gets beta (0 if ``first``), sigma =
    z.r and err = max|r|. -> (r, z)."""
    if not r_old.is_cuda:
        return k2_pass_plain(p, r_old, s, As, scal, diag, dfl, first)
    shape = tuple(r_old.shape)
    for t, what in ((p, "p"), (r_old, "r_old"), (s, "s"), (As, "As"), (dfl, "dfl")):
        cuda.require(t, torch.float32, shape, f"pcg k2 {what}")
    cuda.require(scal, torch.float32, (4,), "pcg scalars")
    lib = cuda.library("pcg", _SIG)
    r, z = torch.empty_like(r_old), torch.empty_like(r_old)
    n = lib.pcg_num_partials(*shape)
    pz = torch.empty(n, dtype=torch.float32, device=r_old.device)
    pm = torch.empty_like(pz)
    P = cuda.ptr
    _launch(lib, "pcg_k2_launch", shape, cuda.stream(), P(p), P(r_old), P(s), P(As), P(scal), P(dfl), P(r), P(z),
            P(pz), P(pm), int(first), *_WHOLE)
    return r, z


# ---------------------------------------------------------------------------
# the passes on an x slab (the mesh's solve)


def _core(ext: torch.Tensor) -> torch.Tensor:
    return ext[1:-1]


def _pad(core: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(core, (0, 0, 0, 0, 1, 1))


def _slab_launch(fn: str, shape, *args) -> None:
    lib = cuda.library("pcg", _SIG)
    err = getattr(lib, fn)(*args, *shape, cuda.stream())
    cuda.count_launch("pcg_slab")
    cuda.check(lib, err, fn)


def _reduce_launch(fn: str, *args) -> None:
    lib = cuda.library("pcg", _SIG)
    err = getattr(lib, fn)(*args, cuda.stream())
    cuda.count_launch("pcg_slab")
    cuda.check(lib, err, fn)


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


def slab_partials(shape, device) -> torch.Tensor:
    """A buffer for a slab pass's partials: one per 256 cells of the slab on
    the card (the pass kernels' chunks), the rank's one sum on the CPU."""
    dev = torch.device(device)
    n = -(-int(shape[0]) * int(shape[1]) * int(shape[2]) // SOLVE_THREADS) if dev.type == "cuda" else 1
    return torch.zeros(n, dtype=torch.float32, device=dev)


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
    _slab_launch("pcg_setup_launch", shape, P(marker), P(diag), P(dfl), 1)
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
    _slab_launch("pcg_init_launch", shape, P(pinit), P(rhs), P(diag), P(dfl), P(p), P(r))
    return p, r


def slab_k1(z, s_old, scal, diag, dfl, s_new, As, part) -> None:
    """The k1 pass on the slab, into ``s_new`` (s = z + beta s_old on every
    plane, halo planes included) and ``As`` (A s on the slab's planes); the
    partials of s.As into ``part`` (``slab_partials``). z and s_old need
    their halo planes."""
    shape = _slab_shape(z, "z")
    if not z.is_cuda:
        fluid, nbr_pos, nbr_neg = _slab_ops(dfl)
        s_new.copy_(z + scal[BETA] * s_old)
        full = apply_A(s_new, fluid, diag, nbr_pos, nbr_neg)
        _core(As).copy_(_core(full))
        part.copy_(torch.sum(_core(s_new * full)).reshape(1))
        return
    _require(((z, "z"), (s_old, "s_old"), (diag, "diag"), (dfl, "dfl"), (s_new, "s_new"), (As, "As")),
             torch.float32, tuple(z.shape), "k1")
    cuda.require(scal, torch.float32, (4,), "pcg scalars")
    P = cuda.ptr
    _slab_launch("pcg_k1_launch", shape, P(z), P(s_old), P(scal), P(diag), P(dfl), P(s_new), P(As), P(part), 1, 0)


def slab_alpha(part, scal) -> None:
    """scal[ALPHA] = sigma / (s.As +- 1e-10), s.As the ordered sum of the
    (all-reduced) partials."""
    if not part.is_cuda:
        scal[ALPHA] = guarded_div(scal[SIGMA], torch.sum(part))
        return
    _reduce_launch("pcg_alpha_launch", cuda.ptr(part), part.numel(), cuda.ptr(scal))


def slab_k2(p, r_old, s, As, scal, dfl, r_new, z, part_zr, part_max) -> None:
    """The k2 pass on the slab: p += alpha s (the slab's planes, in place),
    r = r_old - alpha As into ``r_new`` (every plane, halo planes included),
    z = K K^T r into ``z`` (the slab's planes); the partials of z.r and
    max|r| into ``part_zr`` and ``part_max``. r_old, As and dfl need their
    halo planes."""
    shape = _slab_shape(r_old, "r_old")
    if not r_old.is_cuda:
        fluid, nbr_pos, nbr_neg = _slab_ops(dfl)
        alpha = scal[ALPHA]
        _core(p).copy_(_core(p) + alpha * _core(s))
        r_new.copy_(r_old - alpha * As)
        # dfl is dsafe on fluid cells, the only cells whose t the sweep divides
        full = precondition(r_new, fluid, dfl, nbr_pos, nbr_neg)
        _core(z).copy_(_core(full))
        part_zr.copy_(torch.sum(_core(full * r_new)).reshape(1))
        part_max.copy_(torch.max(torch.abs(_core(r_new))).reshape(1))
        return
    _require(((p, "p"), (r_old, "r_old"), (s, "s"), (As, "As"), (dfl, "dfl"), (r_new, "r_new"), (z, "z")),
             torch.float32, tuple(r_old.shape), "k2")
    cuda.require(scal, torch.float32, (4,), "pcg scalars")
    P = cuda.ptr
    _slab_launch("pcg_k2_launch", shape, P(p), P(r_old), P(s), P(As), P(scal), P(dfl), P(r_new), P(z), P(part_zr),
                 P(part_max), 0, 1, 0)


def slab_beta(part_zr, part_max, scal, first: bool = False) -> None:
    """From the (all-reduced) partials: sigma' = z.r, beta = sigma' / (sigma
    +- 1e-10) (0 if ``first``), sigma = sigma', err = max|r|."""
    if not part_zr.is_cuda:
        sigma = torch.sum(part_zr)
        scal[BETA] = 0.0 if first else guarded_div(sigma, scal[SIGMA])
        scal[SIGMA] = sigma
        scal[ERR] = torch.max(part_max)
        return
    _reduce_launch("pcg_beta_launch", cuda.ptr(part_zr), cuda.ptr(part_max), part_zr.numel(), cuda.ptr(scal),
                   int(first))


def slab_continue(it, go, scal, tol: float, max_iter: int, freq: int) -> None:
    """After iteration ``it`` (a 0-d int32, incremented in place): ``go``
    (0-d int32) = 1 unless the iteration checked (``it % freq == 0`` or ``it
    == max_iter - 1``) and scal[ERR] < tol, or it + 1 reaches max_iter: the
    JAX solver's ``cond`` after its ``body``. ``freq`` >= 1."""
    if not it.is_cuda:
        check = (it % freq == 0) | (it == max_iter - 1)
        converged = check & (scal[ERR] < tol)
        it.add_(1)
        go.copy_(~converged & (it < max_iter))
        return
    cuda.require(it, torch.int32, (), "pcg continue it")
    cuda.require(go, torch.int32, (), "pcg continue go")
    cuda.require(scal, torch.float32, (4,), "pcg scalars")
    _reduce_launch("pcg_continue_launch", cuda.ptr(it), cuda.ptr(go), cuda.ptr(scal), tol, max_iter, freq)
