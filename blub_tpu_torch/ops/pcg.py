"""PCG pressure solve: the pair of CUDA passes of ``csrc/pcg.cu`` (port of
``blub_tpu/ops/pallas_pcg.py::_kernel`` and
``blub_tpu/ops/pallas_pcg_blocked.py::_k1_kernel``/``_k2_kernel``, which
compute one solve).

The plain version is ``sim/pressure.solve_pressure_plain``. The kernel solve
runs the same iteration with the loop on the host: four launches per
iteration, scalars on the device, and one 4-byte read of max|r| at each
iteration the check rule names (``i % freq == 0 or i == max_iter - 1``), so
iteration counts follow the rule exactly.

``pass_setup``, ``k1_pass`` and ``k2_pass`` run the setup and the two passes
of an iteration alone (``probes/pcg_passes.py`` times them), with plain
versions built on ``sim/pressure.k1_step`` and ``k2_step``, the two halves
of the plain solve's iteration.
"""

from __future__ import annotations

import torch

from ..core.config import SolverConfig
from ..core.types import CELL_FLUID, SolverStats
from ..sim.pressure import (
    PressureSolveResult,
    diag_coefficients,
    guarded_div,
    is_check_iteration,
    k1_step,
    k2_step,
    neighbor_masks,
    solve_pressure_plain,
    solve_tolerance,
)
from . import cuda

_P, _I = cuda.P, cuda.I
_SIG = {
    "pcg_setup_launch": [_P, _P, _P, _I, _I, _I, _P],
    "pcg_init_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "pcg_k1_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "pcg_k2_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "pcg_num_partials": [_I, _I, _I],
}
SIGMA, ALPHA, BETA, ERR = 0, 1, 2, 3  # slots of the scalar vector
# kernels each C entry point launches: k1 + alpha and k2 + beta are two each
_KERNELS_PER_CALL = {"pcg_k1_launch": 2, "pcg_k2_launch": 2}


def solve_pressure(
    initial_pressure: torch.Tensor, rhs: torch.Tensor, marker: torch.Tensor,
    config: SolverConfig, dt,
) -> PressureSolveResult:
    """PCG solve of A p = rhs on fluid cells (plain version for CPU tensors,
    the CUDA passes for CUDA tensors)."""
    if not rhs.is_cuda:
        return solve_pressure_plain(initial_pressure, rhs, marker, config, dt)
    shape = tuple(rhs.shape)
    x, y, z = shape
    cuda.require(rhs, torch.float32, shape, "pcg rhs")
    cuda.require(initial_pressure, torch.float32, shape, "pcg initial pressure")
    cuda.require(marker, torch.int8, shape, "pcg marker")
    lib = cuda.library("pcg", _SIG)
    st = cuda.stream()
    dev = rhs.device
    nparts = lib.pcg_num_partials(x, y, z)

    def grid():
        return torch.empty(shape, dtype=torch.float32, device=dev)

    diag, dfl, p, zv, As = grid(), grid(), grid(), grid(), grid()
    r = [grid(), grid()]
    s = [torch.zeros(shape, dtype=torch.float32, device=dev), grid()]
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)
    scal = torch.zeros(4, dtype=torch.float32, device=dev)  # alpha = 0 for the first z
    part = [torch.empty(nparts, dtype=torch.float32, device=dev) for _ in range(3)]

    def launch(fn, *args):
        _launch(lib, fn, shape, st, *args)

    P = cuda.ptr
    launch("pcg_setup_launch", P(marker), P(diag), P(dfl))
    launch("pcg_init_launch", P(initial_pressure), P(rhs), P(diag), P(dfl), P(p), P(r[0]))
    # z0 = M^-1 r0 and sigma0 = z0.r0: the update pass with alpha = 0
    launch("pcg_k2_launch", P(p), P(r[0]), P(zero), P(zero), P(scal), P(dfl), P(r[1]), P(zv),
           P(part[0]), P(part[1]), 1)
    cur_r, cur_s = 1, 0
    tol = solve_tolerance(config, dt)
    i = 0
    while i < config.max_num_iterations:
        launch("pcg_k1_launch", P(zv), P(s[cur_s]), P(scal), P(diag), P(dfl), P(s[1 - cur_s]), P(As),
               P(part[2]))
        cur_s = 1 - cur_s
        launch("pcg_k2_launch", P(p), P(r[cur_r]), P(s[cur_s]), P(As), P(scal), P(dfl), P(r[1 - cur_r]),
               P(zv), P(part[0]), P(part[1]), 0)
        cur_r = 1 - cur_r
        check = is_check_iteration(i, config)
        i += 1
        if check and scal[ERR].item() < tol:
            break
    stats = SolverStats(error=scal[ERR] * float(dt), iterations=i)
    return PressureSolveResult(pressure=p, stats=stats)


def _launch(lib, fn: str, shape, st, *args) -> None:
    err = getattr(lib, fn)(*args, *shape, st)
    for _ in range(_KERNELS_PER_CALL.get(fn, 1)):
        cuda.count_launch("pcg")
    cuda.check(lib, err, fn)


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
    _launch(cuda.library("pcg", _SIG), "pcg_setup_launch", shape, cuda.stream(), P(marker), P(diag), P(dfl))
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
            P(part))
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
            P(pz), P(pm), int(first))
    return r, z
