"""The PCG passes alone (port of ``scripts/tpu_bench_pcg_kernels.py``, which
timed the blocked K1/K2 kernels standalone).

On the script's marker (a solid border, fluid on ``[1:X/2, 1:2Y/3, 1:-1]``,
air elsewhere) with a random fluid-masked ``r0`` from seed 0, it times the
two pass entry points of ``ops/csrc/pcg.cu`` through ``ops/pcg.k1_pass``
(k1: s, A s, the partials of s.As) and ``ops/pcg.k2_pass`` (k2, which sums
one partial per 256 cells for alpha in every block, and the tail: beta,
sigma, err): device time back to back (``timing.device_ms``, no host gaps)
and host-paced (CUDA events, one call after another). A whole
``solve_pressure`` (the persistent kernel) of ``max_num_iterations``
iterations (tolerance 0) on the same marker gives its device ms per
iteration; what it spends beyond k1 + k2 is the cost of an iteration's two
grid barriers and its reductions (setup, init and z0 spread over the
iterations included).

    python -m blub_tpu_torch.probes.pcg_passes [--shape X Y Z ...]

runs the highres (256x128x128) and dam (128x64x64) shapes by default.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.config import SolverConfig
from ..core.types import CELL_AIR, CELL_FLUID, CELL_SOLID
from ..ops import pcg
from . import timing
from .yz_floor import DAM_GRID

SHAPES = {"highres": (256, 128, 128), "dam": DAM_GRID}
REPS = 50
DT = np.float32(1.0 / 120.0)


def probe_marker(shape) -> np.ndarray:
    """int8 marker of the script: SOLID border, FLUID block, AIR elsewhere."""
    x, y, _ = shape
    mk = np.full(shape, CELL_AIR, np.int8)
    mk[0], mk[-1] = CELL_SOLID, CELL_SOLID
    mk[:, 0], mk[:, -1] = CELL_SOLID, CELL_SOLID
    mk[:, :, 0], mk[:, :, -1] = CELL_SOLID, CELL_SOLID
    mk[1 : x // 2, 1 : (2 * y) // 3, 1:-1] = CELL_FLUID
    return mk


def inputs(shape, device="cuda") -> dict:
    """Marker, setup (diag, dfl), r0, the scalars [sigma, alpha, beta, err]
    = [1, 0, 0.5, 0] and k2's s.As partials, one per 256 cells: 100 and
    zeros, so alpha = 0.01 (the script's alpha and beta)."""
    mk = probe_marker(shape)
    rng = np.random.default_rng(0)
    r0 = np.where(mk == CELL_FLUID, rng.standard_normal(shape).astype(np.float32), np.float32(0.0))
    marker = torch.from_numpy(mk).to(device)
    diag, dfl = pcg.pass_setup(marker)
    part = torch.zeros(pcg.num_partials(shape), dtype=torch.float32, device=device)
    part[0] = 100.0
    return {"shape": tuple(shape), "marker": marker, "diag": diag, "dfl": dfl,
            "r0": torch.from_numpy(r0).to(device), "part": part,
            "scal": torch.tensor([1.0, 0.0, 0.5, 0.0], dtype=torch.float32, device=device)}


def _k1(inp, plain=False):
    f = pcg.k1_pass_plain if plain else pcg.k1_pass
    s, As, part = f(inp["r0"], inp["r0"], inp["scal"], inp["diag"], inp["dfl"])
    return s, As, part.sum()


def _k2(inp, plain=False):
    f = pcg.k2_pass_plain if plain else pcg.k2_pass
    p, scal = inp["r0"].clone(), inp["scal"].clone()
    r, z = f(p, inp["r0"], inp["r0"], inp["r0"], inp["part"], scal, inp["diag"], inp["dfl"])
    return p, r, z, scal


def check(inp) -> float:
    """The setup (diag, dfl) against its plain version on the CPU, bit for
    bit; both passes against their plain versions on the same card: grids
    within 1e-6 of their scale (the same arithmetic: expected 0), the sum of
    k1's partials and the scalars within 1e-4 (block sums add in another
    order). -> max |difference| of the grids."""
    for got, ref, what in zip((inp["diag"], inp["dfl"]), pcg.pass_setup(inp["marker"].cpu()), ("diag", "dfl")):
        if not torch.equal(got.cpu(), ref):
            raise AssertionError(f"pcg setup {what} differs from its plain version")
    err = 0.0
    for name, fn in (("k1", _k1), ("k2", _k2)):
        got, ref = fn(inp), fn(inp, plain=True)
        for a, b in zip(got[:-1], ref[:-1]):
            e = (a - b).abs().max().item()
            if e > 1e-6 * max(b.abs().max().item(), 1.0):
                raise AssertionError(f"pcg {name} pass differs from its plain version by {e}")
            err = max(err, e)
        torch.testing.assert_close(got[-1], ref[-1], rtol=1e-4, atol=1e-6)
    return err


def measure(inp, reps: int = REPS) -> dict:
    """ms per call of k1 and k2 (device, back to back; and host-paced), their
    byte bounds, and the persistent solve's device ms per iteration at
    ``max_num_iterations`` iterations (tolerance 0) with what an iteration
    costs beyond the two passes: the two grid barriers and the reductions."""
    x, y, z = inp["shape"]
    n = x * y * z
    fluid = int((inp["marker"] == CELL_FLUID).sum().item())
    p = inp["r0"].clone()
    scal = inp["scal"].clone()

    def k1():
        pcg.k1_pass(inp["r0"], inp["r0"], scal, inp["diag"], inp["dfl"])

    zero = torch.zeros_like(inp["r0"])

    def k2():  # k2 and the tail; As = 0 keeps r, z.r and so alpha the same from call to call
        pcg.k2_pass(p, inp["r0"], inp["r0"], zero, inp["part"], scal, inp["diag"], inp["dfl"])

    res = {"shape": [x, y, z], "cells": n, "fluid_cells": fluid, "launch": pcg.pass_config(inp["shape"])}
    # k1 reads z, s_old, diag, dfl and writes s, As (~15 operations per
    # cell); k2 reads p, r_old, s, As, dfl and writes p, r, z (~30); the
    # partials (one float per 256 cells) add under 1 %
    for name, fn, nbytes, ops in (("k1", k1, 24 * n, 15 * n), ("k2", k2, 32 * n, 30 * n)):
        bms, by = timing.bound_ms(nbytes, ops)
        res[name] = {"device_ms": timing.device_ms(fn, reps), "host_paced_ms": timing.cuda_ms(fn, reps),
                     "bound_ms": bms, "bound_by": by}
    cfg = SolverConfig(error_tolerance=0.0)

    def solve():
        return pcg.solve_pressure(zero, inp["r0"], inp["marker"], cfg, DT)

    its = int(solve().stats.iterations)
    ms = timing.device_ms(solve, 5)
    per_it = ms / its
    passes = res["k1"]["device_ms"] + res["k2"]["device_ms"]
    res["solve"] = {"iterations": its, "device_ms": ms, "ms_per_iteration": per_it, "k1_plus_k2_device_ms": passes,
                    "beyond_passes_ms_per_iteration": per_it - passes, "blocks": pcg.solve_blocks(inp["shape"])}
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="the PCG passes alone on the card")
    ap.add_argument("--shape", type=int, nargs=3, action="append", help="X Y Z (repeatable)")
    args = ap.parse_args(argv)
    timing.require_card("pcg_passes")
    shapes = {f"{s[0]}x{s[1]}x{s[2]}": tuple(s) for s in args.shape} if args.shape else SHAPES
    res = {"card": timing.card_line()}
    for name, shape in shapes.items():
        inp = inputs(shape)
        res[name] = {"max_abs_err": check(inp), **measure(inp)}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
