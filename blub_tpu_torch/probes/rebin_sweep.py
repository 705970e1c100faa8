"""Cost of moving particles through a rebin (port of
``scripts/tpu_bench_rebin.py``).

Chains of ``jiggle`` + ``rebin.rebin_slot_major`` run back to back on the
dam table; the jiggle-only chain is subtracted, leaving the rebin's own
time. The movement amplitude sweeps from 0 (nothing moves: the copy-through
floor) to 1.9 cells (every particle a mover), for (s, slack) in (2, 4),
(2, 2), (1, 4), (1, 2). ``jiggle`` is plain PyTorch (it is XLA in JAX):
rel16 decode -> amp * sin(p * 17.17 + 3.7 p^2 + i) -> clip to [1.001,
dim - 1.001] -> quantize -> encode. The seeding puts a few particles below
1.001, so the sweep starts from the table clipped once (``jiggle`` at amp
0), on which amp 0 is a no-op. Per chain: net ms per rebin, lost, and the
invariants (count + lost == n0; at amp 0 the table comes back bit for
bit).

    python -m blub_tpu_torch.probes.rebin_sweep [--grid X Y Z] [--capacity K] [quick]

``quick`` runs only (2, the dam's stage slack) at amps 0, 0.3 and 1.9.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import rebin
from ..sim.slot_major import (
    BYTES_PER_SLOT,
    CH_XY,
    CH_ZV,
    cell_coord,
    pack_posq,
    pos_to_rel,
    quantize_pos,
    rel_to_pos,
    unpack_posq,
    valid_mask,
)
from . import timing
from .yz_floor import DAM_GRID, DAM_K, seeded_table

CHAIN = 20
AMPS = (0.0, 0.3, 1.0, 1.9)
QUICK_AMPS = (0.0, 0.3, 1.9)
CONFIGS = ((2, 4), (2, 2), (1, 4), (1, 2))


def jiggle(posq: torch.Tensor, i: int, amp: float) -> torch.Tensor:
    """A deterministic pseudo-random move of every valid particle by at most
    ``amp`` cells per axis, kept inside [1.001, dim - 1.001]."""
    grid = posq.shape[2:]
    rx, ry, rz, vbit = unpack_posq(posq[:, CH_XY], posq[:, CH_ZV])
    valid = vbit == 1
    rels = []
    for a, r in enumerate((rx, ry, rz)):
        cell = cell_coord(grid, a, posq.device)
        p = rel_to_pos(r, cell)
        d = amp * torch.sin(p * 17.17 + 3.7 * p * p + float(i))
        pq = quantize_pos(torch.clamp(p + d, 1.001, grid[a] - 1.001))
        rels.append(torch.where(valid, pos_to_rel(pq, cell), 0))
    return torch.stack(pack_posq(rels[0], rels[1], rels[2], vbit), dim=1)


def chain(posq, dyn, lost, amp: float, s: int, slack: int, n: int = CHAIN, with_rebin: bool = True):
    """``n`` rounds of jiggle (+ rebin) -> (posq, dyn, lost)."""
    for i in range(n):
        posq = jiggle(posq, i, amp)
        if with_rebin:
            posq, dyn, lost = rebin.rebin_slot_major(posq, dyn, s, slack, lost)
    return posq, dyn, lost


def check(posq, dyn, lost, s: int = 2, slack: int = 4, amp: float = 1.9) -> None:
    """One jiggled rebin on the card against the plain packs, bit for bit."""
    moved = jiggle(posq, 0, amp)
    got = rebin.rebin_slot_major(moved, dyn, s, slack, lost)
    k = posq.shape[0]
    p, d, _, _ = rebin.pack_plain(moved, dyn, 0, s, k + slack)
    p, d, _, _ = rebin.pack_plain(p, d, 1, s, k + slack)
    p, d, _, kept = rebin.pack_plain(p, d, 2, s, k)
    ref = (p, d, lost + (valid_mask(moved).sum(dtype=torch.int32) - kept))
    for a, b in zip(got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"rebin_slot_major s={s} slack={slack} amp={amp} differs from the plain packs")


def rebin_bytes(k: int, slack: int, cells: int, valid: int) -> int:
    """Bytes one rebin of ``valid`` particles must move: the x pack (k ->
    k + slack) and the fused y + z pack (k + slack -> k) each read the valid
    word of every input slot and the other 7 words of the valid ones, and
    write their output slots in full."""
    stages = ((k, k + slack), (k + slack, k))
    return sum(4 * k_in * cells + 28 * valid + 32 * k_out * cells for k_in, k_out in stages)


def sweep(posq, dyn, lost, quick: bool = False, dam_slack: int = 1, n: int = CHAIN) -> dict:
    """The timed sweep on CUDA tensors: ms per chain round, net of the
    jiggle-only chain (measured at amp 0.3; the jiggle's work does not
    depend on the amplitude), the bound of one rebin of the particles the
    chain kept, lost and the invariants. Raises if count + lost != n0 or
    amp 0 changes the table."""
    posq = jiggle(posq, 0, 0.0)  # into the clip box, where amp 0 moves nothing
    n0 = int(valid_mask(posq).sum().item()) + int(lost.item())
    jig = timing.cuda_ms(lambda: chain(posq, dyn, lost, 0.3, 2, 0, n, with_rebin=False), 1) / n
    rows = []
    configs = ((2, dam_slack),) if quick else CONFIGS
    for s, slack in configs:
        for amp in QUICK_AMPS if quick else AMPS:
            out = []
            gross = timing.cuda_ms(lambda: out.append(chain(posq, dyn, lost, amp, s, slack, n)), 1) / n
            p, d, l_out = out[-1]
            count, lst = int(valid_mask(p).sum().item()), int(l_out.item())
            bms, by = timing.bound_ms(rebin_bytes(posq.shape[0], slack, p[0, 0].numel(), count), 0)
            row = {"s": s, "slack": slack, "amp": amp, "ms_gross": gross, "ms_net": gross - jig, "bound_ms": bms,
                   "bound_by": by, "lost": lst, "count_plus_lost_eq_n0": count + lst == n0}
            if amp == 0.0:
                row["identity"] = bool(torch.equal(p, posq) and torch.equal(d, dyn))
                if not row["identity"]:
                    raise AssertionError(f"rebin s={s} slack={slack} at amp 0 changed the table")
            if not row["count_plus_lost_eq_n0"]:
                raise AssertionError(f"rebin s={s} slack={slack} amp={amp}: count {count} + lost {lst} != {n0}")
            rows.append(row)
    return {"chain": n, "n0": n0, "jiggle_ms": jig, "rows": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="rebin cost against movement on the card")
    ap.add_argument("--grid", type=int, nargs=3, default=list(DAM_GRID))
    ap.add_argument("--capacity", type=int, default=DAM_K)
    ap.add_argument("quick", nargs="?", choices=["quick"], help="only (2, stage slack) at amps 0, 0.3, 1.9")
    args = ap.parse_args(argv)
    timing.require_card("rebin_sweep")
    grid, k = tuple(args.grid), args.capacity
    posq, dyn, lost = seeded_table(grid, k)
    check(posq, dyn, lost)
    slack = rebin.default_slack(k * BYTES_PER_SLOT * int(np.prod(grid)), k)
    res = {"card": timing.card_line(), "grid": list(grid), "capacity": k,
           **sweep(posq, dyn, lost, quick=args.quick is not None, dam_slack=slack)}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
