"""Floor of a y+z rebin sweep on the card (port of
``scripts/tpu_bench_yz_floor.py``: ``_variant_kernel`` :60, ``pallas_call``
:174).

The pack's time rides on a floor of bytes: a y+z rebin reads the table twice
and writes it twice. Each variant below computes what one mode of the TPU
probe computed, on the k_in-slot input of a y stage (the K + stage-slack
buffer the x pack leaves; its slack slots are empty):

  read           the window a y-stage pack reads (valid word of every slot,
                 the rest of the valid slots, the valid/rel words of the
                 +-s y neighbours) -> one int32 per (x, 4-row y tile): the
                 wrapping sum of the words read (TPU mode ``dma_in``);
                 ``csrc/yz_floor.cu``'s ``read_kernel`` streams the table
                 once and adds each row's neighbour terms into the tiles
                 within s of it (counted ``yz_floor_read``)
  zeros          the same reads, then the k_out-slot output as exact zeros
                 (``dma_only``)
  zeros_ungated  every word of every slot of the window read, then zeros
                 (``dma_only!g`` and ``dma_1``: the count of TPU DMA starts
                 has no analogue on the card, the function is the same)
  copy           output slot q = input slot q for q < k_out (``copy``)
  full           ``ops/rebin.rebin_yz`` on the table: the y and the z pack,
                 one launch of ``pack.cu``'s fused ``pack_yz_kernel``
                 (``full amp=0``)

``run`` launches the kernel (``pack.cu`` for ``full``) for CUDA tensors and
takes the plain version for CPU tensors (on the card every variant takes
Y % 4 == 0, and 0 < k_out <= k_in; ``read`` zeroes its output with
``torch.zeros`` and the kernel adds to it); ``run_plain`` is the plain version
on any device: the wrapping sum in int64 masked to 32 bits, ``torch.zeros``,
the valid-gated slot copy (``posq[:k_out].clone()`` on a table whose invalid
slots are zero) and ``pack_yz_plain`` (``pack_plain`` along y, then z).

    python -m blub_tpu_torch.probes.yz_floor [--grid X Y Z] [--capacity K] [--pad P] [--s S]

runs every variant at the dam table (128x64x64, 968,688 particles, K=14,
pad = the stage slack, 1; s = 2), checks it against its plain version and
prints ms (device time, and host-paced beside it), GB/s and bound of each,
next to the card's name and power limit (``--grid 256 128 128``: the
highres table).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.seeding import add_fluid_cube
from ..ops import cuda, rebin
from ..sim.gridops import shift
from ..sim.slot_major import BYTES_PER_SLOT, CH_XY, CH_ZV, NUM_DYN, NUM_POSQ, valid_mask
from ..sim.table import from_positions
from . import timing

VARIANTS = ("read", "zeros", "zeros_ungated", "copy", "full")
_MODES = {"read": 0, "zeros": 1, "zeros_ungated": 2, "copy": 3}
TILE_Y = 4  # y rows per output word of read (and per block of the other csrc/yz_floor.cu modes)
REPS = 20

# the dam cell's table (bench.py's defaults), shared by the probes and chip_smoke.py
DAM_GRID = (128, 64, 64)
DAM_K = 14

_P, _I = cuda.P, cuda.I
_SIG = {"yz_floor_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, cuda.U, _P]}


def seeded_table(grid=DAM_GRID, capacity: int = DAM_K, pad: int = 0, device="cuda"):
    """The dam seeding of ``grid`` (``add_fluid_cube(grid, (1,1,1), (X/2,
    Y/2, Z-1))``) as a slot-major table of ``capacity`` slots plus ``pad``
    empty ones: (posq, dyn, lost). dyn holds random bits on the valid slots
    (seed 0) and zeros elsewhere, as every table does."""
    x, y, z = grid
    pos = add_fluid_cube(grid, (1, 1, 1), (x // 2, y // 2, z - 1), 10**9)
    t = from_positions(pos, grid, capacity, device="cpu")
    rng = np.random.default_rng(0)
    bits = torch.from_numpy(rng.integers(-2**31, 2**31, t.dyn.shape, dtype=np.int64).astype(np.int32))
    dyn = torch.where(valid_mask(t.posq)[:, None], bits, 0)
    zp = torch.zeros((pad, NUM_POSQ) + tuple(grid), dtype=torch.int32)
    zd = torch.zeros((pad, NUM_DYN) + tuple(grid), dtype=torch.int32)
    posq, dyn = torch.cat([t.posq, zp]), torch.cat([dyn, zd])
    return posq.to(device).contiguous(), dyn.to(device).contiguous(), t.lost.to(device)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with the low 32 bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def window_sums(posq: torch.Tensor, dyn: torch.Tensor, s: int, gated: bool = True) -> torch.Tensor:
    """int64 [X, Y, Z]: per cell, the sum of the words its window holds (see
    the module docstring; ``gated``: payload words of valid slots only)."""
    valid = valid_mask(posq)
    vword = posq[:, CH_ZV].long()
    rel = posq[:, CH_XY].long()
    rest = rel + dyn.long().sum(1)
    if gated:
        rest = torch.where(valid, rest, 0)
        rel = torch.where(valid, rel, 0)
    own = (vword + rest).sum(0)
    nb = (vword + rel).sum(0)
    s = min(s, posq.shape[3] - 1)  # an offset of Y or more reaches no row
    for o in [o for o in range(-s, s + 1) if o]:
        own = own + shift(nb, (0, o, 0))
    return own


def run_plain(variant: str, posq, dyn, s: int, k_out: int):
    """The plain version of ``variant``: a tuple of tensors."""
    _, _, x, y, z = posq.shape
    if variant == "read":
        w = window_sums(posq, dyn, s)
        return (_wrap32(w.reshape(x, y // TILE_Y, TILE_Y * z).sum(-1)),)
    if variant in ("zeros", "zeros_ungated"):
        return (torch.zeros((k_out, NUM_POSQ, x, y, z), dtype=torch.int32, device=posq.device),
                torch.zeros((k_out, NUM_DYN, x, y, z), dtype=torch.int32, device=posq.device))
    if variant == "copy":
        v = valid_mask(posq[:k_out])[:, None]
        return torch.where(v, posq[:k_out], 0), torch.where(v, dyn[:k_out], 0)
    if variant == "full":
        return rebin.pack_yz_plain(posq, dyn, s, k_out)[:2]
    raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")


def run(variant: str, posq, dyn, s: int, k_out: int):
    """``variant`` on the table: the kernel for CUDA tensors (``pack.cu``'s
    fused y + z kernel for ``full``), the plain version for CPU tensors."""
    if variant == "full":
        p, d, _ = rebin.rebin_yz(posq, dyn, s, k_out, torch.zeros((), dtype=torch.int32, device=posq.device),
                                 torch.zeros((), dtype=torch.int32, device=posq.device))
        return p, d
    if not posq.is_cuda:
        return run_plain(variant, posq, dyn, s, k_out)
    if variant not in _MODES:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    k_in, _, x, y, z = posq.shape
    if y % TILE_Y or not 0 < k_out <= k_in:
        raise ValueError(f"yz_floor needs Y % {TILE_Y} == 0 and 0 < k_out <= k_in, got {tuple(posq.shape)}, {k_out}")
    cuda.require(posq, torch.int32, (k_in, NUM_POSQ, x, y, z), "yz_floor posq")
    cuda.require(dyn, torch.int32, (k_in, NUM_DYN, x, y, z), "yz_floor dyn")
    dev = posq.device
    if variant == "read":
        outs = (torch.zeros((x, y // TILE_Y), dtype=torch.int32, device=dev),)
        args = (cuda.ptr(outs[0]), None, None)
    else:
        outs = (torch.empty((k_out, NUM_POSQ, x, y, z), dtype=torch.int32, device=dev),
                torch.empty((k_out, NUM_DYN, x, y, z), dtype=torch.int32, device=dev))
        args = (None, cuda.ptr(outs[0]), cuda.ptr(outs[1]))
    lib = cuda.library("yz_floor", _SIG)
    err = lib.yz_floor_launch(cuda.ptr(posq), cuda.ptr(dyn), *args, k_in, k_out, x, y, z, s, _MODES[variant], 0,
                              cuda.stream())
    cuda.count_launch("yz_floor_read" if variant == "read" else "yz_floor")
    cuda.check(lib, err, f"yz_floor {variant}")
    return outs


def library_call(variant: str, posq, dyn, k_out: int):
    """The one PyTorch call computing the same function, where there is
    one: the slice clone for copy. The zeros variants have none: their work
    is to read the gated window and write the table, and ``torch.zeros``
    only writes (``measure`` times that floor as ``write_only_ms``)."""
    if variant == "copy":
        return posq[:k_out].clone(), dyn[:k_out].clone()
    return None


def bytes_moved(variant: str, posq, dyn, s: int, k_out: int) -> int:
    """Bytes the variant must move on this table: each word it needs read
    once (the valid word of every slot, the other 7 words of the valid ones;
    every word when ungated) and each output word written once. ``full``
    moves what ``zeros`` moves: its y stage's table is an intermediate,
    neither an input nor an output."""
    k_in, _, x, y, z = posq.shape
    n = x * y * z
    nv = int(valid_mask(posq).sum().item())
    nv_out = int(valid_mask(posq[:k_out]).sum().item())
    gated_in = 4 * k_in * n + 4 * 7 * nv
    table_out = 4 * k_out * 8 * n
    if variant == "read":
        return gated_in + 4 * x * (y // TILE_Y)
    if variant in ("zeros", "full"):
        return gated_in + table_out
    if variant == "zeros_ungated":
        return 4 * 8 * k_in * n + table_out
    return 4 * k_out * n + 4 * 7 * nv_out + table_out  # copy


def check(posq, dyn, s: int, k_out: int, variants=VARIANTS) -> dict:
    """Each variant against its plain version on the same CUDA tensors, bit
    for bit; raises on a difference. -> {variant: max |kernel - plain|}."""
    errs = {}
    for v in variants:
        got, ref = run(v, posq, dyn, s, k_out), run_plain(v, posq, dyn, s, k_out)
        for a, b in zip(got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"yz_floor {v} differs from its plain version")
        errs[v] = max(int((a.long() - b.long()).abs().max().item()) for a, b in zip(got, ref))
    return errs


def measure(posq, dyn, s: int, k_out: int, reps: int = REPS, variants=VARIANTS) -> dict:
    """Per variant: kernel ms, device time over ``reps`` launches back to
    back (``timing.device_ms``: no host gaps) and host-paced (CUDA events
    around the wrapper calls); GB/s of the bytes it must move at the device
    time; the bound; the plain version's ms (host-paced: it synchronises) and
    the library call's device ms (or None); for the zeros variants the
    write-only floor's device ms (``write_only_ms``)."""
    out = {}
    for v in variants:
        nbytes = bytes_moved(v, posq, dyn, s, k_out)
        ms = timing.device_ms(lambda: run(v, posq, dyn, s, k_out), reps)
        paced = timing.cuda_ms(lambda: run(v, posq, dyn, s, k_out), reps)
        plain = timing.cuda_ms(lambda: run_plain(v, posq, dyn, s, k_out), 1 if v == "full" else reps)
        lib = library_call(v, posq, dyn, k_out)
        lib_ms = None if lib is None else timing.device_ms(lambda: library_call(v, posq, dyn, k_out), reps)
        bms, by = timing.bound_ms(nbytes, 0)
        out[v] = {"ms": ms, "host_paced_ms": paced, "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6,
                  "bound_ms": bms, "bound_by": by, "plain_ms": plain, "library_ms": lib_ms}
        if v in ("zeros", "zeros_ungated"):
            # the write-only floor under them: torch.zeros of the output
            # table (the plain zeros variant with no valid slot read), which
            # skips the reads they exist to price
            out[v]["write_only_ms"] = timing.device_ms(lambda: run_plain("zeros", posq, dyn, 0, k_out), reps)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="floor of a y+z rebin sweep on the card")
    ap.add_argument("--grid", type=int, nargs=3, default=list(DAM_GRID))
    ap.add_argument("--capacity", type=int, default=DAM_K)
    ap.add_argument("--pad", type=int, default=None, help="empty slots on top (default: the stage slack)")
    ap.add_argument("--s", type=int, default=2)
    args = ap.parse_args(argv)
    timing.require_card("yz_floor")
    grid, k = tuple(args.grid), args.capacity
    pad = args.pad if args.pad is not None else rebin.default_slack(k * BYTES_PER_SLOT * int(np.prod(grid)), k)
    posq, dyn, _ = seeded_table(grid, k, pad)
    errs = check(posq, dyn, args.s, k)
    res = {"card": timing.card_line(), "grid": list(grid), "k_in": k + pad, "k_out": k, "s": args.s,
           "particles": int(valid_mask(posq).sum().item()), "max_abs_err": errs,
           "variants": measure(posq, dyn, args.s, k)}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
