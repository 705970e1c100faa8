"""The bytes each phase of one substep must move on the port's layout, and
the floor they set at the card's memory rate (the port's counterpart of
``scripts/bandwidth_model.py``, recounted).

    python -m blub_tpu_torch.probes.bandwidth_model X Y Z K [valid]

prints each ``ph_*`` phase's bytes and floor in ms at
``probes/timing.HBM_BYTES_PER_S``, their sum, and the PCG's bytes per
iteration. ``valid`` (the valid slots, i.e. the particles) defaults to
``bench.py``'s seeding, ``core/seeding.add_fluid_cube`` from (1,1,1) to
(X/2, Y/2, Z-1) (968,688 at 128 64 64).

The layout. The table is posq int32[K,2,X,Y,Z] plus dyn int32[K,6,X,Y,Z],
32 B a slot, with no z lane padding; grids are f32 and the marker int8. A
table sweep reads the 4-byte valid word of every slot and the other words
it needs of the valid slots only (``table_in``; the script guessed an
upper-slot occupancy instead). A table is written in full (empty slots are
zeros). Between the two packs of a rebin the table has k_mid = K +
``sim/step_dense.stage_slack`` slots. G2P and the x pack are one kernel a
phase (``ops/advect_pack.py``), the y and z packs one launch
(``rebin.pack_yz``). Each function gives (bytes, f32 operations) of one
call, each input read once and each output written once, the operations
counted on the run's valid slots (or fluid cells and iterations): the
bounds of ``chip_smoke.py``'s kernel rows. A solve is counted once
through (its inputs read and its pressure written once: the persistent
kernel keeps the rest on the chip); ``pcg_iteration`` gives the passes'
bytes at every iteration beside it.

``phase_bytes`` is keyed by ``step_core``'s ``record_function`` names. The
dense glue between the kernels is counted as if each phase were one fused
pass over its grids. The script's phases map to these: ``ph_p2g`` ->
``ph_p2g`` + ``ph_marker`` (the marker and the normalized velocities),
``ph_grid`` -> ``ph_div_rhs``, ``ph_pcg_vel`` -> ``ph_pcg_vel``, ``ph_fix``
-> ``ph_gridfix_vel``, ``ph_advect`` -> ``ph_advect``, ``ph_rebin2`` ->
``ph_rebin2``, ``ph_density`` -> ``ph_p2g_density`` + ``ph_den_rhs``,
``ph_pcg_den`` -> ``ph_pcg_den``, ``ph_change`` -> ``ph_gridfix_den``,
``ph_correct`` -> ``ph_correct``, ``ph_rebin1`` -> ``ph_rebin1``. One valid
count serves every phase: a substep drops a few tens of particles of a
million.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, Tuple

from ..core.seeding import add_fluid_cube
from ..sim.slot_major import NUM_DYN, NUM_POSQ
from ..sim.step_dense import stage_slack
from .timing import HBM_BYTES_PER_S

SLOT_WORDS = NUM_POSQ + NUM_DYN  # 8 int32 words a slot
F32, I8 = 4, 1
PHASES = ("ph_p2g", "ph_marker", "ph_div_rhs", "ph_pcg_vel", "ph_gridfix_vel", "ph_advect", "ph_rebin2",
          "ph_p2g_density", "ph_den_rhs", "ph_pcg_den", "ph_gridfix_den", "ph_correct", "ph_rebin1")

Cost = Tuple[int, int]  # (bytes, f32 operations)


def table_in(k_in: int, valid: int, channels: int, cells: int) -> int:
    """Bytes a table sweep reads: the valid word of each of k_in slots a
    cell, and the other ``channels`` - 1 words of the valid slots only."""
    return F32 * k_in * cells + F32 * (channels - 1) * valid


def table_out(k_out: int, cells: int, words: int = SLOT_WORDS) -> int:
    """Bytes of a k_out-slot table (``words`` int32 a slot) written in full."""
    return F32 * words * k_out * cells


# Operations per valid slot (or fluid cell). p2g: a particle reaches 8
# nodes of each of the 3 face grids, each ~11 operations (weight, APIC value
# w*(v + C.d), two sums), plus ~20 to decode it; in density mode 8 nodes x 3
# + 1 count + decode. pcg: one iteration on a fluid cell, ~30 (7-point A s,
# the Incomplete-Poisson K K^T r, three axpys, two dot products, max|r|);
# its passes alone 15 (k1) + 30 (k2). g2p: advect ~600 (4 RK probes of 3
# trilinear face reads and the APIC affine field), ~730 with solids (escape,
# penetration, push), correct ~200. gridfix: ~12 a face of each call.
OPS_P2G, OPS_P2G_DENSITY = 280, 30
OPS_PCG, OPS_PCG_PASSES = 30, 15 + 30
OPS_ADVECT, OPS_ADVECT_SOLIDS, OPS_CORRECT = 600, 730, 200
OPS_GRIDFIX = 3 * 12


def p2g_velocity(k: int, cells: int, valid: int) -> Cost:
    """The velocity P2G: the 8 words of the valid slots in, 7 f32 channels
    (3 weight sums, 3 velocity sums, the fluid count) out."""
    return table_in(k, valid, SLOT_WORDS, cells) + 7 * F32 * cells, valid * OPS_P2G


def p2g_density(k: int, cells: int, valid: int) -> Cost:
    """The density P2G: the 2 posq words of the valid slots in, density and
    fluid count out."""
    return table_in(k, valid, NUM_POSQ, cells) + 2 * F32 * cells, valid * OPS_P2G_DENSITY


def p2g(k: int, cells: int, valid: int, valid_den: int) -> Cost:
    """The p2g row: both calls of a substep."""
    return _sum(p2g_velocity(k, cells, valid), p2g_density(k, cells, valid_den))


def pcg_solve(cells: int, iterations: int = 0, fluid: int = 0) -> Cost:
    """One solve once through: rhs, initial pressure and marker in, pressure
    out; ``iterations`` on ``fluid`` cells for the operations."""
    return cells * (F32 + F32 + I8 + F32), iterations * fluid * OPS_PCG


def pcg(cells: int, iterations: Iterable[int], fluid: Iterable[int]) -> Cost:
    """The pcg row: a substep's solves (one per entry of ``iterations`` and
    ``fluid``)."""
    return _sum(*(pcg_solve(cells, i, f) for i, f in zip(iterations, fluid)))


def pcg_iteration(cells: int) -> Cost:
    """The PCG passes at every iteration: k1 reads z, s, the diagonal and the
    fluid mask and writes s and As (24 B a cell), k2 reads As, p, r, the
    mask and writes p, r and z (32 B a cell)."""
    return (24 + 32) * cells, OPS_PCG_PASSES * cells


def gridfix_remove(cells: int, solids: bool = False) -> Cost:
    """Remove the pressure gradient and extrapolate: 3 face grids, pressure,
    marker (and 3 solid-velocity grids) in, 3 face grids out."""
    extra = 3 * F32 * cells if solids else 0
    return cells * (3 * F32 + F32 + I8 + 3 * F32) + extra, cells * OPS_GRIDFIX


def gridfix_change(cells: int) -> Cost:
    """The position change and its extrapolation: pressure and marker in, 3
    face grids out."""
    return cells * (F32 + I8 + 3 * F32), cells * OPS_GRIDFIX


def gridfix(cells: int) -> Cost:
    """The gridfix row: both calls of a substep."""
    return _sum(gridfix_remove(cells), gridfix_change(cells))


def g2p_advect(k: int, cells: int, valid: int, solids: bool = False) -> Cost:
    """G2P advect alone (``g2p.cu``, off the main path): posq's 2 words of
    the valid slots, 3 face grids (and occupancy and 3 solid-velocity grids)
    in, posq and dyn of K slots out."""
    extra = 4 * F32 * cells if solids else 0
    return (table_in(k, valid, NUM_POSQ, cells) + 3 * F32 * cells + extra + table_out(k, cells),
            valid * (OPS_ADVECT_SOLIDS if solids else OPS_ADVECT))


def g2p_correct(k: int, cells: int, valid: int) -> Cost:
    """G2P correct alone: posq of the valid slots, 3 change grids and the
    marker in, posq of K slots out."""
    return (table_in(k, valid, NUM_POSQ, cells) + 3 * F32 * cells + I8 * cells + table_out(k, cells, NUM_POSQ),
            valid * OPS_CORRECT)


def g2p(k: int, cells: int, valid: int, valid_den: int) -> Cost:
    """The unfused g2p row: advect and correct."""
    return _sum(g2p_advect(k, cells, valid), g2p_correct(k, cells, valid_den))


def advect_pack(k: int, k_mid: int, cells: int, valid: int, solids: bool = False) -> Cost:
    """G2P advect fused with the x pack: advect's reads and the k_mid-slot
    table written once."""
    extra = 4 * F32 * cells if solids else 0
    return (table_in(k, valid, NUM_POSQ, cells) + 3 * F32 * cells + extra + table_out(k_mid, cells),
            valid * (OPS_ADVECT_SOLIDS if solids else OPS_ADVECT))


def correct_pack(k: int, k_mid: int, cells: int, valid: int) -> Cost:
    """G2P correct fused with the x pack: the 8 words of the valid slots (dyn
    is the payload it moves), 3 change grids and the marker in, the
    k_mid-slot table out."""
    return (table_in(k, valid, SLOT_WORDS, cells) + 3 * F32 * cells + I8 * cells + table_out(k_mid, cells),
            valid * OPS_CORRECT)


def pack(k_in: int, k_out: int, cells: int, valid: int) -> Cost:
    """A pack (the x pack, or the y + z pack in one launch): the input
    table's valid slots in, the k_out-slot table out; no arithmetic."""
    return table_in(k_in, valid, SLOT_WORDS, cells) + table_out(k_out, cells), 0


def phase_bytes(grid_dim, k: int, valid: int, solids: bool = False) -> Dict[str, int]:
    """Bytes of each ``ph_*`` phase of one ``step_core`` substep on a table
    of ``k`` slots holding ``valid`` particles (``solids``: with a
    ``SolidState``)."""
    n = grid_dim[0] * grid_dim[1] * grid_dim[2]
    km = k + stage_slack(grid_dim, k)
    occ = F32 * n if solids else 0  # the occupancy grid
    solid_vel = 3 * F32 * n if solids else 0
    return {
        "ph_p2g": p2g_velocity(k, n, valid)[0],
        # the 7 channels (and the occupancy) in, the marker and 3 face grids out
        "ph_marker": 7 * F32 * n + occ + I8 * n + 3 * F32 * n,
        # 3 face grids, the marker (and 3 solid-velocity grids) in, the rhs out
        "ph_div_rhs": 3 * F32 * n + I8 * n + solid_vel + F32 * n,
        "ph_pcg_vel": pcg_solve(n)[0],
        "ph_gridfix_vel": gridfix_remove(n, solids)[0],
        "ph_advect": advect_pack(k, km, n, valid, solids)[0],
        "ph_rebin2": pack(km, k, n, valid)[0],
        "ph_p2g_density": p2g_density(k, n, valid)[0],
        # count and density (and the occupancy) in, the marker and rhs out
        "ph_den_rhs": 2 * F32 * n + occ + I8 * n + F32 * n,
        "ph_pcg_den": pcg_solve(n)[0],
        "ph_gridfix_den": gridfix_change(n)[0],
        "ph_correct": correct_pack(k, km, n, valid)[0],
        "ph_rebin1": pack(km, k, n, valid)[0],
    }


def floor_ms(nbytes: float) -> float:
    """ms to move ``nbytes`` at the card's data-sheet memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _sum(*costs: Cost) -> Cost:
    return sum(c[0] for c in costs), sum(c[1] for c in costs)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (4, 5):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    grid = tuple(int(v) for v in argv[:3])
    k = int(argv[3])
    valid = int(argv[4]) if len(argv) == 5 else \
        add_fluid_cube(grid, (1, 1, 1), (grid[0] // 2, grid[1] // 2, grid[2] - 1), 10**9).shape[0]
    n = grid[0] * grid[1] * grid[2]
    phases = phase_bytes(grid, k, valid)
    print(f"grid {grid[0]}x{grid[1]}x{grid[2]} K={k} k_mid={k + stage_slack(grid, k)} valid slots {valid} "
          f"({valid / (k * n):.1%} of {k * n}); floors at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    for name, b in phases.items():
        print(f"  {name:16s} {b:14d} B {b / 1e6:10.3f} MB {floor_ms(b):9.5f} ms")
    total = sum(phases.values())
    print(f"  {'substep':16s} {total:14d} B {total / 1e6:10.3f} MB {floor_ms(total):9.5f} ms")
    it = pcg_iteration(n)[0]
    print(f"  pcg per iteration (the passes, beside the once-through solve): {it} B, {floor_ms(it):.5f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
