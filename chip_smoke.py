"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]   # from the repository root; needs one CUDA card

With ``--out DIR`` the script also writes ``chip_smoke.json`` (every number it
prints) and the profiler's chrome traces (``<DIR>/<label>/blub.trace.json``
for dam_eager, dam_graphs, wave_eager, wave_graphs, mesh_dam and
mesh_dam_graphs) into DIR.

On the card the main path runs each frame as one launch of a CUDA graph that
picks the frame's n_sub on the card (``sim/step_dense.FrameGraphs``: the count,
then one IF node per n over that n's substep chain; the runner's first frame
eager, the second captures): the host reads nothing per frame. Launch counts
see the launches (each branch's tally times the frames it ran, counted on the
card). Phases, each of which raises on failure (exit code != 0):

  build    compile the eleven CUDA sources (one nvcc per source, in parallel);
           registers, spills and static shared memory of every kernel
           instantiation; the dynamic shared memory of the pack, p2g and
           fused G2P + x pack kernels (the last pack x's own block) and the
           block count of the cooperative PCG solve at the
           dam, wave and highres shapes; the blocks and dynamic shared memory
           of the PCG pass kernels at the dam and highres shapes
  (a) mid  each kernel against its plain PyTorch version on the card at a mid
           size (32x16x16, K=8), with the tolerance stated per kernel; the
           fused G2P + x pack kernels (advect_pack.cu) also against the two
           launches they replace (g2p.cu, then pack.cu's x pack): posq, dyn,
           max speed, dropped and kept; the solid specialisations of
           gridfix, G2P and the fused advect on the same table with a moving
           voxelized box (expected difference 0)
  wide     a 40-slot table through p2g, both packs and the fused kernels
           (their 64-bit mask instantiations) against the plain versions,
           bit for bit
  sdf      the scene load's mesh bake (ops/sdf.py, csrc/sdf.cu) for every
           scene file with solids at its real shape (the procedural bunny:
           588,059 points x 400 triangles), then icosphere_mesh(5) and (6)
           (20,480 and 81,920 triangles) at the bunny scene's points: the
           kernel against its plain version on the same CUDA tensors, bit
           for bit on every point ((6): every 16th); the share of the pairs
           the bake needs (sdf.pair_work); its ms (CUDA events, after a warm
           launch) and device ms, split into the Morton order and bounds
           and the kernel; the plain version's ms, the bound by operations
           of the needed pairs beside the brute-force one; the bounds, unite
           and keys kernels against their plain versions; fails if the
           kernel takes less than its bound
  (b) dam  the dam cell: 128x64x64, 968,688 particles, K=14, CFL 1.9, at most
           4 substeps per frame: 1 warm frame, then 63 timed frames (bench.py's
           64 frames from rest; its timed window, the last 32, is reported on
           its own), first eagerly ([dam eager], the reference), then the main
           path through multi_frame_dense's graph launches ([dam]); launch
           counts are reset just before each run and read just after (as for
           every later path, after its checks against the plain versions);
           lost beside the count these kernels' bits have always given
  graph dam  the two runs compared: the same lost, n_sub sequence and launch
           counts; ms/frame, frames/s, capture seconds, peak memory; then
           [graph branches]: each branch n = 1-4 forced by the max speed
           against eager_frame(..., n) from the same state, bit for bit, n_sub
           and launch counts too; before the traces, per branch, 16 forced
           launches against 16 of the branch's plain graph (the head's and
           the IF node's device cost) and the host ms of a launch ([graph
           branch cost]); after them, per branch, its body's nodes by kind,
           one forced launch under the profiler (its device nodes) and the
           host ms of a launch ([graph nodes], [graph launch])
  sync     one more dam substep (step_core) under PyTorch's sync debug mode:
           every call that waits for the card, by name; fails on one inside
           pcg.solve_pressure (the frame's max_speed read is the control)
  quality  sim/quality.physics_quality (bench.py's four physics numbers) of
           the dam's state after its frames, and likewise of the wave K=24's
           (after its 240 frames), the highres (after its 32) and the mesh
           dam's at world size 1 (after its graph frames): one density-mode
           p2g launch each, counted alone; the card's marker, interior
           count and drift against the plain version on a CPU copy of the
           table (marker and count exact, mean within 1e-3 of the plain
           mean + 1e-10, max within 1e-5); the mesh's (ShardedPhases: the
           slab, its halo, the sums all-reduced) against the single card's
           on gather_sm_state (count exact, drift within the same limit);
           reported, not gated on the physics
  fixed dt 8 steps of multi_step_dense (one graph launch a step, cfl 0: one
           branch) from a copy of the dam state against 8 eager step_dense
           calls, bit for bit (posq, dyn, lost, both pressures); then 8 more
           through the same runner: graph launches, ms per step both ways
  (a) dam  each kernel against its plain version on inputs taken from the
           dam state (the fused kernels also against the two launches), with
           its time per substep (CUDA events), its plain
           version's time and its bound (bytes over 3.35 TB/s or operations
           over 67 TFLOP/s f32, the larger, counted on this run's inputs:
           valid slots, fluid cells and PCG iterations); the PCG, g2p and
           gridfix also by device time back to back (the solves never
           synchronise); the fused kernels' device time in turns with the
           two launches they replace (two, fused, fused, two) and those
           launches' ms; the dense glue (marker, normalize_velocity, the
           divergence and density right-hand sides) on the card against the
           CPU, bit for bit
  graph sync  4 more dam frames through multi_frame_dense (and, after the
           wave runs, 4 wave frames through Scene.step) under the sync debug
           mode: no wait in any frame that launched the graph; the eager
           max-speed read after them is the positive control; a Scene's
           event waits (the host RING frames ahead) reported beside
  wave     the solids path: Scene("scenes/wavegenerator.json", capacity=24)
           on the card, 1 warm frame + 240 timed frames (2 s of simulated
           time), eagerly (Scene(graphs=False)) then through graph launches
           (the voxelization captured, every split's parameters uploaded per
           frame); [graph wave] compares lost, n_sub and launch counts;
           counts reset before and read after; every frame's velocity solve
           is held to its solver (finite, and over its tolerance only where
           it ran to its iteration cap; such frames are listed), at most 12
           frames over the tolerance and none over 3 times it; at frame 96
           (t = 0.8 s, the piston's deepest point) the shares of particles
           left of the piston face + 1.5 cells and inside the solid; then the
           graph run at capacity 16
           (app.py's default), reported without the lost budget
  (a) wave the solid specialisations against their plain versions on inputs
           replayed from the frame-96 state, with their times (also device
           time back to back) and bounds; the glue with solids on the card
           against the CPU
  highres  one CFL frame from rest at 256x128x128, 8,065,008 particles, K=14,
           CFL 1.5: the PCG solve against the plain solve, gridfix, G2P and
           the fused G2P + x pack kernels (advect_pack, correct_pack) against
           theirs bit for bit (the fused ones also against the two launches
           they replace), on the next substep's inputs, and the
           PCG's time per solve at that size; then 31 more frames through
           graph launches: conservation and no NaN checked, lost_pct reported
           against the 0.5 % budget, ms per frame without the graph's capture
           (beside the old figure with it); the fused kernels launched in the
           first frame and the graph frames, the unfused pair not; [quality]
  copy     the table round-trip probe (+1 over the dam table, with and
           without y halos, one launch per round trip) against posq + 1,
           dyn + 1 bit for bit: device and host-paced ms, GB/s and bound of
           all three (the plain call is the library call)
           (the dam table is seeded once for copy, yz_floor and the sweep)
  relops   the rel16 op probe against its plain version and numpy on the
           script's inputs, ties and extremes (bit for bit); its device and
           host-paced time, and its launch floor (the kernel on [1, 1])
  yz_floor the floor variants of a y+z rebin sweep on the dam table (K=14 +
           the stage slack), each against its plain version bit for bit;
           device and host-paced ms, GB/s and bound of each; read also on
           the highres table (256x128x128, K=14 + its slack; seeded there)
  rebin sweep  jiggle + rebin_slot_major chains on the dam table over
           amplitudes 0-1.9 and (s, slack): net ms per rebin, lost; count +
           lost == n0 everywhere, the table unchanged at amp 0; one rebin
           against the plain packs bit for bit
  pcg passes  the setup (bit for bit against the CPU), k1 and k2 (with its
           tail) alone at 256x128x128 and 128x64x64 against their plain
           versions, device and host-paced ms with bounds, their blocks and
           shared memory, and the persistent solve's device ms per iteration
           (32 iterations) with its cost beyond k1 + k2
  (d) ref  a small run (16x8x8, K=16 and K=40) on the card (graph launches)
           against the plain PyTorch path on the CPU: counts, lost and centre
           of mass
  trace    runtime/profiler.py over four frames of each cell, eager (device
           time per ph_* phase) and launched (the main path's device busy
           time per frame and idle share against the same frames' untraced
           ms/frame, taken before the profiler first runs; and the traced
           run's own idle share, from its first device activity to its last)
  bytes    the dam's and the wave's eager traces per ph_* phase: the bytes
           probes/bandwidth_model.phase_bytes gives it on the traced state,
           its device ms per substep, GB/s and share of 3.35 TB/s; the sum of
           the phases' floors per substep beside the graph frame's ms per
           substep (every bound of a kernel row comes from that module too)
  pcg history  the history instantiation of the PCG solve (pcg_solve_kernel
           <true>) on one substep's two solves at the dam shape (inside the
           (a) dam phase) and at highres (inside [highres]): the production
           solve's bits, the history against the plain version with history,
           device ms with and without the history
  render   SceneRenderer on the card at the dam state, 640x480, each fluid
           mode and one volume mode, against the plain (numpy) renderer on
           the same particles: test_render.py's image bounds (max 8 LSB,
           under 2 % of the pixels differ, 99th percentile 0); ms per frame
  app      blub_tpu_torch.app's main() for info, run --record-fps,
           screenshot (screen-space fluid), profile, profile --trace-phases
           and profile --solver-history on scenes/dam_halfhalf.json in a
           temporary directory: the PNGs decode; counts reset and read
           around each call (the history instantiation launches twice, in
           --solver-history)
  scenes   every scenes/*.json for a few frames through the app's run code
           (each Scene bakes its solids on the card): n0, lost, n_sub, ms
           per frame, start-up seconds and the bake's ms, then the bake
           replayed step by step (ms of the host grid, the upload, the bake
           on the card, the read back); count + lost == n0 and no NaN in
           every scene, one launch of each of the bake's four kernels per
           meshed solid, every bake under 1 s
  mesh     the mesh path (parallel/sharded_sm.py) on a one-rank NCCL group:
           the dam inputs (and the wave's, with solids) cut into n = 1, 2
           and 4 x-windows in this process (n = 1: the domain between
           halos, the windows the dam at world size 1 launches on), halos
           assembled locally, through the x_start variants of g2p and the x
           pack (on their reach) and of the fused kernels (on the fused
           phases' windows, also against the two x_start launches), p2g on
           extended windows and gridfix on slabs, each core against the
           whole-grid kernel's and each x_start call against its plain
           version, bit for bit, with ms per window against its bound; the
           mesh's PCG (the pcg.cu pass kernels on the slab) on the dam's two
           solves: pcg_solve_kernel's bits at world size 1 and held against
           the plain solve as [pcg] is, and its passes on n = 2 and 4
           windows bit for bit with the whole-grid passes
  mesh pcg graph  the same two solves captured as one chain, each loop a
           CUDA WHILE node with its all-reduces inside, launched twice: the
           eager slab solve's and pcg_solve_kernel's bits and iterations,
           the body's runs and nodes (k1, k2, the tail); ms per substep (the
           pcg_slab row) and per iteration, beside the passes' own bound,
           the eager slab solve's and pcg_solve_kernel's; on the velocity
           solve, k1, k2 and the tail alone and its iteration as one plain
           graph replay (the body without the WHILE node)
  mesh dam the dam at world size 1 (1 warm + 63 frames), eagerly (eager_frame
           with ShardedPhases: n_sub read on the host, each solve's
           predicate read per iteration): lost and n_sub must equal [dam
           eager]'s, conservation, no NaN, ms/frame, peak memory,
           collectives per substep; counts reset before and read after
  mesh graph dam  the same frames through frame_dense_sharded's graph
           launches (the main path of the mesh: n_sub and each solve's loop
           on the card): the eager mesh's final table, n_sub, each frame's
           PCG iterations, launch counts and collectives per substep, bit
           for bit; ms/frame with and without the capture, peak memory,
           nodes per branch and per loop body; then 4 more frames under the
           sync debug mode ([graph sync] mesh dam: no wait in a launched
           frame, the eager max-speed read as the positive control)
  mesh wave  8 frames of Scene(wavegenerator, capacity 24, mesh=1) eagerly
           (graphs=False) and through graphs ([mesh graph wave]): bit for
           bit, conservation, no NaN, the Scene's waits on its ring (the
           solids' window kernel); two ranks over NCCL only where the host
           has two cards (through graphs)

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from blub_tpu_torch.probes import bandwidth_model as bwm  # noqa: E402  (the port beside this script)
from blub_tpu_torch.probes.timing import (  # noqa: E402
    bound_ms, card_line, cuda_ms, device_ms,
)
from blub_tpu_torch.probes.yz_floor import DAM_GRID, DAM_K  # noqa: E402

DAM_CFL = 1.9
DAM_MAX_SUB = 4
TIMED_FRAMES = 63  # with the warm frame: bench.py's 64 frames from rest
BENCH_WINDOW = 32  # bench.py times the last 32 of them
TRACE_FRAMES = 4
GRAPH_SYNC_FRAMES = 4
LOST_BUDGET_PCT = 0.5
DAM_KERNELS = ("p2g", "pcg", "gridfix", "advect_pack", "correct_pack", "pack_yz")
# the unfused pair (g2p.cu, pack.cu's x pack): off the main path, which runs
# the fused kernels at every shape; held against their plain versions by
# check_g2p / check_pack and the mesh windows
UNFUSED_KERNELS = ("g2p", "g2p_solids", "pack", "g2p_xs", "g2p_solids_xs", "pack_xs")
# lost of the 64-frame dam run and of the wave at capacity 24 as every build
# of these kernels has given them since the density RHS divides truly, as
# JAX does (3480 and 2493 with the reciprocal before): the trajectories are
# chaotic, so a kernel whose bits moved shows here first
DAM_LOST_RECORDED = 3507
WAVE_LOST_RECORDED = 2736  # since G2P reads z as the JAX package does (2669 before)

WAVE_SCENE = "scenes/wavegenerator.json"
# capacity of the checked wave run: the JAX package's own piston test runs
# at 24 (tests/test_solids.py:124); at app.py's default of 16 the escape of
# swallowed particles and the dam break overflow the slots (6.2 % lost in 2 s,
# in the JAX algorithm's own trend too), so that run is reported, not held to
# the lost budget
WAVE_K = 24
WAVE_K_APP = 16
WAVE_FRAMES = 240  # timed, after one warm frame: 2 s of simulated time
WAVE_PROBE_FRAME = 96  # t = 0.8 s: the piston's deepest point
INSIDE_BUDGET = 0.02  # share of particles inside the solid (tests/test_solids.py:144)
# the wave's velocity solves: a solve stops under its tolerance or at its
# iteration cap. A few of the 241 frames end at the cap over the tolerance
# (3 at capacity 24, the worst at 2.09 times it); a solver that stops
# converging ends over it on most frames
WAVE_MAX_FRAMES_OVER_TOL = 12  # 5 % of the run's frames
WAVE_MAX_SOLVE_ERROR = 3.0  # times the tolerance, on any frame

HIGHRES_GRID = (256, 128, 128)
HIGHRES_K = 14
HIGHRES_CFL = 1.5
HIGHRES_FRAMES = 32  # the first from rest, the rest through graph replays

RENDER_SIZE = (640, 480)
RENDER_TEST_SIZE = (160, 120)  # tests/test_render.py's draw size, where its image bounds were set
RENDER_MODES = (("particles_velocity", "none"), ("particles_index", "none"), ("screen_space_fluid", "none"),
                ("none", "none"), ("none", "pressure_from_velocity"))
RENDER_REPS = 3
APP_SCENE = "scenes/dam_halfhalf.json"
SCENE_FRAMES = 4  # frames of every scene file through the app's run code
BAKE_LIMIT_S = 1.0  # a Scene's whole bake on the card (the bunny's took 38.0 s in numpy on the host)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# inputs


def phase_inputs(params, state, solids=None, keep_packs=True):
    """Replay one substep's phases on ``state`` (with ``solids``, a
    SolidState, or none) and keep each kernel's inputs."""
    from blub_tpu_torch.ops import g2p, gridfix, p2g, pcg, rebin
    from blub_tpu_torch.sim.dense_transfer import density_rhs_from_raw
    from blub_tpu_torch.sim.divergence import compute_divergence_rhs
    from blub_tpu_torch.sim.sm_phases import marker_from_counts
    from blub_tpu_torch.sim.step_dense import stage_slack

    g = params.grid_dim
    dt = np.float32(params.dt)
    t = state.table
    k = t.capacity
    k_mid = k + stage_slack(params.grid_dim, k)
    occ = solids.occupancy if solids is not None else None
    sv = solids.velocity if solids is not None else None
    acc = p2g.p2g(t.posq, t.dyn)
    marker = marker_from_counts(acc[6], g, occ)
    vel = p2g.normalize_velocity(acc, marker, params.gravity_grid, dt)
    rhs = compute_divergence_rhs(vel, marker, sv)
    res = pcg.solve_pressure(state.pressure_vel, rhs, marker, params.solver_vel, dt)
    velf = gridfix.gridfix_remove(vel, res.pressure, marker, sv)
    posq1, dyn1, _ = g2p.advect(t.posq, velf, dt, occ, sv)
    packs, yz = [], []  # the x pack's inputs, the fused y + z pack's

    def rebin_inputs(p, d, s):
        if keep_packs:
            packs.append((p, d, 0, s, k_mid))
        p, d, _, _ = rebin.pack(p, d, 0, s, k_mid)
        if keep_packs:
            yz.append((p, d, s, k))
        p, d, _ = rebin.pack_yz(p, d, s, k)
        return p, d

    p, d = rebin_inputs(posq1, dyn1, 2)
    dacc = p2g.p2g(p, None, density=True)
    marker2 = marker_from_counts(dacc[1], g, occ)
    den_rhs = density_rhs_from_raw(dacc[0], marker2, dt)
    res2 = pcg.solve_pressure(state.pressure_den, den_rhs, marker2, params.solver_den, dt)
    change = gridfix.gridfix_change(res2.pressure, marker2, dt)
    posq2 = g2p.correct(p, change, marker2)
    rebin_inputs(posq2, d, 1)
    return dict(
        table=t, posq_den=p, dyn_den=d, k_mid=k_mid, vel=vel, pvel=res.pressure, marker=marker, velf=velf,
        change=change,
        marker2=marker2, pcg=[(state.pressure_vel, rhs, marker, params.solver_vel),
                              (state.pressure_den, den_rhs, marker2, params.solver_den)],
        packs=packs, yz=yz, dt=dt, solids=solids,
    )


# ---------------------------------------------------------------------------
# kernel against plain


def check_p2g(inp):
    from blub_tpu_torch.ops import p2g

    t = inp["table"]
    err = 0.0
    for posq, dyn, density in ((t.posq, t.dyn, False), (inp["posq_den"], None, True)):
        got = p2g.p2g(posq, dyn, density)
        ref = p2g.p2g_plain(posq, dyn, density)
        err = max(err, (got - ref).abs().max().item())
        if not torch.equal(got, ref):
            raise AssertionError(f"p2g density={density} differs from the plain version by {err}")
    return err, "exact in both modes (same summation order and expressions, -fmad=false)"


def hold_pcg_against_plain(got, p0, rhs, marker, cfg, dt, what):
    """A solve's result against the plain solve: the iterations within one
    check window; against the plain solve run for exactly the solve's
    iteration count, the pressure within rtol 1e-4 + 1e-4 of max|p| and
    max|r| (after the last iteration, a check iteration of both runs) within
    1e-3; a solve that stopped early must have converged. -> max|dp|."""
    from blub_tpu_torch.sim.pressure import solve_pressure_plain

    its = int(got.stats.iterations)
    ref = solve_pressure_plain(p0, rhs, marker, cfg, dt)
    if abs(its - int(ref.stats.iterations)) > cfg.error_check_frequency:
        raise AssertionError(f"{what} iterations {its} vs plain {int(ref.stats.iterations)}")
    fixed = dataclasses.replace(cfg, max_num_iterations=its, error_tolerance=0.0)
    ref = solve_pressure_plain(p0, rhs, marker, fixed, dt)
    diff = (got.pressure - ref.pressure).abs()
    e = diff.max().item()
    scale = ref.pressure.abs().max().item()
    over = (diff - (1e-4 * ref.pressure.abs() + 1e-4 * scale)).max().item()
    if int(ref.stats.iterations) != its or over > 0:
        raise AssertionError(f"{what} pressure after {its} iterations differs by {e} (scale {scale})")
    ge, re = got.stats.error.item(), ref.stats.error.item()
    if abs(ge - re) > 1e-3 * re + 1e-3 * cfg.error_tolerance:
        raise AssertionError(f"{what} max|r|*dt {ge} vs plain {re} after {its} iterations")
    if its < cfg.max_num_iterations and not ge < cfg.error_tolerance:
        raise AssertionError(f"{what} stopped before max iterations without converging")
    return e


def check_pcg(inp):
    from blub_tpu_torch.ops import pcg

    err = 0.0
    for p0, rhs, marker, cfg in inp["pcg"]:
        got = pcg.solve_pressure(p0, rhs, marker, cfg, inp["dt"])
        err = max(err, hold_pcg_against_plain(got, p0, rhs, marker, cfg, inp["dt"], "pcg"))
    return err, ("iterations within one check window of the plain solve; against the plain solve run for the "
                 "kernel's iteration count, pressure within rtol 1e-4 + 1e-4 of max|p| and max|r| within 1e-3 "
                 "(dot products sum in another order)")


def check_gridfix(inp):
    from blub_tpu_torch.ops import gridfix
    from blub_tpu_torch.sim.density import position_change_field
    from blub_tpu_torch.sim.divergence import remove_divergence
    from blub_tpu_torch.sim.extrapolate import extrapolate_velocity

    err = 0.0
    m, m2 = inp["marker"], inp["marker2"]
    pairs = [
        (gridfix.gridfix_remove(inp["vel"], inp["pvel"], m),
         extrapolate_velocity(remove_divergence(inp["vel"], inp["pvel"], m), m)),
        (gridfix.gridfix_change(inp["pvel"], m2, inp["dt"]),
         extrapolate_velocity(position_change_field(inp["pvel"], m2, inp["dt"]), m2)),
    ]
    for got, ref in pairs:
        for a, b in zip(got, ref):
            err = max(err, (a - b).abs().max().item())
            if not torch.equal(a, b):
                raise AssertionError(f"gridfix differs from its plain version by {err}")
    return err, "bit for bit in both modes (the same arithmetic in the same order, -fmad=false)"


def _pos_diff_quanta(a, b):
    from blub_tpu_torch.sim.slot_major import unpack_posq

    ua, ub = unpack_posq(a[:, 0], a[:, 1]), unpack_posq(b[:, 0], b[:, 1])
    if not torch.equal(ua[3], ub[3]):
        raise AssertionError("g2p valid bits differ")
    return max((ua[i] - ub[i]).abs().max().item() for i in range(3))


def check_g2p(inp):
    """Advect and correct against their plain versions, bit for bit."""
    from blub_tpu_torch.ops import g2p

    t = inp["table"]
    rp, rd, rms = g2p.advect_plain(t.posq, inp["velf"], inp["dt"])
    cr = g2p.correct_plain(inp["posq_den"], inp["change"], inp["marker2"])
    gp, gd, gms = g2p.advect(t.posq, inp["velf"], inp["dt"])
    cp = g2p.correct(inp["posq_den"], inp["change"], inp["marker2"])
    q = max(_pos_diff_quanta(gp, rp), _pos_diff_quanta(cp, cr))
    words = int((gd != rd).sum().item())
    if not (torch.equal(gp, rp) and torch.equal(cp, cr) and words == 0 and gms.item() == torch.sqrt(rms).item()):
        raise AssertionError(f"g2p differs from its plain version: {q} position quanta, {words} dyn words, "
                             f"max speed {gms.item()} vs {torch.sqrt(rms).item()}")
    return q * 2.0 ** -13, "bit for bit: posq, dyn and max speed"


def check_pack(inp):
    from blub_tpu_torch.ops import rebin

    for posq, dyn, axis, s, k_out in inp["packs"]:
        got = rebin.pack(posq, dyn, axis, s, k_out)
        ref = rebin.pack_plain(posq, dyn, axis, s, k_out)
        for a, b in zip(got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"pack axis {axis} s {s} differs from the plain version")
    return 0.0, "bit for bit: placement, payload, dropped and kept counts"


def check_pack_yz(inp):
    """The fused kernel against pack_plain(y) then pack_plain(z), with both
    stages' counts; on the same inputs, the one-axis kernel along y and
    along z against the same plain packs."""
    from blub_tpu_torch.ops import rebin

    for posq, dyn, s, k_out in inp["yz"]:
        k_mid = posq.shape[0]
        ry = rebin.pack_plain(posq, dyn, 1, s, k_mid)
        rz = rebin.pack_plain(ry[0], ry[1], 2, s, k_out)
        got = rebin.pack_yz(posq, dyn, s, k_out)
        ref = (rz[0], rz[1], torch.stack([ry[2], ry[3], rz[2], rz[3]]))
        for a, b in zip(got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"pack_yz s {s} differs from the plain y then z packs")
        for (src_p, src_d), axis, k, r in (((posq, dyn), 1, k_mid, ry), ((ry[0], ry[1]), 2, k_out, rz)):
            if not all(torch.equal(a, b) for a, b in zip(rebin.pack(src_p, src_d, axis, s, k), r)):
                raise AssertionError(f"pack axis {axis} s {s} differs from the plain version")
    return 0.0, "bit for bit: placement, payload, y and z dropped and kept counts"


def fused_against_two_launches(inp, solids=None):
    """advect_pack.cu's fused kernels (advect with or without solids, and
    correct) against their plain versions (g2p's, then the x pack's) and
    the two launches they replace (g2p.cu, then pack.cu's x pack), bit for
    bit: posq_mid, dyn_mid, max speed, dropped and kept. -> (max position
    difference to the plain version in quanta, counts)."""
    from blub_tpu_torch.ops import advect_pack, g2p, rebin

    t, dt, k_mid = inp["table"], inp["dt"], inp["k_mid"]
    occ, sv = (solids.occupancy, solids.velocity) if solids is not None else (None, None)
    got = advect_pack.advect_pack(t.posq, inp["velf"], dt, occ, sv, k_mid, with_counts=True)
    ref = advect_pack.advect_pack_plain(t.posq, inp["velf"], dt, occ, sv, k_mid)
    p, d, ms = g2p.advect(t.posq, inp["velf"], dt, occ, sv)
    two = rebin.pack(p, d, 0, g2p.ADVECT_SHIFT, k_mid)
    two = (two[0], two[1], ms, torch.stack(two[2:]))
    q = _pos_diff_quanta(got[0], ref[0])
    name = "advect_pack" if solids is None else "advect_pack_solids"
    for what, other in (("its plain version", ref), ("g2p then pack x", two)):
        if not all(torch.equal(a, b) for a, b in zip(got, other)):
            raise AssertionError(f"{name} differs from {what}: {q} position quanta, max speed "
                                 f"{got[2].item()} vs {other[2].item()}, counts {got[3].tolist()} vs "
                                 f"{other[3].tolist()}")
    counts = {name: got[3].tolist()}
    if solids is None:
        args = (inp["posq_den"], inp["dyn_den"], inp["change"], inp["marker2"], k_mid)
        got = advect_pack.correct_pack(*args, with_counts=True)
        ref = advect_pack.correct_pack_plain(*args)
        two = rebin.pack(g2p.correct(*args[:1], *args[2:4]), args[1], 0, g2p.CORRECT_SHIFT, k_mid)
        two = (two[0], two[1], torch.stack(two[2:]))
        q = max(q, _pos_diff_quanta(got[0], ref[0]))
        for what, other in (("its plain version", ref), ("g2p then pack x", two)):
            if not all(torch.equal(a, b) for a, b in zip(got, other)):
                raise AssertionError(f"correct_pack differs from {what}: counts {got[2].tolist()} vs "
                                     f"{other[2].tolist()}")
        counts["correct_pack"] = got[2].tolist()
    return q, counts


def check_advect_pack(inp):
    q, counts = fused_against_two_launches(inp)
    return q * 2.0 ** -13, (f"bit for bit with the plain versions and the two launches: posq, dyn, max speed, "
                            f"dropped and kept {json.dumps(counts)}")


CHECKS = [("p2g", check_p2g), ("pcg", check_pcg), ("gridfix", check_gridfix), ("g2p", check_g2p),
          ("pack", check_pack), ("pack_yz", check_pack_yz), ("advect_pack", check_advect_pack)]


def check_all(inp, label, card):
    errs = {}
    for name, fn in CHECKS:
        err, tol = fn(inp)
        torch.cuda.synchronize()
        errs[name] = err
        log(f"[{label}] {name}: max_abs_err {err:.3g} ok ({tol}) [{card}]")
    return errs


def check_solids(inp, label, card):
    """The solid specialisations against their plain versions: gridfix
    remove with the solid velocity and G2P advect with occupancy, escape and
    push; bit for bit."""
    from blub_tpu_torch.ops import g2p, gridfix
    from blub_tpu_torch.sim.divergence import remove_divergence
    from blub_tpu_torch.sim.extrapolate import extrapolate_velocity

    sol, dt = inp["solids"], inp["dt"]
    m = inp["marker"]
    got = gridfix.gridfix_remove(inp["vel"], inp["pvel"], m, sol.velocity)
    ref = extrapolate_velocity(remove_divergence(inp["vel"], inp["pvel"], m, sol.velocity), m)
    gerr = max((a - b).abs().max().item() for a, b in zip(got, ref))
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"gridfix_solids differs from its plain version by {gerr}")
    t = inp["table"]
    gp, gd, gms = g2p.advect(t.posq, inp["velf"], dt, sol.occupancy, sol.velocity)
    rp, rd, rms = g2p.advect_plain(t.posq, inp["velf"], dt, sol.occupancy, sol.velocity)
    q = _pos_diff_quanta(gp, rp)
    words = int((gd != rd).sum().item())
    if not (torch.equal(gp, rp) and words == 0 and gms.item() == torch.sqrt(rms).item()):
        raise AssertionError(f"g2p_solids differs from its plain version: {q} position quanta, {words} dyn "
                             f"words, max speed {gms.item()} vs {torch.sqrt(rms).item()}")
    fq, counts = fused_against_two_launches(inp, sol)
    q2, plain_counts = fused_against_two_launches(inp)  # the same inputs without the solid; correct
    fq = max(fq, q2)
    counts.update(plain_counts)
    torch.cuda.synchronize()
    tol = "bit for bit (expected 0)"
    log(f"[{label}] gridfix_solids: max_abs_err {gerr:.3g} ok ({tol}) [{card}]")
    log(f"[{label}] g2p_solids: max_abs_err {q * 2.0 ** -13:.3g} ok ({tol}: posq, dyn, max speed) [{card}]")
    log(f"[{label}] advect_pack_solids (and advect_pack, correct_pack on the same inputs): max_abs_err "
        f"{fq * 2.0 ** -13:.3g} ok ({tol} with their plain versions and G2P then pack x: posq, dyn, max speed, "
        f"dropped and kept {json.dumps(counts)}) [{card}]")
    return {"gridfix_solids": gerr, "g2p_solids": q * 2.0 ** -13, "advect_pack_solids": fq * 2.0 ** -13}


def check_glue(params, inp, label, card):
    """The dense glue on the card against the same PyTorch code on the CPU,
    bit for bit: the marker, normalize_velocity, the divergence and density
    right-hand sides (with the replay's solids, if any). The density RHS
    divides by a device tensor, a true division as in JAX: by a host scalar
    PyTorch would multiply by the reciprocal on the card."""
    from blub_tpu_torch.ops import p2g
    from blub_tpu_torch.sim.dense_transfer import density_rhs_from_raw
    from blub_tpu_torch.sim.divergence import compute_divergence_rhs
    from blub_tpu_torch.sim.sm_phases import marker_from_counts

    g, dt, sol = params.grid_dim, inp["dt"], inp["solids"]
    t = inp["table"]
    acc = p2g.p2g(t.posq, t.dyn)
    dacc = p2g.p2g(inp["posq_den"], None, density=True)
    occ, sv = (sol.occupancy, sol.velocity) if sol is not None else (None, None)

    def glue(acc, dacc, occ, sv):
        marker = marker_from_counts(acc[6], g, occ)
        vel = p2g.normalize_velocity(acc, marker, params.gravity_grid, dt)
        return {"marker": marker, "normalize_velocity": torch.stack(vel),
                "divergence_rhs": compute_divergence_rhs(vel, marker, sv),
                "density_rhs": density_rhs_from_raw(dacc[0], marker_from_counts(dacc[1], g, occ), dt)}

    got = glue(acc, dacc, occ, sv)
    ref = glue(acc.cpu(), dacc.cpu(), *(None if a is None else a.cpu() for a in (occ, sv)))
    differ = {k: int((got[k].cpu() != ref[k]).sum().item()) for k in got}
    log(f"[{label}] glue on the card vs the CPU, values that differ: {json.dumps(differ)} "
        f"(bit for bit expected) [{card}]")
    if any(differ.values()):
        raise AssertionError(f"the dense glue differs between the card and the CPU: {differ}")
    return differ


WIDE_K = 40  # beyond 32 slots: the 64-bit mask instantiations of p2g and the packs


def check_wide(grid, card):
    """A 40-slot table through p2g and both packs (their 64-bit mask
    instantiations) on the card, against the plain versions bit for bit: one
    on its bins (p2g), one moved off them within +-2 cells (an x pack to
    K + 4 slots, then y + z back to K, with overflow)."""
    from blub_tpu_torch.ops import p2g, rebin
    from blub_tpu_torch.testing import crowded_table, moving_box

    t = crowded_table(grid, WIDE_K, 12, fill=0.85, device="cuda")
    for density in (False, True):
        if not torch.equal(p2g.p2g(t.posq, t.dyn, density), p2g.p2g_plain(t.posq, t.dyn, density)):
            raise AssertionError(f"p2g at K={WIDE_K} (density={density}) differs from its plain version")
    m = crowded_table(grid, WIDE_K, 13, fill=0.6, reach=2.45, device="cuda")
    got = rebin.pack(m.posq, m.dyn, 0, 2, WIDE_K + 4)
    ref = rebin.pack_plain(m.posq, m.dyn, 0, 2, WIDE_K + 4)
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"pack x at K={WIDE_K} differs from its plain version")
    got_yz = rebin.pack_yz(ref[0], ref[1], 2, WIDE_K)
    ref_yz = rebin.pack_yz_plain(ref[0], ref[1], 2, WIDE_K)
    if not all(torch.equal(a, b) for a, b in zip(got_yz, ref_yz)):
        raise AssertionError(f"pack_yz at K={WIDE_K} differs from its plain version")
    # the fused kernels' 64-bit instantiations: the 40-slot table on its
    # bins, moved by a fast flow into K + 4 slots (arrivals, overflow)
    rng = np.random.default_rng(14)
    flow = [torch.from_numpy(rng.standard_normal(grid).astype(np.float32) * 150.0).cuda() for _ in range(3)]
    change = [torch.from_numpy(rng.standard_normal(grid).astype(np.float32) * 0.6).cuda() for _ in range(3)]
    marker = torch.from_numpy(np.where(rng.random(grid) < 0.75, 1, -1).astype(np.int8)).cuda()
    box = moving_box(grid, (8, 2, 3), (14, 12, 12), (-35.0, 4.0, 2.0), device="cuda")  # (a) mid's box
    inp = {"table": t, "dt": np.float32(1.0 / 120.0), "k_mid": WIDE_K + 4, "velf": flow, "posq_den": t.posq,
           "dyn_den": t.dyn, "change": change, "marker2": marker}
    _, fused = fused_against_two_launches(inp)
    fused.update(fused_against_two_launches(inp, box)[1])
    torch.cuda.synchronize()
    res = {"k": WIDE_K, "grid": list(grid), "particles": [int(t.num_particles()), int(m.num_particles())],
           "x_dropped_kept": [int(ref[2]), int(ref[3])], "yz_counts": ref_yz[2].tolist(),
           "fused_dropped_kept": fused, "card": card}
    log(f"[wide] K={WIDE_K}: p2g (both modes), pack x, pack_yz and the fused advect (with and without solids) and "
        f"correct + pack x bit for bit against their plain versions (and the fused ones against the two launches) "
        + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# timing and bounds at the dam inputs (per substep: every call of the kernel)


def time_kernels(inp, iters, card=""):
    from blub_tpu_torch.ops import g2p, gridfix, p2g, pcg, rebin
    from blub_tpu_torch.sim.pressure import solve_pressure_plain
    from blub_tpu_torch.sim.slot_major import valid_mask
    from blub_tpu_torch.sim.density import position_change_field
    from blub_tpu_torch.sim.divergence import remove_divergence
    from blub_tpu_torch.sim.extrapolate import extrapolate_velocity

    t, dt = inp["table"], inp["dt"]
    k = t.capacity
    n = t.posq[0, 0].numel()

    def n_valid(posq):
        return int(valid_mask(posq).sum().item())

    nv, nv2 = n_valid(t.posq), n_valid(inp["posq_den"])
    m, m2 = inp["marker"], inp["marker2"]

    def p2g_k():
        p2g.p2g(t.posq, t.dyn)
        p2g.p2g(inp["posq_den"], None, True)

    def p2g_p():
        p2g.p2g_plain(t.posq, t.dyn, False)
        p2g.p2g_plain(inp["posq_den"], None, True)

    iters_used = []

    def pcg_k():
        for a in inp["pcg"]:
            iters_used.append(pcg.solve_pressure(*a, dt).stats.iterations)  # device tensors: no read

    def pcg_p():
        for a in inp["pcg"]:
            solve_pressure_plain(*a, dt)

    def gf_k():
        gridfix.gridfix_remove(inp["vel"], inp["pvel"], m)
        gridfix.gridfix_change(inp["pvel"], m2, dt)

    def gf_p():
        extrapolate_velocity(remove_divergence(inp["vel"], inp["pvel"], m), m)
        extrapolate_velocity(position_change_field(inp["pvel"], m2, dt), m2)

    def g2p_k():
        g2p.advect(t.posq, inp["velf"], dt)
        g2p.correct(inp["posq_den"], inp["change"], m2)

    def g2p_p():
        g2p.advect_plain(t.posq, inp["velf"], dt)
        g2p.correct_plain(inp["posq_den"], inp["change"], m2)

    def pack_k():
        for a in inp["packs"]:
            rebin.pack(*a)

    def pack_p():
        for a in inp["packs"]:
            rebin.pack_plain(*a)

    def yz_k():
        for a in inp["yz"]:
            rebin.pack_yz(*a)

    def yz_p():
        for a in inp["yz"]:
            rebin.pack_yz_plain(*a)

    # The bounds: bytes and operations of probes/bandwidth_model.py, counted
    # on this run's data (valid slots, fluid cells, PCG iterations).
    rows = {}
    rows["p2g"] = (cuda_ms(p2g_k, iters), cuda_ms(p2g_p, 1), bound_ms(*bwm.p2g(k, n, nv, nv2)))
    rows["pcg"] = (cuda_ms(pcg_k, iters), cuda_ms(pcg_p, 1), None)
    pcg_device_ms = device_ms(pcg_k, iters)  # the solve never synchronises
    its = [int(i) for i in iters_used[-2:]]
    fluid = [int((a[2] == 1).sum().item()) for a in inp["pcg"]]
    rows["pcg"] = rows["pcg"][:2] + (bound_ms(*bwm.pcg(n, its, fluid)),)
    rows["gridfix"] = (cuda_ms(gf_k, iters), cuda_ms(gf_p, 1), bound_ms(*bwm.gridfix(n)))
    rows["g2p"] = (cuda_ms(g2p_k, iters), cuda_ms(g2p_p, 1), bound_ms(*bwm.g2p(k, n, nv, nv2)))
    # device time back to back (the wrappers' host time hides a ~10 us call)
    device = {"pcg": pcg_device_ms, "gridfix": device_ms(gf_k, iters), "g2p": device_ms(g2p_k, iters)}
    # g2p's floors on these shapes: the kernels on all-empty tables (their
    # loads and zero stores, no particle), and the same outputs zeroed by
    # PyTorch (a memset, the write floor)
    empty = torch.zeros_like(t.posq), torch.zeros_like(inp["posq_den"])
    outs = torch.empty_like(t.posq), torch.empty((k, 6) + tuple(t.posq.shape[2:]), dtype=torch.int32,
                                                 device=t.posq.device), torch.empty_like(empty[1])
    device["g2p_empty_tables"] = device_ms(lambda: (g2p.advect(empty[0], inp["velf"], dt),
                                                    g2p.correct(empty[1], inp["change"], m2)), iters)
    device["g2p_outputs_memset"] = device_ms(lambda: [o.zero_() for o in outs], iters)
    # a pack reads its input table once (gated) and writes its output once;
    # the fused y + z pack's y-stage table is neither
    pack_bytes = sum(bwm.pack(a[0].shape[0], a[4], n, n_valid(a[0]))[0] for a in inp["packs"])
    yz_bytes = sum(bwm.pack(a[0].shape[0], a[3], n, n_valid(a[0]))[0] for a in inp["yz"])
    rows["pack"] = (cuda_ms(pack_k, iters), cuda_ms(pack_p, 1), bound_ms(pack_bytes, 0))
    rows["pack_yz"] = (cuda_ms(yz_k, iters), cuda_ms(yz_p, 1), bound_ms(yz_bytes, 0))
    # the fused kernels: the operations are G2P's, once per valid slot (the
    # kernel evaluates it once more on the halo planes, and again for slots
    # past its cache)
    fused_rows(rows, device, inp, iters, label="dam", card=card,
               advect=bound_ms(*bwm.advect_pack(k, inp["k_mid"], n, nv)),
               correct=bound_ms(*bwm.correct_pack(k, inp["k_mid"], n, nv2)))
    log(f"[bound] slots {k * n}, valid {nv} (advect) {nv2} (correct); pcg iterations {its}, "
        f"fluid cells {fluid} of {n}; pack x bytes {pack_bytes}, pack yz bytes {yz_bytes}")
    return rows, device


def fused_split(name, label, k_fn, floor_fn, moved_posq, out_posq, iters, card, kernel_ms=None):
    """Where a fused kernel's time goes: its device ms on the same table with
    every slot invalid (``floor_fn``: the masks' valid-word reads and the
    stream of zeros, the kernel's structure floor), a ``torch.zeros`` of its
    k_out-slot output (the write floor), the share of the valid slots whose
    moved x bin is not their own cell (``moved_posq``: the moved K-slot
    table, G2P's output; rel x rounds past the cell's half width) and the
    placed slots per output cell (``out_posq``: the fused output)."""
    valid = (moved_posq[:, 1] & 1) == 1
    shift = (((moved_posq[:, 0] >> 16) + 4096) >> 13) != 0
    n_valid, movers = int(valid.sum().item()), int((valid & shift).sum().item())
    per = ((out_posq[:, 1] & 1) == 1).sum(0)
    held = int((per > 0).sum().item())
    zeros_shape = (out_posq.shape[0], 8) + tuple(out_posq.shape[2:])
    dev = out_posq.device
    split = {
        "structure_floor_device_ms": device_ms(floor_fn, iters),
        "write_floor_device_ms": device_ms(lambda: torch.zeros(zeros_shape, dtype=torch.int32, device=dev), iters),
        "kernel_device_ms": kernel_ms if kernel_ms is not None else device_ms(k_fn, iters),
        "valid_slots": n_valid, "movers": movers, "mover_share": movers / max(n_valid, 1),
        "placed_per_cell": int(per.sum().item()) / per.numel(),
        "placed_per_held_cell": int(per.sum().item()) / max(held, 1), "placed_max": int(per.max().item()),
    }
    log(f"[split] {label} {name}: device {split['kernel_device_ms']:.4f} ms; structure floor (every slot invalid) "
        f"{split['structure_floor_device_ms']:.4f} ms; write floor (torch.zeros of the {out_posq.shape[0]}-slot "
        f"output) {split['write_floor_device_ms']:.4f} ms; movers {movers} of {n_valid} valid slots "
        f"({100 * split['mover_share']:.2f} %); placed slots per output cell {split['placed_per_cell']:.3f} "
        f"(per cell that holds one {split['placed_per_held_cell']:.3f}, max {split['placed_max']}) [{card}]")
    return split


def fused_rows(rows, device, inp, iters, advect, correct=None, solids=None, label="dam", card=""):
    """Rows of the fused kernels at ``inp`` (advect, with ``solids`` its
    solids form; correct where ``correct`` gives its bound): ms per substep
    (CUDA events), the plain version's ms, the bound; device ms back to back
    in turns with the two launches they replace (two, fused, fused, two),
    and those two launches' ms in ``device["two_launch"]``; the time split
    (``fused_split``) in ``device["split"]``."""
    from blub_tpu_torch.ops import advect_pack, g2p, rebin

    t, dt, k_mid = inp["table"], inp["dt"], inp["k_mid"]
    occ, sv = (solids.occupancy, solids.velocity) if solids is not None else (None, None)
    empty = torch.zeros_like(t.posq)

    def adv_k():
        advect_pack.advect_pack(t.posq, inp["velf"], dt, occ, sv, k_mid)

    def adv_two():
        p, d, _ = g2p.advect(t.posq, inp["velf"], dt, occ, sv)
        rebin.pack(p, d, 0, g2p.ADVECT_SHIFT, k_mid)

    def adv_p():
        advect_pack.advect_pack_plain(t.posq, inp["velf"], dt, occ, sv, k_mid)

    def adv_split():
        return (lambda: advect_pack.advect_pack(empty, inp["velf"], dt, occ, sv, k_mid),
                g2p.advect(t.posq, inp["velf"], dt, occ, sv)[0],
                advect_pack.advect_pack(t.posq, inp["velf"], dt, occ, sv, k_mid)[0])

    cases = [("advect_pack" if solids is None else "advect_pack_solids", adv_k, adv_two, adv_p, advect, adv_split)]
    if correct is not None:
        args = (inp["posq_den"], inp["dyn_den"], inp["change"], inp["marker2"], k_mid)
        empty_den = torch.zeros_like(args[0])

        def cor_two():
            rebin.pack(g2p.correct(args[0], args[2], args[3]), args[1], 0, g2p.CORRECT_SHIFT, k_mid)

        def cor_split():
            return (lambda: advect_pack.correct_pack(empty_den, *args[1:]), g2p.correct(args[0], args[2], args[3]),
                    advect_pack.correct_pack(*args)[0])

        cases.append(("correct_pack", lambda: advect_pack.correct_pack(*args), cor_two,
                      lambda: advect_pack.correct_pack_plain(*args), correct, cor_split))
    two = device.setdefault("two_launch", {})
    splits = device.setdefault("split", {})
    for name, k_fn, two_fn, p_fn, bound, split_fn in cases:
        turns = [device_ms(f, iters) for f in (two_fn, k_fn, k_fn, two_fn)]
        device[name] = (turns[1] + turns[2]) / 2
        two[name] = {"ms": cuda_ms(two_fn, iters), "device_ms": (turns[0] + turns[3]) / 2,
                     "device_ms_turns": turns}
        rows[name] = (cuda_ms(k_fn, iters), cuda_ms(p_fn, 1), bound)
        floor_fn, moved, out = split_fn()
        splits[name] = fused_split(name, label, k_fn, floor_fn, moved, out, iters, card, device[name])


def time_solids(inp, iters, card=""):
    """ms per substep (one call each), plain ms and bounds of the solid
    specialisations, counted on this run's inputs."""
    from blub_tpu_torch.ops import g2p, gridfix
    from blub_tpu_torch.sim.divergence import remove_divergence
    from blub_tpu_torch.sim.extrapolate import extrapolate_velocity
    from blub_tpu_torch.sim.slot_major import valid_mask

    t, dt, sol, m = inp["table"], inp["dt"], inp["solids"], inp["marker"]
    k = t.capacity
    n = t.posq[0, 0].numel()
    nv = int(valid_mask(t.posq).sum().item())

    def gf_k():
        gridfix.gridfix_remove(inp["vel"], inp["pvel"], m, sol.velocity)

    def g2p_k():
        g2p.advect(t.posq, inp["velf"], dt, sol.occupancy, sol.velocity)

    rows = {}
    rows["gridfix_solids"] = (
        cuda_ms(gf_k, iters),
        cuda_ms(lambda: extrapolate_velocity(remove_divergence(inp["vel"], inp["pvel"], m, sol.velocity), m), 1),
        bound_ms(*bwm.gridfix_remove(n, solids=True)),
    )
    rows["g2p_solids"] = (
        cuda_ms(g2p_k, iters),
        cuda_ms(lambda: g2p.advect_plain(t.posq, inp["velf"], dt, sol.occupancy, sol.velocity), 1),
        bound_ms(*bwm.g2p_advect(k, n, nv, solids=True)),
    )
    device = {"gridfix_solids": device_ms(gf_k, iters), "g2p_solids": device_ms(g2p_k, iters)}
    fused_rows(rows, device, inp, iters, solids=sol, label="wave", card=card,
               advect=bound_ms(*bwm.advect_pack(k, inp["k_mid"], n, nv, solids=True)))
    log(f"[bound] wave: slots {k * n}, valid {nv}")
    return rows, device


SOURCES = {
    "p2g": ("blub_tpu_torch/ops/csrc/p2g.cu", "blub_tpu/ops/pallas_p2g.py:82"),
    "pcg": ("blub_tpu_torch/ops/csrc/pcg.cu", "blub_tpu/ops/pallas_pcg.py:68"),
    "pcg_history": ("blub_tpu_torch/ops/csrc/pcg.cu", "blub_tpu/ops/pallas_pcg.py:180"),
    "gridfix": ("blub_tpu_torch/ops/csrc/gridfix.cu", "blub_tpu/ops/pallas_gridfix.py:72"),
    "gridfix_solids": ("blub_tpu_torch/ops/csrc/gridfix.cu", "blub_tpu/ops/pallas_gridfix.py:72"),
    # the unfused G2P: _advect_kernel (both with_solids) and _correct_kernel
    "g2p": ("blub_tpu_torch/ops/csrc/g2p.cu", "blub_tpu/ops/pallas_advect.py:294"),
    "g2p_solids": ("blub_tpu_torch/ops/csrc/g2p.cu", "blub_tpu/ops/pallas_advect.py:294"),
    "pack": ("blub_tpu_torch/ops/csrc/pack.cu", "blub_tpu/ops/pallas_rebin.py:662"),
    "pack_yz": ("blub_tpu_torch/ops/csrc/pack.cu", "blub_tpu/ops/pallas_rebin.py:688"),
    "copy": ("blub_tpu_torch/ops/csrc/copy.cu", "scripts/tpu_bench_copy_bw.py:74"),
    "yz_floor": ("blub_tpu_torch/ops/csrc/yz_floor.cu", "scripts/tpu_bench_yz_floor.py:60"),
    "yz_floor_read": ("blub_tpu_torch/ops/csrc/yz_floor.cu", "scripts/tpu_bench_yz_floor.py:60"),
    "relops": ("blub_tpu_torch/ops/csrc/relops.cu", "scripts/tpu_smoke_relops.py:32"),
    "g2p_xs": ("blub_tpu_torch/ops/csrc/g2p.cu", "blub_tpu/ops/pallas_advect.py:294"),
    "g2p_solids_xs": ("blub_tpu_torch/ops/csrc/g2p.cu", "blub_tpu/ops/pallas_advect.py:294"),
    "pack_xs": ("blub_tpu_torch/ops/csrc/pack.cu", "blub_tpu/ops/pallas_rebin.py:662"),
    "pcg_slab": ("blub_tpu_torch/ops/csrc/pcg.cu", "blub_tpu/ops/pallas_pcg_blocked.py:152"),
    # no TPU kernel: the JAX package's host helper (sdf_worker) for the bake
    "sdf": ("blub_tpu_torch/ops/csrc/sdf.cu", "native/blub_native.cpp:49"),
    # what the bake's skipping reads: the per-triangle bounds (bounds_kernel),
    # the triangles in Morton order with their groups' and tiles' bounds
    # (unite_kernel), the points' Morton keys (keys_kernel)
    "sdf_bounds": ("blub_tpu_torch/ops/csrc/sdf.cu", "native/blub_native.cpp:49"),
    "sdf_unite": ("blub_tpu_torch/ops/csrc/sdf.cu", "native/blub_native.cpp:49"),
    "sdf_keys": ("blub_tpu_torch/ops/csrc/sdf.cu", "native/blub_native.cpp:49"),
    # G2P fused with the x pack: _advect_pack_kernel (both with_solids) and
    # _correct_pack_kernel, their with_xs forms
    "advect_pack": ("blub_tpu_torch/ops/csrc/advect_pack.cu", "blub_tpu/ops/pallas_advect.py:927"),
    "advect_pack_solids": ("blub_tpu_torch/ops/csrc/advect_pack.cu", "blub_tpu/ops/pallas_advect.py:927"),
    "advect_pack_xs": ("blub_tpu_torch/ops/csrc/advect_pack.cu", "blub_tpu/ops/pallas_advect.py:927"),
    "advect_pack_solids_xs": ("blub_tpu_torch/ops/csrc/advect_pack.cu", "blub_tpu/ops/pallas_advect.py:927"),
    "correct_pack": ("blub_tpu_torch/ops/csrc/advect_pack.cu", "blub_tpu/ops/pallas_advect.py:1060"),
    "correct_pack_xs": ("blub_tpu_torch/ops/csrc/advect_pack.cu", "blub_tpu/ops/pallas_advect.py:1060"),
}


# ---------------------------------------------------------------------------


def dam_params_and_positions():
    from blub_tpu_torch.core.seeding import add_fluid_cube
    from blub_tpu_torch.core.types import SimParams

    x, y, z = DAM_GRID
    pos = add_fluid_cube(DAM_GRID, (1, 1, 1), (x // 2, y // 2, z - 1), 10**9)
    params = SimParams(grid_dim=DAM_GRID, dt=1.0 / 120.0, gravity_grid=(0.0, -981.0, 0.0),
                       num_particles=pos.shape[0])
    return params, pos


def state_is_finite(state) -> bool:
    from blub_tpu_torch.sim.slot_major import unpack_dyn, valid_mask

    v = valid_mask(state.table.posq)
    vel, aff = unpack_dyn([state.table.dyn[:, c] for c in range(6)])
    ok = all(bool(torch.isfinite(a[v]).all()) for a in vel + aff)
    return ok and bool(torch.isfinite(state.pressure_vel).all()) and bool(torch.isfinite(state.pressure_den).all()) \
        and bool(torch.isfinite(state.max_speed))


def eager_frames(params, state, n, cfl_target, max_substeps, solids_fn=None):
    """``n`` CFL frames run eagerly on the card (``eager_frame``: the
    reference the graph replays are held against). -> (state, n_sub list)."""
    from blub_tpu_torch.sim.step_dense import eager_frame, substep_count

    subs = []
    for _ in range(n):
        k = substep_count(params, state, cfl_target, max_substeps)
        state = eager_frame(params, state, solids_fn or (lambda i, m: None), k)
        subs.append(k)
    return state, subs


def capture_seconds(state) -> float:
    """Seconds the state's frame runner has spent capturing its graph so far
    (0 for an eager state)."""
    return (state.runner.capture_s or 0.0) if state.runner is not None else 0.0


def ints(subs) -> list:
    """n_sub per frame as ints: a device int32 tensor (``multi_frame_dense``
    on the graph path) or a list of ints and 0-d tensors, read once."""
    if isinstance(subs, torch.Tensor):
        return [int(v) for v in subs.tolist()]
    return [int(v) for v in subs]


def frame_n_sub(scene):
    """A Scene's last n_sub without a host read: on the graph path a device
    copy of the runner's word (read after the run), else the host's count."""
    return scene._runner.n_sub.clone() if scene._use_graphs else scene.last_substeps


def run_dam(card, graphs=True):
    """The dam cell for 1 warm + TIMED_FRAMES frames from rest, through
    ``multi_frame_dense`` (one CUDA-graph launch per frame that picks its
    n_sub on the card, no host read; the runner's first frame runs eagerly
    and the second captures the graph) or, with ``graphs=False``, through
    ``eager_frames``. The n_sub sequence is read after the timed frames."""
    from blub_tpu_torch.ops import cuda
    from blub_tpu_torch.sim.step_dense import make_dense_state, multi_frame_dense

    frames = multi_frame_dense if graphs else eager_frames
    params, pos = dam_params_and_positions()
    n0 = pos.shape[0]
    torch.cuda.reset_peak_memory_stats()
    state = make_dense_state(params, pos, DAM_K)  # the card, by default
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    state, warm_subs = frames(params, state, 1, cfl_target=DAM_CFL, max_substeps=DAM_MAX_SUB)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, subs = frames(params, state, TIMED_FRAMES - BENCH_WINDOW, cfl_target=DAM_CFL, max_substeps=DAM_MAX_SUB)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cap1 = capture_seconds(state)
    state, subs_b = frames(params, state, BENCH_WINDOW, cfl_target=DAM_CFL, max_substeps=DAM_MAX_SUB)
    t_enqueued = time.perf_counter()  # graph launches: nothing waited for the card before here
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    wall, wall_b = t2 - t0, t2 - t1
    warm_subs, subs_b = ints(warm_subs), ints(subs_b)
    subs = ints(subs) + subs_b
    # the frames' wall time without the graph's capture (in the second frame)
    cap = capture_seconds(state)
    replayed, replayed_b = wall - cap, wall_b - (cap - cap1)
    launches = cuda.launch_counts()
    count = state.table.num_particles().item()
    lost = state.table.lost.item()
    max_div = state.stats_vel.error.item()
    tol = params.solver_vel.error_tolerance
    runner = state.runner
    res = {
        "path": "graphs" if graphs else "eager",
        "grid": list(DAM_GRID), "particles": n0, "capacity": DAM_K, "cfl": DAM_CFL,
        "frames": TIMED_FRAMES, "warm_frame_s": warm_s,
        "frames_per_s": TIMED_FRAMES / wall, "ms_per_frame": 1e3 * wall / TIMED_FRAMES,
        "captures_s": cap, "ms_per_frame_without_captures": 1e3 * replayed / TIMED_FRAMES,
        "substeps_per_frame": sum(subs) / TIMED_FRAMES, "n_sub": warm_subs + subs,
        "bench_window": {"frames": BENCH_WINDOW, "frames_per_s": BENCH_WINDOW / wall_b,
                         "ms_per_frame": 1e3 * wall_b / BENCH_WINDOW,
                         "ms_per_frame_without_captures": 1e3 * replayed_b / BENCH_WINDOW,
                         "substeps_per_frame": sum(subs_b) / BENCH_WINDOW,
                         "host_ms_per_frame_call": 1e3 * (t_enqueued - t1) / BENCH_WINDOW},
        "lost": lost, "lost_pct": 100.0 * lost / n0, "count_plus_lost_eq_n0": count + lost == n0,
        "lost_recorded": DAM_LOST_RECORDED, "max_divergence": max_div, "solver_converged": max_div <= tol,
        "pcg_iterations_vel_den": [int(state.stats_vel.iterations), int(state.stats_den.iterations)],
        "max_speed": state.max_speed.item(), "no_nan": state_is_finite(state),
        "pack_launches_per_substep": (launches["advect_pack"] + launches["correct_pack"] + launches["pack"]
                                      + launches["pack_yz"]) / sum(warm_subs + subs),
        "launches": launches, "capture_s": runner.capture_s if runner else None,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card,
    }
    tag = "[dam]" if graphs else "[dam eager]"
    log(f"{tag} " + json.dumps(res))
    log(f"{tag} lost {lost} ({res['lost_pct']:.4f} %), recorded {DAM_LOST_RECORDED}: "
        f"{'the same' if lost == DAM_LOST_RECORDED else 'DIFFERENT'} [{card}]")
    if not res["count_plus_lost_eq_n0"]:
        raise AssertionError(f"count {count} + lost {lost} != n0 {n0}")
    if res["lost_pct"] > LOST_BUDGET_PCT:
        raise AssertionError(f"lost_pct {res['lost_pct']} over the {LOST_BUDGET_PCT}% budget")
    if not res["no_nan"]:
        raise AssertionError("the dam state holds NaN or inf")
    if not res["solver_converged"]:
        raise AssertionError(f"velocity solve did not converge: max_divergence {max_div}")
    missing = [k for k in DAM_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    stray = {k: v for k, v in launches.items() if k not in DAM_KERNELS and v}
    if stray:
        raise AssertionError(f"the dam path launched kernels outside its own: {stray}")
    if graphs and not (runner and runner.graph):
        raise AssertionError("the dam frames launched no CUDA graph")
    return params, state, launches, res


def compare_paths(label, eager, graph, card):
    """The graph path against the eager one: the same lost, n_sub sequence
    and launch counts (each launch counts its branch's tally)."""
    same = {k: eager[k] == graph[k] for k in ("lost", "n_sub", "launches")}
    res = {"eager_ms_per_frame": eager["ms_per_frame"], "graph_ms_per_frame": graph["ms_per_frame"],
           "graph_ms_per_frame_without_captures": graph["ms_per_frame_without_captures"],
           "eager_frames_per_s": eager["frames_per_s"], "graph_frames_per_s": graph["frames_per_s"],
           "eager_peak_mem_gib": eager["peak_mem_gib"], "graph_peak_mem_gib": graph["peak_mem_gib"],
           "capture_s": graph["capture_s"], "lost": [eager["lost"], graph["lost"]], "same": same, "card": card}
    log(f"[{label}] " + json.dumps(res))
    if not all(same.values()):
        raise AssertionError(f"{label}: the graph path differs from the eager path: {same}")
    return res


def check_step_syncs(params, state, card):
    """One dam substep (``step_core``) with PyTorch's sync debug mode on.
    Every call that waits for the card is reported by name (the innermost
    frame of the port, with its source line); a sync inside
    ``pcg.solve_pressure`` fails the phase. The frame's one known host read
    (``substep_count``'s max_speed) runs after it as the positive control:
    if the mode does not see that one, the check fails as blind."""
    import linecache
    import traceback
    import warnings

    from blub_tpu_torch.sim.step_dense import step_core, substep_count

    pkg = str(ROOT / "blub_tpu_torch")
    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack() if f.filename.startswith(pkg)]
        f = frames[-1] if frames else traceback.FrameSummary(filename, lineno, "?")
        syncs.append({
            "call": f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} in {f.name}: "
                    f"{linecache.getline(f.filename, f.lineno).strip()}",
            "in_pcg": any(g.name == "solve_pressure" and g.filename.endswith("ops/pcg.py") for g in frames),
        })

    dt = np.float32(params.dt) / np.float32(2)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step_core(params, state, dt)
            in_step = len(syncs)
            substep_count(params, state, DAM_CFL, DAM_MAX_SUB)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    step, control = syncs[:in_step], syncs[in_step:]
    res = {"syncs": step, "count": len(step), "in_pcg": sum(s["in_pcg"] for s in step), "control": control,
           "card": card}
    log("[sync] one dam step_core under torch.cuda.set_sync_debug_mode: " + json.dumps(res))
    if res["in_pcg"]:
        raise AssertionError(f"pcg.solve_pressure synchronises with the host: {[s for s in step if s['in_pcg']]}")
    if not control:
        raise AssertionError("sync debug mode did not see substep_count's max_speed read: the check is blind")
    return res


def check_graph_syncs(run_frame, captured_graph, frames, label, card, control, pacing_waits=None):
    """``frames`` frames (``run_frame()`` runs one) with PyTorch's sync debug
    mode on: each call that waits for the card, by frame, with the innermost
    frame of the port (the end of the stack when the port is not on it).
    Fails unless every frame that launched the graph waits nowhere: the
    frame picks its n_sub on the card. A frame that captured the graph
    (``captured_graph()`` turned true in it) waits in the capture: it is
    reported, not held to that. After the frames, ``control()`` (the eager
    frame's max-speed read) runs under the same mode as the positive
    control: if the mode does not see it, the check fails as blind. The
    mode does not see event waits: ``pacing_waits()`` (a Scene's waits for
    the card when the host is RING frames ahead) is reported beside."""
    import linecache
    import traceback
    import warnings

    pkg = str(ROOT / "blub_tpu_torch")
    syncs, frame, captured = [], [-1], []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        port = [f for f in stack if f.filename.startswith(pkg)]
        where = port[-1] if port else None
        syncs.append({
            "frame": frame[0],
            "call": (f"{os.path.relpath(where.filename, ROOT)}:{where.lineno} in {where.name}: "
                     f"{linecache.getline(where.filename, where.lineno).strip()}") if where else
                    " <- ".join(f"{f.filename}:{f.lineno} in {f.name}" for f in reversed(stack[-6:])),
        })

    torch.cuda.synchronize()
    waits0 = pacing_waits() if pacing_waits else None
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(frames):
                frame[0] = i
                before = captured_graph()
                run_frame()
                if captured_graph() != before:
                    captured.append(i)
            frame[0] = "control"
            control()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    per_frame = [sum(1 for s in syncs if s["frame"] == i) for i in range(frames)]
    seen = [s for s in syncs if s["frame"] == "control"]
    res = {"frames": frames, "syncs_per_frame": per_frame, "frames_that_captured": captured, "syncs": syncs,
           "control_seen": len(seen),
           "pacing_waits": None if pacing_waits is None else pacing_waits() - waits0, "card": card}
    log(f"[graph sync] {label}: " + json.dumps(res))
    launched = [i for i in range(frames) if i not in captured]
    if not launched or any(per_frame[i] for i in launched):
        raise AssertionError(f"{label}: a frame that launched the graph waited for the card: {per_frame}, {syncs}")
    if not seen:
        raise AssertionError(f"{label}: sync debug mode did not see the eager max-speed read: the check is blind")
    return res


def clone_state(state):
    """A deep copy of a DenseFluidState (tensors cloned)."""
    from blub_tpu_torch.core.types import SolverStats
    from blub_tpu_torch.sim.slot_major import SlotMajorTable
    from blub_tpu_torch.sim.step_dense import DenseFluidState

    t = state.table
    return DenseFluidState(
        table=SlotMajorTable(posq=t.posq.clone(), dyn=t.dyn.clone(), lost=t.lost.clone(), grid_dim=t.grid_dim),
        pressure_vel=state.pressure_vel.clone(), pressure_den=state.pressure_den.clone(),
        step_index=state.step_index.clone(),
        stats_vel=SolverStats(error=state.stats_vel.error.clone(), iterations=state.stats_vel.iterations.clone()),
        stats_den=SolverStats(error=state.stats_den.error.clone(), iterations=state.stats_den.iterations.clone()),
        max_speed=state.max_speed.clone(),
    )


def velocity_solve(state):
    """The velocity solve's exit error (f32 bits) and iterations of the frame
    that made ``state``: a device copy, read after the run."""
    from blub_tpu_torch.sim.step_dense import scalar_words

    return scalar_words(state)[:2].clone()


def solve_record(vel_solves, cfg) -> dict:
    """Per-frame velocity solves (``velocity_solve``) read back: the frames
    whose solve ended over its tolerance (each ran to its iteration cap, as
    the solver is configured to stop), the largest error in units of the
    tolerance, and the frames where a solve is broken: a non-finite error,
    or a stop over the tolerance before the cap."""
    w = torch.stack(vel_solves).cpu()
    errs = w[:, 0].view(torch.float32).tolist()
    its = w[:, 1].tolist()
    over = [i for i, e in enumerate(errs) if e > cfg.error_tolerance]
    broken = [i for i, (e, n) in enumerate(zip(errs, its))
              if not np.isfinite(e) or (e > cfg.error_tolerance and n < cfg.max_num_iterations)]
    return {"frames": len(errs), "over_tolerance_at": over, "at_iteration_cap": sum(n >= cfg.max_num_iterations
                                                                                      for n in its),
            "max_error": max(errs), "max_error_x_tolerance": max(errs) / cfg.error_tolerance,
            "broken_at": broken}


def run_wave(card, capacity=WAVE_K, lost_budget=True, graphs=True):
    """The solids path: the wavegenerator scene through the port's Scene, 1
    warm + WAVE_FRAMES timed frames, one graph launch each (``graphs=False``:
    eager frames); the frame-96 state is kept for the replayed checks.
    ``lost_budget`` holds lost_pct to LOST_BUDGET_PCT. Each frame's n_sub and
    velocity solve are device copies, read after the frames."""
    from blub_tpu_torch.core.types import SolidState
    from blub_tpu_torch.ops import cuda
    from blub_tpu_torch.runtime.scene import Scene

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scene = Scene(ROOT / WAVE_SCENE, capacity=capacity, graphs=graphs)  # the card, by default
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = scene.params
    n0 = params.num_particles
    obj = scene.solid_objects[0]
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    scene.step()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    n_sub = [frame_n_sub(scene)]
    solid_cells = [scene.solids.occupancy.sum()]
    vel_solves = [velocity_solve(scene.state)]
    wall = 0.0
    probe = None
    for frame in range(2, WAVE_FRAMES + 2):
        t0 = time.perf_counter()
        scene.step()
        n_sub.append(frame_n_sub(scene))
        solid_cells.append(scene.solids.occupancy.sum())
        vel_solves.append(velocity_solve(scene.state))
        if frame == WAVE_PROBE_FRAME:
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            t_probe = scene.total_simulated_time
            pos = scene.particle_positions()
            occ = scene.solids.occupancy.cpu().numpy()
            cells = np.floor(pos).astype(int)
            x_face = (obj.world_position_at(t_probe)[0] - scene.config.fluid.world_position[0]) / obj.grid_scale
            probe = {
                "frame": frame, "t": t_probe, "piston_face_x": x_face,
                "left_of_face_plus_1_5": float((pos[:, 0] < x_face + 1.5).mean()),
                "inside_solid": float((occ[cells[:, 0], cells[:, 1], cells[:, 2]] > 0).mean()),
            }
            replay = (clone_state(scene.state),
                      SolidState(occupancy=scene.solids.occupancy.clone(), velocity=scene.solids.velocity.clone()))
            continue
        if frame == WAVE_FRAMES + 1:
            torch.cuda.synchronize()
        wall += time.perf_counter() - t0
    launches = cuda.launch_counts()
    n_sub = ints(n_sub)
    state = scene.state
    cap = (scene._runner.capture_s or 0.0) if scene._runner is not None else 0.0
    count, lost = state.table.num_particles().item(), state.table.lost.item()
    max_div = state.stats_vel.error.item()
    tol = params.solver_vel.error_tolerance
    solves = solve_record(vel_solves, params.solver_vel)
    cells = [int(c.item()) for c in solid_cells]
    runner = scene._runner
    res = {
        "path": "graphs" if graphs else "eager",
        "scene": WAVE_SCENE, "grid": list(params.grid_dim), "particles": n0, "capacity": capacity,
        "cfl": scene.settings.cfl_target, "setup_s": setup_s, "warm_frame_s": warm_s, "frames": WAVE_FRAMES,
        "frames_per_s": WAVE_FRAMES / wall, "ms_per_frame": 1e3 * wall / WAVE_FRAMES,
        "captures_s": cap, "ms_per_frame_without_captures": 1e3 * (wall - cap) / WAVE_FRAMES,
        "substeps_per_frame": sum(n_sub[1:]) / WAVE_FRAMES, "n_sub": n_sub,
        "lost": lost, "lost_pct": 100.0 * lost / n0, "count_plus_lost_eq_n0": count + lost == n0,
        "max_divergence": max_div, "solver_converged": max_div <= tol, "velocity_solves": solves,
        "pcg_iterations_vel_den": [int(state.stats_vel.iterations), int(state.stats_den.iterations)],
        "max_speed": state.max_speed.item(), "no_nan": state_is_finite(state),
        "solid_cells_per_frame": {"min": min(cells), "max": max(cells), "mean": sum(cells) / len(cells),
                                  "at_probe": cells[WAVE_PROBE_FRAME - 1]},
        "probe": probe, "launches": launches, "capture_s": runner.capture_s if runner else None,
        "pacing_waits": scene.pacing_waits,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card,
    }
    tag = f"[wave K={capacity}{'' if graphs else ' eager'}]"
    log(f"{tag} " + json.dumps({k: v for k, v in res.items() if k != "n_sub"}))
    log(f"{tag} n_sub " + "".join(str(n) for n in n_sub))
    if capacity == WAVE_K:
        log(f"{tag} lost {lost} ({res['lost_pct']:.4f} %), recorded {WAVE_LOST_RECORDED}: "
            f"{'the same' if lost == WAVE_LOST_RECORDED else 'DIFFERENT'} [{card}]")
    if not res["count_plus_lost_eq_n0"]:
        raise AssertionError(f"wave: count {count} + lost {lost} != n0 {n0}")
    if not res["no_nan"]:
        raise AssertionError("the wave state holds NaN or inf")
    if solves["broken_at"]:
        raise AssertionError(f"wave: a velocity solve stopped short of its tolerance and its iteration cap, or "
                             f"ended non-finite: {solves}")
    if (len(solves["over_tolerance_at"]) > WAVE_MAX_FRAMES_OVER_TOL
            or solves["max_error_x_tolerance"] > WAVE_MAX_SOLVE_ERROR):
        raise AssertionError(f"wave: the velocity solve did not converge: more than {WAVE_MAX_FRAMES_OVER_TOL} "
                             f"frames over its tolerance, or one over {WAVE_MAX_SOLVE_ERROR} times it: {solves}")
    if lost_budget and res["lost_pct"] > LOST_BUDGET_PCT:
        raise AssertionError(f"wave: lost_pct {res['lost_pct']} over the {LOST_BUDGET_PCT}% budget")
    if probe["inside_solid"] >= INSIDE_BUDGET:
        raise AssertionError(f"wave: {probe['inside_solid']:.4f} of the particles inside the solid at frame 96")
    missing = [k for k in ("p2g", "pcg", "gridfix", "gridfix_solids", "advect_pack_solids", "correct_pack",
                           "pack_yz") if not launches[k]]
    if missing:
        raise AssertionError(f"kernels never launched on the wave path: {missing}")
    unfused = {k: launches[k] for k in UNFUSED_KERNELS if launches[k]}
    if unfused:
        raise AssertionError(f"the wave path launched the unfused G2P or x pack: {unfused}")
    if graphs and not (runner and runner.graph):
        raise AssertionError("the wave frames launched no CUDA graph")
    return scene, replay, res


def run_highres(card):
    """One CFL frame from rest at the highres cell (the frame runner's eager
    first frame), the PCG solves of the next substep timed on its inputs,
    then HIGHRES_FRAMES - 1 more frames through graph replays: conservation
    and finiteness checked, lost_pct reported against the budget."""
    from blub_tpu_torch.core.seeding import add_fluid_cube
    from blub_tpu_torch.core.types import SimParams
    from blub_tpu_torch.ops import cuda, pcg
    from blub_tpu_torch.sim.pressure import solve_pressure_plain
    from blub_tpu_torch.sim.step_dense import make_dense_state, multi_frame_dense

    x, y, z = HIGHRES_GRID
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pos = add_fluid_cube(HIGHRES_GRID, (1, 1, 1), (x // 2, y // 2, z - 1), 10**9)
    params = SimParams(grid_dim=HIGHRES_GRID, dt=1.0 / 120.0, gravity_grid=(0.0, -981.0, 0.0),
                       num_particles=pos.shape[0])
    state = make_dense_state(params, pos, HIGHRES_K)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    state, subs = multi_frame_dense(params, state, 1, cfl_target=HIGHRES_CFL, max_substeps=DAM_MAX_SUB)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    subs = ints(subs)
    launches = cuda.launch_counts()
    n0 = pos.shape[0]
    count, lost = state.table.num_particles().item(), state.table.lost.item()
    inp = phase_inputs(params, state, keep_packs=False)
    pcg_err, pcg_tol = check_pcg(inp)
    log(f"[highres] pcg: max_abs_err {pcg_err:.3g} ok ({pcg_tol}) [{card}]")
    history = check_pcg_history(inp["pcg"], inp["dt"], "highres", card)
    # the fused kernels at the shape the highres frames give them; G2P alone
    # as their unfused counterpart
    for name, fn in (("gridfix", check_gridfix), ("g2p", check_g2p), ("advect_pack", check_advect_pack)):
        err, tol = fn(inp)
        log(f"[highres] {name}: max_abs_err {err:.3g} ok ({tol}) [{card}]")
    its = []

    def solve_k():
        for a in inp["pcg"]:
            its.append(pcg.solve_pressure(*a, inp["dt"]).stats.iterations)

    ms = cuda_ms(solve_k, 3) / 2
    dev_ms = device_ms(solve_k, 3) / 2
    its = [int(i) for i in its[-2:]]
    plain = cuda_ms(lambda: [solve_pressure_plain(*a, inp["dt"]) for a in inp["pcg"]], 1) / 2
    n = x * y * z
    fluid = [int((a[2] == 1).sum().item()) for a in inp["pcg"]]
    # per solve: the substep's two solves' bytes and operations, halved
    bms, by = bound_ms(*(v / 2 for v in bwm.pcg(n, its, fluid)))
    del inp
    # past the first frame: graph launches (the second frame captures)
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    state, more = multi_frame_dense(params, state, HIGHRES_FRAMES - 1, cfl_target=HIGHRES_CFL,
                                    max_substeps=DAM_MAX_SUB)
    torch.cuda.synchronize()
    frames_s = time.perf_counter() - t0
    more = ints(more)
    runner = state.runner
    count_n, lost_n = state.table.num_particles().item(), state.table.lost.item()
    frames = {
        "frames": HIGHRES_FRAMES, "n_sub": subs + more, "s_after_the_first": frames_s,
        # the span holds the graph's capture (in the second frame): the old figure, then without it
        "ms_per_frame_after_the_first": 1e3 * frames_s / (HIGHRES_FRAMES - 1),
        "ms_per_frame_without_capture": 1e3 * (frames_s - runner.capture_s) / (HIGHRES_FRAMES - 1),
        "substeps_per_frame_after_the_first": sum(more) / (HIGHRES_FRAMES - 1), "capture_s": runner.capture_s,
        "lost": lost_n, "lost_pct": 100.0 * lost_n / n0, "lost_budget_pct": LOST_BUDGET_PCT,
        "within_budget": 100.0 * lost_n / n0 <= LOST_BUDGET_PCT, "count_plus_lost_eq_n0": count_n + lost_n == n0,
        "no_nan": state_is_finite(state), "max_divergence": state.stats_vel.error.item(),
        "pcg_iterations_vel_den": [int(state.stats_vel.iterations), int(state.stats_den.iterations)],
        "max_speed": state.max_speed.item(), "launches": cuda.launch_counts(),
    }
    res = {
        "grid": list(HIGHRES_GRID), "particles": n0, "capacity": HIGHRES_K, "cfl": HIGHRES_CFL,
        "setup_s": setup_s, "frame_s": frame_s, "n_sub": subs, "lost": lost, "lost_pct": 100.0 * lost / n0,
        "count_plus_lost_eq_n0": count + lost == n0, "no_nan": state_is_finite(state),
        "frame_pcg_iterations_vel_den": [int(state.stats_vel.iterations), int(state.stats_den.iterations)],
        "pcg_max_abs_err": pcg_err, "pcg_ms_per_solve": ms, "pcg_device_ms_per_solve": dev_ms,
        "pcg_plain_ms_per_solve": plain, "pcg_iterations_timed": its, "pcg_blocks": pcg.solve_blocks(HIGHRES_GRID),
        "fluid_cells": fluid, "pcg_bound_ms_per_solve": bms, "pcg_bound_by": by,
        "pcg_launches_frame": launches["pcg"], "frames_through_graphs": frames, "pcg_history": history,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card,
    }
    res["quality"] = run_quality(f"highres after {HIGHRES_FRAMES} frames", state, params.solver_vel.error_tolerance,
                                 card)
    log("[highres] " + json.dumps(res))
    log(f"[highres] {HIGHRES_FRAMES} frames: lost {lost_n} ({frames['lost_pct']:.4f} %, budget {LOST_BUDGET_PCT} %: "
        f"{'within' if frames['within_budget'] else 'OVER'}), n_sub {''.join(map(str, frames['n_sub']))}, "
        f"{frames['ms_per_frame_without_capture']:.3f} ms/frame without the capture of {runner.capture_s:.3f} s "
        f"({frames['ms_per_frame_after_the_first']:.3f} with it) [{card}]")
    if not (res["count_plus_lost_eq_n0"] and res["no_nan"]):
        raise AssertionError("highres: conservation or finiteness failed")
    if not (frames["count_plus_lost_eq_n0"] and frames["no_nan"]):
        raise AssertionError(f"highres after {HIGHRES_FRAMES} frames: conservation or finiteness failed")
    if not launches["pcg"] or not runner.graph:
        raise AssertionError("highres: the pcg kernels never launched, or no graph launched")
    for name, counts in (("first frame", launches), ("graph frames", frames["launches"])):
        if not (counts["advect_pack"] and counts["correct_pack"]) or any(counts[k] for k in UNFUSED_KERNELS):
            raise AssertionError(f"highres {name}: the fused kernels did not launch, or the unfused ones did: "
                                 f"{counts}")
    return res


# the interior mean of rho / rho0 - 1, card against the plain version (and
# mesh against whole grid): within 1e-3 of the reference's own size, plus
# 1e-10 for the sums' other order (the two have read within 1.2e-10)
QUALITY_MEAN_RTOL, QUALITY_MEAN_ATOL = 1e-3, 1e-10
QUALITY_MAX_TOL = 1e-5  # its max |.|
FIXED_DT_STEPS = 8


def _mean_close(got, want):
    return abs(got - want) <= QUALITY_MEAN_ATOL + QUALITY_MEAN_RTOL * abs(want)


def _cpu_posq(table):
    """A CPU copy of ``table`` for the density-mode P2G (posq only: it reads
    nothing else)."""
    return dataclasses.replace(table, posq=table.posq.cpu(), dyn=torch.empty(0, dtype=torch.int32),
                               lost=table.lost.cpu())


def run_quality(label, state, tol, card):
    """[quality]: ``sim/quality.physics_quality`` of ``state`` on the card
    (one launch of the density-mode p2g, counted alone), and the card's
    marker and drift against the plain version on a CPU copy of the same
    table: marker and interior count exact, mean within ``_mean_close``,
    max within QUALITY_MAX_TOL. Raises on a mismatch or a non-finite
    value; the physics values are reported, not gated."""
    from blub_tpu_torch.ops import cuda
    from blub_tpu_torch.sim.dense_transfer import density_and_marker
    from blub_tpu_torch.sim.quality import drift_of, physics_quality

    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    q = physics_quality(state, tol)
    ms = 1e3 * (time.perf_counter() - t0)
    launches = {k: v for k, v in cuda.launch_counts().items() if v}
    rho, marker = density_and_marker(state.table)
    plain_rho, plain_marker = density_and_marker(_cpu_posq(state.table))
    got, want = drift_of(rho, marker), drift_of(plain_rho, plain_marker)
    res = {"quality": q, "ms": ms, "launches": launches, "interior_cells": int(got.interior),
           "plain_interior_cells": int(want.interior), "drift": float(got.mean), "plain_drift": float(want.mean),
           "err_max": float(got.max), "plain_err_max": float(want.max),
           "marker_equal": bool(torch.equal(marker.cpu(), plain_marker)), "card": card}
    log(f"[quality] {label}: {json.dumps(q)}; interior fluid cells {res['interior_cells']} (plain "
        f"{res['plain_interior_cells']}), drift {res['drift']:.9f} (plain {res['plain_drift']:.9f}), max "
        f"{res['err_max']:.7f} (plain {res['plain_err_max']:.7f}), marker equal {res['marker_equal']}; "
        f"{ms:.3f} ms with its host read, launches {launches} [{card}]")
    if not all(np.isfinite([res["drift"], res["err_max"], q["max_divergence"]])):
        raise AssertionError(f"quality {label}: a non-finite value: {res}")
    if launches != {"p2g": 1}:
        raise AssertionError(f"quality {label}: the card's quality launched {launches}, not one p2g")
    if not (res["marker_equal"] and res["interior_cells"] == res["plain_interior_cells"]
            and _mean_close(res["drift"], res["plain_drift"])
            and abs(res["err_max"] - res["plain_err_max"]) <= QUALITY_MAX_TOL):
        raise AssertionError(f"quality {label}: the card differs from the plain version: {res}")
    return res


def run_mesh_quality(ctx, params, state, card):
    """[quality] mesh dam: ``physics_quality`` with ``ShardedPhases`` on this
    rank's slab (the density through p2g on the slab's window, the edge
    planes' neighbours through the halo, the sums all-reduced) against the
    single-card quality of ``gather_sm_state``: the same solve numbers, the
    interior count exact, the drift within ``_mean_close``."""
    from blub_tpu_torch.ops import cuda
    from blub_tpu_torch.parallel.sharded_sm import ShardedPhases, gather_sm_state
    from blub_tpu_torch.sim.quality import density_drift, physics_quality

    tol = params.solver_vel.error_tolerance
    phases = ShardedPhases(params, ctx)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    ctx.reset_tally()
    q = physics_quality(state, tol, phases)
    launches = {k: v for k, v in cuda.launch_counts().items() if v}
    tally = {kind: dict(v) for kind, v in ctx.tally.items()}
    got = density_drift(state.table, phases)
    whole = gather_sm_state(ctx, state)
    qw = physics_quality(whole, tol)
    want = density_drift(whole.table)
    res = {"quality": q, "whole_quality": qw, "launches": launches, "collectives": tally,
           "interior_cells": int(got.interior), "whole_interior_cells": int(want.interior),
           "drift": float(got.mean), "whole_drift": float(want.mean), "err_max": float(got.max),
           "whole_err_max": float(want.max), "world_size": ctx.n, "card": card}
    log(f"[quality] mesh dam (world size {ctx.n}): {json.dumps(q)}; gathered, single card {json.dumps(qw)}; "
        f"interior {res['interior_cells']} / {res['whole_interior_cells']}, drift {res['drift']:.9f} / "
        f"{res['whole_drift']:.9f}; launches {launches}, collectives {json.dumps(tally)} [{card}]")
    same_solve = all(q[key] == qw[key] for key in ("max_divergence", "solver_converged"))
    if not np.isfinite(res["drift"]) or not same_solve or res["interior_cells"] != res["whole_interior_cells"] \
            or not _mean_close(res["drift"], res["whole_drift"]):
        raise AssertionError(f"quality mesh dam: the mesh differs from the single card: {res}")
    return res


def run_fixed_dt(params, state, card):
    """[fixed dt]: FIXED_DT_STEPS steps of ``multi_step_dense`` (one graph
    launch a step after the runner's eager first one) from a copy of
    ``state`` against as many eager ``step_dense`` calls from another: posq,
    dyn, lost and both pressures bit for bit; then as many more steps
    through the same runner, timed; ms per step both ways, graph launches."""
    from blub_tpu_torch.ops import cuda
    from blub_tpu_torch.sim.step_dense import multi_step_dense, step_dense

    n = FIXED_DT_STEPS
    ref = clone_state(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        ref = step_dense(params, ref)
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / n
    cuda.reset_launch_counts()
    got = multi_step_dense(params, clone_state(state), n)
    torch.cuda.synchronize()
    launches = cuda.launch_counts()
    runner = got.runner
    if runner is None or runner.graph is None or runner.maxn != 1:
        raise AssertionError("fixed dt: multi_step_dense launched no one-branch frame graph")
    pairs = {"posq": (got.table.posq, ref.table.posq), "dyn": (got.table.dyn, ref.table.dyn),
             "lost": (got.table.lost, ref.table.lost), "pressure_vel": (got.pressure_vel, ref.pressure_vel),
             "pressure_den": (got.pressure_den, ref.pressure_den)}
    same = {k: bool(torch.equal(a, b)) for k, (a, b) in pairs.items()}
    first = int(runner.frames.sum())  # graph launches (the runner's first step ran eagerly)
    t0 = time.perf_counter()
    got = multi_step_dense(params, got, n)
    torch.cuda.synchronize()
    graph_ms = 1e3 * (time.perf_counter() - t0) / n
    res = {"steps": n, "same": same, "eager_ms_per_step": eager_ms, "graph_ms_per_step": graph_ms,
           "graph_launches_first_call": first, "graph_launches_timed": int(runner.frames.sum()) - first,
           "capture_s": runner.capture_s, "lost": int(ref.table.lost),
           "launches_first_call": launches, "card": card}
    log(f"[fixed dt] {n} steps of multi_step_dense against {n} eager step_dense calls: {json.dumps(same)}; graph "
        f"launches {first} (the runner's first step eager) then {res['graph_launches_timed']} timed, "
        f"{graph_ms:.3f} ms/step (eager {eager_ms:.3f}); capture "
        f"{res['capture_s']:.3f} s; lost {res['lost']} [{card}]")
    if not all(same.values()):
        raise AssertionError(f"fixed dt: multi_step_dense differs from step_dense: {same}")
    if not (first == n - 1 and res["graph_launches_timed"] == n):
        raise AssertionError(f"fixed dt: not one graph launch a step: {res}")
    return res


def phase_bytes_report(label, trace, grid, k, valid, solids, graph_ms_per_substep, card):
    """[bytes]: each ``ph_*`` phase of an eager trace (device ms per
    substep) beside the bytes ``probes/bandwidth_model.phase_bytes`` gives
    it, the rate that makes and its share of the data-sheet rate; the sum
    of the phases' floors per substep beside the graph frame's ms per
    substep. Raises when a phase of the model is missing from the trace or
    reads no device time."""
    from blub_tpu_torch.probes.timing import HBM_BYTES_PER_S

    model = bwm.phase_bytes(grid, k, valid, solids)
    subs = sum(trace["n_sub"])
    absent = [name for name in bwm.PHASES if not trace["phases"].get(name, {}).get("device_busy_ms", 0.0) > 0]
    if absent:
        raise AssertionError(f"bytes {label}: the trace holds no device time for {absent}")
    rows = {}
    for name in bwm.PHASES:
        ms = trace["phases"][name]["device_busy_ms"] / subs
        rate = model[name] / (ms / 1e3)
        rows[name] = {"bytes": model[name], "device_ms": ms, "floor_ms": bwm.floor_ms(model[name]),
                      "gb_per_s": rate / 1e9, "share_of_peak": rate / HBM_BYTES_PER_S}
        log(f"[bytes] {label} {name}: {model[name]} B, {ms:.5f} ms device per substep, {rate / 1e9:.1f} GB/s "
            f"({100 * rate / HBM_BYTES_PER_S:.1f} % of {HBM_BYTES_PER_S / 1e12:.2f} TB/s), floor "
            f"{rows[name]['floor_ms']:.5f} ms [{card}]")
    floor = bwm.floor_ms(sum(model.values()))
    device = sum(r["device_ms"] for r in rows.values())
    other = {k: v["device_busy_ms"] / subs for k, v in trace["phases"].items() if k not in model}
    res = {"grid": list(grid), "capacity": k, "valid": valid, "solids": solids, "substeps": subs, "phases": rows,
           "floor_ms_per_substep": floor, "eager_device_ms_per_substep": device,
           "graph_ms_per_substep": graph_ms_per_substep, "unmodelled_device_ms_per_substep": other, "card": card}
    log(f"[bytes] {label}: the phases' floors {floor:.4f} ms per substep, their eager device time {device:.4f}, "
        f"the graph frame {graph_ms_per_substep:.4f} ms per substep ({graph_ms_per_substep / floor:.2f}x the "
        f"floors); not modelled, device ms per substep: {json.dumps(other)} [{card}]")
    return res


def run_copy(card, posq, dyn):
    """The table round-trip probe on the dam table: one launch per round
    trip, bit for bit against posq + 1, dyn + 1 (the library call, timed in
    the same call)."""
    from blub_tpu_torch.ops import cuda
    from blub_tpu_torch.probes import copy_bw

    cuda.reset_launch_counts()
    copy_bw.round_trip(posq, dyn)
    copy_bw.round_trip(posq, dyn, halo=True)
    torch.cuda.synchronize()
    launches = cuda.launch_counts()["copy"]
    if launches != 2:
        raise AssertionError(f"copy: two round trips made {launches} launches, not one each")
    res = copy_bw.measure(posq, dyn)  # raises on any bit difference
    res.update(launches=launches, card=card)
    log("[copy] " + json.dumps(res))
    lib = res["plain"]["ms"]
    for name in ("kernel", "kernel_halo", "plain"):
        r = res[name]
        log(f"[copy] {name}: {r['ms']:.4f} ms device ({r['host_paced_ms']:.4f} host-paced), {r['gb_per_s']:.0f} GB/s, "
            f"bound {res['bound_ms']:.4f} ms ({r['ms'] / res['bound_ms']:.2f}x), {r['ms'] / lib:.3f}x the library "
            f"call (posq + 1, dyn + 1: {lib:.4f} ms) [{card}]")
    return res


def _launched(phase: str, names) -> dict:
    """The launch counts since the last reset; raises if one of ``names``
    never launched."""
    from blub_tpu_torch.ops import cuda

    launches = cuda.launch_counts()
    missing = [k for k in names if not launches[k]]
    if missing:
        raise AssertionError(f"{phase}: kernels never launched on its path: {missing}")
    return launches


def run_relops(card):
    """The rel16 op probe: checked on every case, then timed."""
    from blub_tpu_torch.ops import cuda
    from blub_tpu_torch.probes import relops

    err = relops.check()
    cuda.reset_launch_counts()
    res = relops.measure()
    res.update(max_abs_err=err, launches=_launched("relops", ("relops",))["relops"], card=card)
    log("[relops] " + json.dumps(res))
    log(f"[relops] {res['ms']:.5f} ms device per [8, 128] call, its launch floor (the kernel on [1, 1]) "
        f"{res['launch_floor_ms']:.5f}, bound {res['bound_ms']:.7f} ms by {res['bound_by']} [{card}]")
    return res


def run_yz_floor(card, posq, dyn, k):
    """The floor variants on the dam table's y-stage input (k + slack slots
    -> k): each checked, then timed; then read on the highres table (seeded
    here, freed after)."""
    from blub_tpu_torch.ops import cuda, rebin
    from blub_tpu_torch.probes import yz_floor
    from blub_tpu_torch.sim.slot_major import BYTES_PER_SLOT

    errs = yz_floor.check(posq, dyn, 2, k)
    cuda.reset_launch_counts()
    variants = yz_floor.measure(posq, dyn, 2, k)
    launches = _launched("yz_floor", ("yz_floor", "yz_floor_read", "pack_yz"))
    res = {"k_in": posq.shape[0], "k_out": k, "s": 2, "max_abs_err": errs, "variants": variants,
           "launches": {n: launches[n] for n in ("yz_floor", "yz_floor_read", "pack_yz")}, "card": card}
    slack = rebin.default_slack(HIGHRES_K * BYTES_PER_SLOT * int(np.prod(HIGHRES_GRID)), HIGHRES_K)
    hp, hd, _ = yz_floor.seeded_table(HIGHRES_GRID, HIGHRES_K, pad=slack)
    res["highres"] = {"grid": list(HIGHRES_GRID), "k_in": hp.shape[0], "k_out": HIGHRES_K, "s": 2,
                      "max_abs_err": yz_floor.check(hp, hd, 2, HIGHRES_K, ("read",))["read"],
                      "read": yz_floor.measure(hp, hd, 2, HIGHRES_K, variants=("read",))["read"]}
    del hp, hd
    torch.cuda.empty_cache()
    log("[yz_floor] " + json.dumps(res))
    rows = [(f"dam {v}", r) for v, r in variants.items()] + [("highres read", res["highres"]["read"])]
    for v, r in rows:
        log(f"[yz_floor] {v}: {r['ms']:.4f} ms device ({r['host_paced_ms']:.4f} host-paced), "
            f"{r['gb_per_s']:.0f} GB/s, bound {r['bound_ms']:.4f} ms ({r['ms'] / r['bound_ms']:.2f}x), "
            f"plain {r['plain_ms']:.3f} ms, library {r['library_ms']} [{card}]")
    return res


def run_rebin_sweep(card, posq, dyn, lost, slack):
    """Jiggle + rebin chains over amplitudes and (s, slack)."""
    from blub_tpu_torch.ops import cuda
    from blub_tpu_torch.probes import rebin_sweep

    rebin_sweep.check(posq, dyn, lost)
    cuda.reset_launch_counts()
    res = rebin_sweep.sweep(posq, dyn, lost, dam_slack=slack)
    launches = _launched("rebin sweep", ("pack", "pack_yz"))
    res.update(launches={k: launches[k] for k in ("pack", "pack_yz")}, card=card)
    log("[rebin sweep] " + json.dumps(res))
    return res


def run_pcg_passes(card):
    """k1 and k2 alone at the highres and dam shapes, and the persistent
    solve's device ms per iteration beside them."""
    from blub_tpu_torch.ops import cuda
    from blub_tpu_torch.probes import pcg_passes

    res = {}
    for name, shape in pcg_passes.SHAPES.items():
        inp = pcg_passes.inputs(shape)
        err = pcg_passes.check(inp)
        cuda.reset_launch_counts()
        r = pcg_passes.measure(inp)
        r.update(max_abs_err=err, launches=_launched(f"pcg passes {name}", ("pcg",))["pcg"], card=card)
        res[name] = r
        log(f"[pcg passes] {name} " + json.dumps(r))
        log(f"[pcg passes] {name}: " + ", ".join(
            f"{k} {r[k]['device_ms']:.5f} ms device against its bound {r[k]['bound_ms']:.5f} "
            f"({r[k]['device_ms'] / r[k]['bound_ms']:.2f}x)" for k in ("k1", "k2")) +
            f"; k1 + k2 {r['solve']['k1_plus_k2_device_ms']:.5f}, the persistent solve "
            f"{r['solve']['ms_per_iteration']:.5f} per iteration [{card}]")
    return res


def ptxas_report(log_text: str):
    """{function: registers, static shared memory, stack frame, spill
    stores, spill loads} per kernel from a ``-Xptxas -v`` log."""
    out, fn = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line.split("'")[1] if "'" in line else line.split("Function properties for")[1].strip()
            out.setdefault(fn, {"registers": None, "smem": 0, "stack_frame": None, "spill_stores": None,
                                "spill_loads": None})
        elif fn and "Used" in line and "registers" in line:
            out[fn]["registers"] = int(line.split("Used")[1].split("registers")[0])
            out[fn]["smem"] = next((int(w.split()[0]) for w in line.split(",") if w.strip().endswith("smem")), 0)
        elif fn and "spill stores" in line:
            words = line.replace(",", "").split()  # N bytes stack frame N bytes spill stores N bytes spill loads
            out[fn]["stack_frame"], out[fn]["spill_stores"], out[fn]["spill_loads"] = (
                int(words[0]), int(words[4]), int(words[8]))
    return out


def reference_small(card, k):
    """The port on the card against the plain PyTorch path on the CPU at the
    test size, with ``k`` slots: 3 CFL frames."""
    from blub_tpu_torch.core.seeding import add_fluid_cube
    from blub_tpu_torch.core.types import SimParams
    from blub_tpu_torch.sim.slot_major import cell_coord, rel_to_pos, unpack_posq
    from blub_tpu_torch.sim.step_dense import make_dense_state, multi_frame_dense

    g = (16, 8, 8)
    pos = add_fluid_cube(g, (1, 1, 1), (8, 6, 7), 10**9)
    params = SimParams(grid_dim=g, dt=1.0 / 120.0, gravity_grid=(0.0, -981.0, 0.0), num_particles=pos.shape[0])
    out = {}
    for dev in ("cuda", "cpu"):
        s, subs = multi_frame_dense(params, make_dense_state(params, pos, k, device=dev), 3)
        t = s.table
        rx, ry, rz, v = unpack_posq(t.posq[:, 0], t.posq[:, 1])
        p = [rel_to_pos(r, cell_coord(g, a, r.device)) for a, r in enumerate((rx, ry, rz))]
        com = [pa[v == 1].double().mean().item() for pa in p]
        out[dev] = (t.num_particles().item(), t.lost.item(), com, ints(subs))
    (cg, lg, comg, sg), (cc, lc, comc, sc) = out["cuda"], out["cpu"]
    d = max(abs(a - b) for a, b in zip(comg, comc))
    log(f"[ref] 16x8x8 K={k} 3 frames card vs CPU plain: count {cg}/{cc} lost {lg}/{lc} n_sub {sg}/{sc} "
        f"centre-of-mass diff {d:.3g} cells (tolerance 1e-3) [{card}]")
    if (cg, lg, sg) != (cc, lc, sc) or cg + lg != pos.shape[0] or d > 1e-3:
        raise AssertionError("card run disagrees with the plain CPU run")


def untraced_window(run_frames) -> dict:
    """Wall ms per frame of TRACE_FRAMES untraced frames, after one warm-up
    frame; ``run_frames(n)`` runs n frames from one snapshot at every call
    and returns their n_sub, so these are the frames ``trace_frames`` traces
    later. Taken before the profiler first runs in the process: after it, a
    launch costs the host more ([graph launch] against [graph branch cost]),
    and the first launch of the window would count as idle."""
    run_frames(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    subs = run_frames(TRACE_FRAMES)
    torch.cuda.synchronize()
    return {"n_sub": subs, "ms_per_frame": 1e3 * (time.perf_counter() - t0) / TRACE_FRAMES}


def trace_frames(run_frames, untraced, ms_per_frame, out_dir, card, label):
    """Device time over TRACE_FRAMES frames through ``runtime/profiler.py``
    (``trace``, then ``parse_phase_trace``: the kernels joined to the
    ``ph_*`` ranges on the GPU timeline), after one profiled warm-up frame;
    ``run_frames(n)`` runs n frames and returns their n_sub. Eager frames
    attribute their device time to phases; graph replays have no ``ph_*``
    ranges, so theirs lands in "other". The idle share compares the traced
    device busy time per frame with the wall time per frame of the same
    frames untraced (``untraced_window``, taken before any profiler ran);
    the traced run's own idle share compares it with the time from the
    traced frames' first device activity to the end of their last (what
    the profiler's host cost leaves idle while it traces); the timed run's
    ms/frame is reported beside them. The chrome trace is
    ``<out_dir>/<label>/blub.trace.json``."""
    from blub_tpu_torch.runtime import profiler

    with profiler.trace(out_dir / label / "warm"):
        run_frames(1)
        torch.cuda.synchronize()
    with profiler.trace(out_dir / label) as prof:
        subs = run_frames(TRACE_FRAMES)
        torch.cuda.synchronize()
    phases = {k: {"device_busy_ms": v} for k, v in profiler.parse_phase_trace(out_dir / label / "blub.trace.json")
              .items()}
    for e in prof.events():
        if e.name in phases and str(e.device_type).endswith("CPU"):
            phases[e.name]["host_ms"] = phases[e.name].get("host_ms", 0.0) + e.cpu_time_total / 1e3
    kernels, start, end = {}, float("inf"), 0.0
    for e in profiler.trace_events(out_dir / label / "blub.trace.json"):
        if e.get("ph") == "X" and e.get("cat") in profiler.DEVICE_CATEGORIES:
            kernels[e["name"][:60]] = kernels.get(e["name"][:60], 0.0) + e["dur"] / 1e3
            start, end = min(start, e["ts"]), max(end, e["ts"] + e["dur"])
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    busy_per_frame = sum(v["device_busy_ms"] for v in phases.values()) / TRACE_FRAMES
    span_per_frame = (end - start) / 1e3 / TRACE_FRAMES if end > start else float("nan")
    untraced_ms = untraced["ms_per_frame"]
    res = {"frames": TRACE_FRAMES, "n_sub": subs, "device_busy_ms_per_frame": busy_per_frame,
           "untraced_n_sub": untraced["n_sub"], "untraced_ms_per_frame": untraced_ms,
           "timed_run_ms_per_frame": ms_per_frame, "device_idle_share": 1.0 - busy_per_frame / untraced_ms,
           "traced_run_span_ms_per_frame": span_per_frame,
           "traced_run_idle_share": 1.0 - busy_per_frame / span_per_frame,
           "phases": phases, "top_device_ops_ms": top, "card": card}
    log(f"[trace {label}] " + json.dumps(res))
    if busy_per_frame <= 0:
        raise AssertionError(f"trace {label}: no device activity in the trace")
    return res


def replay_nodes(graph) -> dict:
    """The device activities of one replay of ``graph`` under torch.profiler
    (its nodes that ran on the card), by kind."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    kinds = {"kernel": 0, "memcpy": 0, "memset": 0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        kinds["memcpy" if name.startswith("memcpy") else "memset" if name.startswith("memset") else "kernel"] += 1
    return dict(kinds, total=sum(kinds.values()))


def force_branch(runner, params, n):
    """Set the runner's static max speed so that the next frame's count on
    the card is n: (n - 0.5) cells per substep at the runner's CFL target."""
    runner.state.max_speed.fill_(float(np.float32((n - 0.5) * runner.cfl_target / params.dt)))


def branch_costs(runner, params, label, card, frames=16, reps=3):
    """Before the profiler first runs in the process: per branch n of the
    frame graph, ``frames`` launches forced into it (back to back, each
    after its max-speed fill) against as many launches of the plain graph
    of branch n (its capture alone, without the head and the IF node), from
    one snapshot: wall ms per frame (the device cost of the head and the
    IF node is the difference) and host ms per launch into a busy stream;
    then ``reps`` launches of each after a sync, host ms each. The runner's
    static state is restored afterwards; the plain launches count their
    kernels as the branch's (they bump its frame count)."""
    snap = clone_state(runner.state)
    res = {}
    for n in range(1, runner.maxn + 1):
        plain = runner.graph.branches[n - 1].segments[0]  # a single-card branch: one segment, no loop
        plain.instantiate()
        for kind, launch in (("if", runner.graph.replay), ("plain", plain.replay)):
            runner.load(snap)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(frames):
                force_branch(runner, params, n)
                launch()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            after_sync = []
            for _ in range(reps):
                force_branch(runner, params, n)
                torch.cuda.synchronize()
                a = time.perf_counter()
                launch()
                after_sync.append(1e3 * (time.perf_counter() - a))
                torch.cuda.synchronize()
            res.setdefault(n, {})[kind] = {"wall_ms_per_frame": 1e3 * (t2 - t0) / frames,
                                           "host_ms_per_launch_busy": 1e3 * (t1 - t0) / frames,
                                           "host_ms_per_launch_after_sync": after_sync}
        res[n]["head_and_if_ms_per_frame"] = res[n]["if"]["wall_ms_per_frame"] - res[n]["plain"]["wall_ms_per_frame"]
    runner.load(snap)
    torch.cuda.synchronize()
    log(f"[graph branch cost] {label}: per branch, {frames} launches of the frame graph forced into it against "
        f"{frames} of the branch's plain graph, before any profiler ran " + json.dumps({"branch": res, "card": card}))
    return res


def graph_launch_times(runner, params, label, card, reps=3):
    """Per branch n of the frame graph: its nodes (``ops/graph.node_counts``
    of the branch graph that its IF node's body holds, beside the head's),
    the device nodes of one launch that the max speed forces into it
    (``replay_nodes``), then the host ms of ``replay()`` (the graph launch)
    and the wall ms from it to the end of the frame, each launch after a
    sync, ``reps`` times, after the profiler has run in the process (against
    ``branch_costs``, before it). The launches advance the runner's static state
    (run after everything that reads it); their kernel launches are counted
    through the graph's frame counts."""
    from blub_tpu_torch.ops import graph

    res, nodes = {}, {"head": graph.node_counts(runner.graph.head)}
    for n in range(1, runner.maxn + 1):
        force_branch(runner, params, n)
        nodes[n] = {"branch_graph": graph.node_counts(runner.graph.branches[n - 1]),  # its chain
                    "launch_device": replay_nodes(runner.graph)}
        nodes[n]["branch_graph_per_substep"] = nodes[n]["branch_graph"]["total"] / n
        runs = []
        for _ in range(reps):
            force_branch(runner, params, n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.graph.replay()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            runs.append({"launch_host_ms": 1e3 * (t1 - t0), "replay_wall_ms": 1e3 * (time.perf_counter() - t0)})
        res[n] = runs
    log(f"[graph launch] {label}: " + json.dumps({"branch": res, "card": card}))
    log(f"[graph nodes] {label}: nodes of the head and of each branch's body, and the device nodes of one "
        f"launch forced into it " + json.dumps({"branch": nodes, "card": card}))
    return {"branch": res, "nodes": nodes}


def check_branches(params, state, card):
    """Each branch n = 1 .. DAM_MAX_SUB of the dam's frame graph, forced by
    the max speed, against ``eager_frame(..., n)`` from the same state, bit
    for bit (table, pressures, lost, max speed, solver stats, step_index),
    with n_sub == n on the card and the same launch counts. The runner's
    static state is restored afterwards."""
    from blub_tpu_torch.ops import cuda
    from blub_tpu_torch.sim.step_dense import eager_frame, multi_frame_dense

    runner = state.runner
    snap = clone_state(state)

    def bits(s):
        return [s.table.posq, s.table.dyn, s.table.lost, s.pressure_vel, s.pressure_den, s.max_speed,
                s.stats_vel.error, s.stats_vel.iterations, s.stats_den.error, s.stats_den.iterations, s.step_index]

    res = {}
    for n in range(1, DAM_MAX_SUB + 1):
        start = clone_state(snap)
        start.max_speed.fill_(float(np.float32((n - 0.5) * DAM_CFL / params.dt)))
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        ref = eager_frame(params, clone_state(start), lambda i, m: None, n)
        eager_counts = cuda.launch_counts()
        got, subs = multi_frame_dense(params, dataclasses.replace(start, runner=runner), 1, cfl_target=DAM_CFL,
                                      max_substeps=DAM_MAX_SUB)
        graph_counts = {k: v - eager_counts[k] for k, v in cuda.launch_counts().items()}
        same = [bool(torch.equal(a, b)) for a, b in zip(bits(got), bits(ref))]
        res[n] = {"n_sub": int(subs[0]), "bits_equal": all(same), "launches_equal": graph_counts == eager_counts,
                  "launches": {k: v for k, v in graph_counts.items() if v}}
    runner.load(snap)
    log("[graph branches] dam: each branch forced against eager_frame(..., n) " + json.dumps(
        {"branch": res, "card": card}))
    bad = {n: r for n, r in res.items() if not (r["n_sub"] == n and r["bits_equal"] and r["launches_equal"])}
    if bad:
        raise AssertionError(f"[graph branches] a forced branch differs from its eager frame: {bad}")
    return res


# ---------------------------------------------------------------------------
# the history solve, the renderer, the app, every scene file


def check_pcg_history(pcg_inputs, dt, label, card, reps=5):
    """[pcg history] on one substep's two solves (velocity, density): the
    history instantiation gives the production solve's pressure, iterations
    and error bit for bit; its history is finite exactly for the iterations
    it ran, +inf after, and its last entry is the stats error; against the
    plain version with history run for the kernel's iteration count every
    entry is within the pcg rows' tolerance (1e-3 of the entry + 1e-3 of the
    solver tolerance: the dot products sum in another order), and the plain
    solve with the real configuration stops within one check window of the
    kernel (reported: whether at the same iteration). Then device ms of the
    two solves with the history and without, back to back, and the history
    solves' CUDA-event ms beside the plain version's."""
    from blub_tpu_torch.ops import pcg
    from blub_tpu_torch.sim.pressure import solve_pressure_plain

    solves, err = [], 0.0
    for p0, rhs, marker, cfg in pcg_inputs:
        got = pcg.solve_pressure(p0, rhs, marker, cfg, dt, with_history=True)
        prod = pcg.solve_pressure(p0, rhs, marker, cfg, dt)
        its = int(got.stats.iterations)
        hist = got.history.cpu().numpy()
        e = got.stats.error.item()
        plain_its = int(solve_pressure_plain(p0, rhs, marker, cfg, dt, with_history=True).stats.iterations)
        fixed = dataclasses.replace(cfg, max_num_iterations=its, error_tolerance=0.0)
        ref = solve_pressure_plain(p0, rhs, marker, fixed, dt, with_history=True).history.cpu().numpy()
        diff = np.abs(hist[:its] - ref)
        over = float((diff - (1e-3 * np.abs(ref) + 1e-3 * cfg.error_tolerance)).max())
        checks = {
            "production_bits": all(torch.equal(a, b) for a, b in (
                (got.pressure, prod.pressure), (got.stats.iterations, prod.stats.iterations),
                (got.stats.error, prod.stats.error))),
            "finite_exactly_for_its": bool(np.all(np.isfinite(hist[:its])) and np.all(np.isposinf(hist[its:]))),
            "last_entry_is_error": bool(its > 0 and hist[its - 1] == np.float32(e)),
            "within_tolerance": over <= 0.0,
            "plain_within_one_check_window": abs(its - plain_its) <= cfg.error_check_frequency,
        }
        solves.append({"iterations": its, "plain_iterations": plain_its, "same_iterations": its == plain_its,
                       "max_abs_err": float(diff.max()), "error": e, "history_first": hist[:3].tolist(),
                       "history_last": float(hist[its - 1]), "checks": checks})
        err = max(err, float(diff.max()))
        if not all(checks.values()):
            raise AssertionError(f"[pcg history] {label}: {solves[-1]}")

    def solves_k(history):
        return lambda: [pcg.solve_pressure(*a, dt, with_history=history) for a in pcg_inputs]

    # the bound of the two solves (as time_kernels counts the pcg row's:
    # rhs, warm start and marker read, pressure written, ~30 operations per
    # fluid cell and iteration) plus the history written once
    n = pcg_inputs[0][1].numel()
    bms, by = bound_ms(sum(n * (4 + 4 + 1 + 4) + 4 * a[3].max_num_iterations for a in pcg_inputs),
                       sum(s["iterations"] * int((a[2] == 1).sum().item()) * 30 for s, a in zip(solves, pcg_inputs)))
    res = {"shape": list(pcg_inputs[0][1].shape), "solves": solves, "max_abs_err": err, "bound_ms": bms,
           "bound_by": by,
           "device_ms_history": device_ms(solves_k(True), reps), "device_ms_production": device_ms(solves_k(False), reps),
           "ms": cuda_ms(solves_k(True), reps),
           "plain_ms": cuda_ms(lambda: [solve_pressure_plain(*a, dt, with_history=True) for a in pcg_inputs], 1),
           "blocks_history": pcg.solve_blocks(tuple(pcg_inputs[0][1].shape), True),
           "blocks_production": pcg.solve_blocks(tuple(pcg_inputs[0][1].shape)), "card": card}
    log(f"[pcg history] {label} " + json.dumps(res))
    return res


def _image_diff(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {"max_lsb": int(d.max()), "share_of_pixels_differing": float((d > 0).mean()),
            "p99_lsb": float(np.percentile(d, 99))}


def _within_test_bounds(r, max_lsb=True):
    """tests/test_render.py's bounds on the card's image against the plain
    one: max 8 LSB, under 2 % of the pixels differ, 99th percentile 0."""
    return (r["max_lsb"] <= 8 or not max_lsb) and r["share_of_pixels_differing"] < 0.02 and r["p99_lsb"] == 0


def run_render(params, state, out_dir, card):
    """[render] at the dam state: for each (fluid, volume) mode, the
    renderer on the card (particles as the state's device tensors) and the
    plain renderer on the CPU on the same particles; ms per frame at 640x480
    (the first draw, which computes the background, and the mean of
    RENDER_REPS more) and the plain version's seconds. The images are held
    to test_render.py's bounds at its own size (160x120) in every mode, and
    at 640x480 in every mode but the screen-space fluid's maximum: there a
    refracted pixel whose exit point rounds the other way gathers another
    background pixel, and over 307,200 pixels the largest such step can
    exceed 8 LSB; its maximum is reported, its share and 99th percentile
    held. The images go to
    ``<out>/render/``."""
    from blub_tpu_torch.render import device_ssf
    from blub_tpu_torch.render.png import write_png
    from blub_tpu_torch.render.renderer import (
        FluidRenderingMode, RenderSettings, SceneRenderer, VolumeVisualizationMode,
    )

    pos, vel = state.table.particles()
    pos_np, vel_np = pos.cpu().numpy(), vel.cpu().numpy()
    field = state.pressure_vel.cpu().numpy()
    w, h = RENDER_SIZE
    res = {"particles": int(pos.shape[0]), "size": [w, h], "modes": {}, "card": card}
    for fluid, volume in RENDER_MODES:
        def renderer(device, size=RENDER_SIZE):
            return SceneRenderer(params.grid_dim, RenderSettings(
                width=size[0], height=size[1], fluid_mode=FluidRenderingMode(fluid),
                volume_mode=VolumeVisualizationMode(volume)), device=device)

        card_r = renderer("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = card_r.draw(pos, vel, field=field)  # returns a host image: the draw has finished
        first_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(RENDER_REPS):
            img = card_r.draw(pos, vel, field=field)
        ms = 1e3 * (time.perf_counter() - t0) / RENDER_REPS
        # the frame's PyTorch part on the card alone: the particle splat or
        # the fluid pass (the rest of the frame is numpy on the host)
        device_part = {"particles_velocity": lambda: card_r._splat_device(pos, card_r.particle_radius, True),
                       "particles_index": lambda: card_r._splat_device(pos, card_r.particle_radius, True),
                       "screen_space_fluid": lambda: device_ssf.fluid_pass(
                           pos, *card_r._background(), card_r.camera, card_r.particle_radius,
                           card_r.settings.grid_to_world_scale)}.get(fluid)
        torch_ms = cuda_ms(device_part, RENDER_REPS) if device_part else None
        t0 = time.perf_counter()
        ref = renderer("cpu").draw(pos_np, vel_np, field=field)
        plain_s = time.perf_counter() - t0
        small = _image_diff(renderer("cuda", RENDER_TEST_SIZE).draw(pos, vel, field=field),
                            renderer("cpu", RENDER_TEST_SIZE).draw(pos_np, vel_np, field=field))
        r = {"ms_per_frame": ms, "first_frame_ms": first_ms, "torch_part_ms": torch_ms, "plain_s": plain_s,
             **_image_diff(img, ref),
             "at_test_size": small,
             "not_background": float((img != renderer("cpu").draw(np.zeros((0, 3), np.float32))).any(-1).mean())}
        res["modes"][f"{fluid}/{volume}"] = r
        if out_dir is not None:
            (out_dir / "render").mkdir(parents=True, exist_ok=True)
            write_png(out_dir / "render" / f"{fluid}-{volume}.png", img)
        log(f"[render] {fluid}/{volume}: {ms:.2f} ms/frame (first {first_ms:.1f}; its PyTorch part "
            f"{torch_ms if torch_ms is None else round(torch_ms, 2)} ms), plain {plain_s:.2f} s, "
            f"max {r['max_lsb']} LSB, {100 * r['share_of_pixels_differing']:.3f} % of the pixels differ, "
            f"p99 {r['p99_lsb']}; at 160x120 {json.dumps(small)} [{card}]")
        r["ok"] = _within_test_bounds(small) and _within_test_bounds(r, max_lsb=fluid != "screen_space_fluid")
    res["failed"] = [m for m, r in res["modes"].items() if not r["ok"]]
    log("[render] " + json.dumps(res))
    return res


def _app(argv):
    """blub_tpu_torch.app.main(argv) with the counts reset just before and
    read just after: -> (stdout, seconds, launches)."""
    from blub_tpu_torch import app
    from blub_tpu_torch.ops import cuda

    buf = io.StringIO()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = app.main(argv)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"app {argv}: exit code {rc}")
    return buf.getvalue(), s, cuda.launch_counts()


def run_app(card):
    """[app] on scenes/dam_halfhalf.json in a temporary directory, each
    subcommand as a user would call it (on the card, by default)."""
    from blub_tpu_torch.render.png import read_png

    scene = str(ROOT / APP_SCENE)
    res = {"scene": APP_SCENE, "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        cases = {
            "info": ["info", scene],
            "run --record-fps": ["run", scene, "--record-fps", "60", "--sim-seconds", "0.05", "--output-dir", tmp],
            "screenshot": ["screenshot", scene, "--fluid-mode", "screen_space_fluid", "--sim-seconds", "0.025",
                           "--output-dir", tmp],
            "profile": ["profile", scene, "--trace-out", str(out / "profile.json")],
            "profile --trace-phases": ["profile", scene, "--trace-phases", "--trace-out", str(out / "phases.json")],
            "profile --solver-history": ["profile", scene, "--solver-history"],
        }
        for name, argv in cases.items():
            text, s, launches = _app(argv)
            res[name] = {"s": s, "launches": {k: v for k, v in launches.items() if v}, "stdout": text}
            log(f"[app] {name}: {s:.2f} s, launches {json.dumps(res[name]['launches'])} [{card}]")
        frames = sorted((out / "recording0").glob("*.png"))
        shots = sorted(out.glob("screenshot*.png"))
        imgs = [read_png(p) for p in frames + shots]
        res["pngs"] = {"recording0": [p.name for p in frames], "screenshots": [p.name for p in shots],
                       "shapes": [None if i is None else list(i.shape) for i in imgs]}
        hist = res["profile --solver-history"]
        heads = [line for line in hist["stdout"].splitlines() if "[pcg_solve_kernel<true>]:" in line]
        checks = {
            "run_json": json.loads(res["run --record-fps"]["stdout"].strip().splitlines()[-1])["steps"] == 6,
            "recorded_3_frames": len(frames) == 3,
            "screenshot": len(shots) == 1,
            "pngs_decode": all(i is not None and i.shape == (RENDER_SIZE[1], RENDER_SIZE[0], 3) for i in imgs),
            "run_launched_the_main_path": all(res["run --record-fps"]["launches"].get(k) for k in DAM_KERNELS),
            "history_launched_twice": hist["launches"].get("pcg_history") == 2,
            "history_printed": len(heads) == 2,
            "profile_table": "pcg velocity" in res["profile"]["stdout"],
            "trace_phases_table": "total device" in res["profile --trace-phases"]["stdout"],
        }
    res["checks"] = checks
    log("[app] " + json.dumps(res))
    if not all(checks.values()):
        raise AssertionError(f"[app] {checks}")
    return res


SDF_REPS = 5
# the icospheres baked at the bunny scene's points (stand-ins for scanned
# meshes of tens of thousands of triangles): (subdivisions, every k-th point
# held against the plain version and counted by pair_work)
SDF_ICOSPHERES = ((5, 1), (6, 16))
SDF_BUNNY = "dam_halfhalf_staticbunny.json"
SDF_KERNELS = ("sdf", "sdf_bounds", "sdf_unite", "sdf_keys")  # one launch each per bake


def same_bits(a, b) -> bool:
    """The same f32 bits where not NaN, NaN at the same places (the card and
    the host make NaNs of other payloads)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def sdf_bake(args, card, every=1):
    """One bake on the card: the kernel against its plain version bit for
    bit (on every ``every``-th point; the plain version over all pairs of the
    sample) and the pairs the bake needs (``sdf.pair_work`` on the sample,
    scaled by ``every``); the whole wrapper's ms (CUDA events, host gaps
    included) and device ms (back to back), the Morton order and bounds'
    device ms (``sdf.prepare``) and the kernel's alone (``sdf.run``), also
    on the points in their own order (the grid's raster order: what the
    points' sort buys), the plain version's ms, the bound by operations from
    the needed pairs beside the brute-force one; the bounds, unite and keys
    kernels against their plain versions (``sdf_parts``)."""
    from blub_tpu_torch.ops import sdf

    verts, tris, points = args
    n, t = points.shape[0], tris.shape[0]
    got = sdf.mesh_sdf(*args)
    sample = points[::every].contiguous()
    ref = sdf.mesh_sdf_plain(verts, tris, sample)
    mine = got[::every]
    w = sdf.pair_work(verts, tris, sample)
    if every > 1:
        w = sdf.Work(n, t, *(every * x for x in w[2:]))
    prepared = sdf.prepare(*args)
    own = (torch.arange(n, device=points.device), *prepared[1:])
    nbytes = 16 * n + 12 * (verts.shape[0] + t)
    bms, by = bound_ms(nbytes, sdf.ops(w))
    brute, brute_by = bound_ms(nbytes, sdf.ops_brute(w))
    r = {"points": n, "triangles": t, "sampled_every": every, **w._asdict(),
         "needed_share": w.needed / (n * t), "inside_share": w.inside / (n * t),
         "bits_equal": same_bits(mine, ref), "max_abs_err": (mine - ref).nan_to_num(0.0).abs().max().item(),
         "inside": int((got < 0).sum()),
         "ms": cuda_ms(lambda: sdf.launch(*args), SDF_REPS),
         "device_ms": device_ms(lambda: sdf.launch(*args), SDF_REPS),
         "prepare_device_ms": device_ms(lambda: sdf.prepare(*args), SDF_REPS),
         "kernel_device_ms": device_ms(lambda: sdf.run(prepared, points), SDF_REPS),
         "own_order_kernel_device_ms": device_ms(lambda: sdf.run(own, points), SDF_REPS),
         "plain_ms": cuda_ms(lambda: sdf.mesh_sdf_plain(verts, tris, sample), 1),
         "bound_ms": bms, "bound_by": by, "brute_bound_ms": brute, "brute_bound_by": brute_by}
    r["own_order_bits_equal"] = same_bits(sdf.run(own, points)[::every], ref)
    r["ms_over_bound"] = r["ms"] / bms
    r["kernel_over_bound"] = r["kernel_device_ms"] / bms
    r.update(sdf_parts(verts, tris, points))
    return r


def sdf_parts(verts, tris, points):
    """The bake's preparation kernels against their plain versions on the
    same CUDA tensors (the same operations, bit for bit): ``bounds``,
    ``unite`` and ``point_keys``; each one's device ms, its plain version's
    ms and its bound by bytes (each input read once, each output written
    once)."""
    from blub_tpu_torch.ops import sdf

    n, t = points.shape[0], tris.shape[0]
    ng = -(-t // sdf.GROUP)
    nt = -(-ng // sdf.GROUP)
    vlo, vhi = torch.aminmax(verts, dim=0)
    tb, key, tt = sdf.bounds(verts, tris)
    perm = torch.argsort(key)
    plo, phi = torch.aminmax(points, dim=0)
    row = 4 * sdf.FIELDS + 4 * sdf.TERMS  # a triangle's bounds and terms
    parts = {
        # corners and indices in, bounds, a key and terms out per triangle
        "bounds": (lambda: sdf.bounds(verts, tris), lambda: sdf.bounds_plain(verts, tris, vlo, vhi),
                   12 * (verts.shape[0] + t) + 24 + (row + 8) * t),
        # the order and a triangle's bounds and terms in, the same out; the groups and tiles out
        "unite": (lambda: sdf.unite(tb, tt, perm), lambda: sdf.unite_plain(tb, tt, perm),
                  (8 + 2 * row) * t + 4 * (sdf.FIELDS * ng + sdf.TILE_FIELDS * nt)),
        # the points and their box in, a key out per point
        "keys": (lambda: sdf.point_keys(points), lambda: sdf._morton(points, plo, phi).int(), 16 * n + 24),
    }
    res = {}
    for name, (kernel, plain, nbytes) in parts.items():
        got, ref = kernel(), plain()
        got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, ref))
        fin = [torch.isfinite(b.float()) for b in ref]
        res[name] = {"bits_equal": all(same_bits(a.float(), b.float()) if a.is_floating_point() else torch.equal(a, b)
                                       for a, b in zip(got, ref)),
                     "max_abs_err": max((float((a.float() - b.float())[f].abs().max()) if f.any() else 0.0)
                                        for a, b, f in zip(got, ref, fin)),
                     "device_ms": device_ms(kernel, SDF_REPS), "plain_ms": cuda_ms(plain, 1)}
        res[name]["bound_ms"], res[name]["bound_by"] = bound_ms(nbytes, 0)
    res["bounds"]["flagged"] = int((~torch.isfinite(tb[sdf.G2])).sum())
    return res


def run_sdf(card):
    """[sdf]: every scene file's solid bakes at their real shape (the points
    and meshes ``core/models.solid_bakes`` gives ``build_solid_objects``),
    then icospheres (``SDF_ICOSPHERES``) at the bunny scene's points:
    ``sdf_bake`` each; the phase's sdf launches. Fails if a bake's bits
    differ from the plain version's or its kernel takes less than its bound
    (the count of needed pairs would be wrong)."""
    from blub_tpu_torch.core.config import load_scene
    from blub_tpu_torch.core.models import icosphere_mesh, solid_bakes
    from blub_tpu_torch.ops import cuda

    def up(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).cuda()

    res = {"scenes": {}, "meshed": {}, "card": card}
    cuda.reset_launch_counts()
    bakes = []
    for path in sorted((ROOT / "scenes").glob("*.json")):
        for i, b in enumerate(solid_bakes(load_scene(path))):
            if b.box:
                continue
            res["meshed"][path.name] = res["meshed"].get(path.name, 0) + 1
            bakes.append((f"{path.name}:{i}", b.mesh_verts, b.mesh_faces, b.local, 1, b.standin))
            if path.name == SDF_BUNNY:
                bakes += [(f"icosphere_mesh({k}) at {path.name}:{i}", *icosphere_mesh(k), b.local, every, None)
                          for k, every in SDF_ICOSPHERES]
    for key, v, f, pts, every, standin in bakes:
        args = [up(v, np.float32), up(f, np.int32), up(pts, np.float32)]
        r = sdf_bake(args, card, every)
        r["standin"] = standin
        res["scenes"][key] = r
        parts = "; ".join(f"{k} kernel: bits equal {r[k]['bits_equal']}, device {r[k]['device_ms']:.4f} ms (plain "
                          f"{r[k]['plain_ms']:.3f})" for k in ("bounds", "unite", "keys"))
        sampled = f" (plain and pair_work on every {every}th point)" if every > 1 else ""
        log(f"[sdf] {key}: {r['points']} points x {r['triangles']} triangles"
            f"{f' ({standin} stand-in)' if standin else ''}{sampled}: bits equal {r['bits_equal']}, {r['inside']} "
            f"inside; needed {r['needed_share']:.5f} of the pairs' distance parts; ray parts inside the yz box "
            f"{r['inside_share']:.5f}; {r['ms']:.4f} ms (device {r['device_ms']:.4f}: prepare "
            f"{r['prepare_device_ms']:.4f}, kernel {r['kernel_device_ms']:.4f}, on the points' own order "
            f"{r['own_order_kernel_device_ms']:.4f}; plain {r['plain_ms']:.2f}), bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} from the needed pairs ({r['ms_over_bound']:.2f}x; the "
            f"kernel alone {r['kernel_over_bound']:.2f}x), brute force {r['brute_bound_ms']:.4f}; "
            f"{r['bounds']['flagged']} triangles flagged; {parts} [{card}]")
        del args
    res["launches"] = {k: cuda.launch_counts()[k] for k in SDF_KERNELS}
    torch.cuda.empty_cache()
    log("[sdf] " + json.dumps(res))
    bad = [k for k, r in res["scenes"].items()
           if not (r["bits_equal"] and r["own_order_bits_equal"]
                   and all(r[k]["bits_equal"] for k in ("bounds", "unite", "keys")))]
    if bad:
        raise AssertionError(f"[sdf] a kernel's bits differ from its plain version's: {bad}")
    under = [k for k, r in res["scenes"].items() if r["kernel_over_bound"] < 1]
    if under:
        raise AssertionError(f"[sdf] a kernel faster than its bound (the needed pairs miscounted): {under}")
    return res


def bake_split(path):
    """A scene file's solid bakes replayed step by step on the card, each
    step waited for: ms of the host grid (``solid_bakes``: model-local voxel
    centres in f64), the upload, ``ops/sdf.mesh_sdf`` (the index check, the
    Morton order and bounds, the kernel) and the read back; cube models
    without an OBJ take the analytic box on the host."""
    from blub_tpu_torch.core.config import load_scene
    from blub_tpu_torch.core.models import box_sdf, solid_bakes
    from blub_tpu_torch.ops import sdf

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bakes = solid_bakes(load_scene(path))
    split = {"grid": 1e3 * (time.perf_counter() - t0), "upload": 0.0, "kernel": 0.0, "read": 0.0, "host_box": 0.0}
    for b in bakes:
        t0 = time.perf_counter()
        if b.box:
            box_sdf(b.local, (0, 0, 0), (1, 1, 1))
            split["host_box"] += 1e3 * (time.perf_counter() - t0)
            continue
        args = [torch.from_numpy(np.ascontiguousarray(a, dt)).cuda() for a, dt in
                ((b.mesh_verts, np.float32), (b.mesh_faces, np.int32), (b.local, np.float32))]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = sdf.mesh_sdf(*args)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out.cpu()
        t3 = time.perf_counter()
        split["upload"] += 1e3 * (t1 - t0)
        split["kernel"] += 1e3 * (t2 - t1)
        split["read"] += 1e3 * (t3 - t2)
    return split


def run_scenes(card, meshed):
    """[scenes]: every scenes/*.json (the one whose name starts with '#'
    too) for SCENE_FRAMES frames through the app's run code on the card,
    at the app's default capacity. Each scene's n0, lost, n_sub per frame
    and ms per frame (the host's wall time of each ``Scene.step``, which
    waits for the card only when the host is ``runtime/scene.RING`` frames ahead;
    the first frame runs eagerly and the second captures the graph), its
    start-up seconds (the Scene's construction) and its bake's (``Scene.
    bake_seconds``: the solids baked on the card, the field read back);
    count + lost == n0 and no NaN in every scene, one launch of each of
    SDF_KERNELS per meshed solid object (``meshed``: scene file -> the objects [sdf] baked) and
    every bake under BAKE_LIMIT_S."""
    from blub_tpu_torch import app

    built = []
    orig_build = app._build

    def build(args, graphs=True):
        t0 = time.perf_counter()
        s = orig_build(args, graphs)
        s.startup_s = time.perf_counter() - t0
        s.frames = []
        step = s.step

        def timed_step():
            t0 = time.perf_counter()
            step()
            s.frames.append((frame_n_sub(s), 1e3 * (time.perf_counter() - t0)))

        s.step = timed_step
        built.append(s)
        return s

    res = {"frames": SCENE_FRAMES, "scenes": {}, "card": card}
    app._build = build
    try:
        for path in sorted((ROOT / "scenes").glob("*.json")):
            t0 = time.perf_counter()
            text, s_total, launches = _app(["run", str(path), "--sim-seconds", str(SCENE_FRAMES / 120.0)])
            scene = built.pop()
            st = scene.state
            n0 = scene.params.num_particles
            count, lost = scene.num_particles(), int(st.table.lost.item())
            ms = [m for _, m in scene.frames]
            r = {"grid": list(scene.params.grid_dim), "n0": n0, "count": count, "lost": lost,
                 "lost_pct": 100.0 * lost / max(n0, 1), "n_sub": ints([n for n, _ in scene.frames]),
                 "ms_per_frame": ms, "ms_per_frame_after_2": sum(ms[2:]) / max(len(ms) - 2, 1),
                 "count_plus_lost_eq_n0": count + lost == n0, "no_nan": state_is_finite(st),
                 "solids": [o.config.model + (f" ({o.standin} stand-in)" if o.standin else "")
                            for o in scene.solid_objects],
                 "max_divergence": st.stats_vel.error.item(), "s_total": s_total,
                 "startup_s": scene.startup_s, "bake_ms": 1e3 * scene.bake_seconds,
                 "meshed_solids": meshed.get(path.name, 0),
                 "launches": {k: v for k, v in launches.items() if v}}
            r["sdf_launches"] = {k: launches[k] for k in SDF_KERNELS}
            if r["solids"]:
                r["bake_split_ms"] = bake_split(path)
            res["scenes"][path.name] = r
            log(f"[scenes] {path.name}: grid {r['grid']}, n0 {n0}, lost {lost} ({r['lost_pct']:.4f} %), n_sub "
                f"{r['n_sub']}, ms/frame {[round(m, 2) for m in ms]}, count+lost==n0 {r['count_plus_lost_eq_n0']}, "
                f"no NaN {r['no_nan']}; start-up {r['startup_s']:.3f} s, of it the bake {r['bake_ms']:.2f} ms "
                f"({r['sdf_launches']['sdf']} sdf launches for {r['meshed_solids']} meshed solids; replayed step by "
                f"step, "
                f"ms: {json.dumps({k: round(v, 3) for k, v in r.get('bake_split_ms', {}).items()})}); "
                f"{time.perf_counter() - t0:.1f} s [{card}]")
            del scene, st
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        app._build = orig_build
    bad = {k: v for k, v in res["scenes"].items() if not (v["count_plus_lost_eq_n0"] and v["no_nan"])}
    res["sdf_launches"] = {k: sum(v["sdf_launches"][k] for v in res["scenes"].values()) for k in SDF_KERNELS}
    slow = {k: v["bake_ms"] for k, v in res["scenes"].items() if v["bake_ms"] > 1e3 * BAKE_LIMIT_S}
    uncounted = {k: v["sdf_launches"] for k, v in res["scenes"].items()
                 if any(c != v["meshed_solids"] for c in v["sdf_launches"].values())}
    log("[scenes] " + json.dumps(res))
    if bad:
        raise AssertionError(f"[scenes] conservation or NaN failed: {sorted(bad)}")
    if slow or uncounted:
        raise AssertionError(f"[scenes] bakes over {BAKE_LIMIT_S} s {slow}, or not one launch of each of the bake's "
                             f"kernels per meshed solid {uncounted}")
    return res


# ---------------------------------------------------------------------------
# the mesh path (parallel/sharded_sm.py)

# x-windows cut in one process, halos assembled locally; n = 1 is the window
# the mesh's dam at world size 1 launches on (the domain between halos)
MESH_WINDOWS = (1, 2, 4)
MESH_TIME_N = 2  # the window count whose rank 0 is timed
MESH_WAVE_FRAMES = 8  # Scene(mesh=1) frames of the wave scene: the path of advect_pack_solids_xs


def mesh_windows(inp, label, card, iters, solids=False):
    """Each x-window of n = 1, 2 and 4 through the x_start variants (and p2g
    and gridfix on extended windows), against the whole-grid kernel's core
    slice and against the variant's plain version, bit for bit: G2P on the
    windows of its reach and, with the x pack after it, on the windows the
    mesh's fused phases launch on (advect_pack_sharded, correct_pack_sharded).
    Rows (ms of one call on rank 0's window at n = 2, its plain version's ms
    and bound) for the kernels line."""
    from blub_tpu_torch.ops import advect_pack, g2p, gridfix, p2g, rebin
    from blub_tpu_torch.sim.density import position_change_field
    from blub_tpu_torch.sim.divergence import remove_divergence
    from blub_tpu_torch.sim.extrapolate import extrapolate_velocity
    from blub_tpu_torch.sim.slot_major import BYTES_PER_SLOT, valid_mask
    from blub_tpu_torch.testing import x_window

    t, dt = inp["table"], inp["dt"]
    k = t.capacity
    X = t.grid_dim[0]
    dom = tuple(t.grid_dim)
    plane = t.posq[0, 0, 0].numel()
    k_mid = k + rebin.default_slack(k * BYTES_PER_SLOT * X * plane, k)  # step_dense.stage_slack
    rows, extra, two_launch, device_win, splits = {}, {}, {}, {}, {}

    def core(a, dim, h, xl):
        return a.narrow(dim, h, xl)

    def same(name, got, ref):
        if not torch.equal(got, ref):
            raise AssertionError(f"[mesh] {label} {name}: the window's core differs from the whole grid's")

    def plain_same(name, got, ref):
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"[mesh] {label} {name}: the x_start kernel differs from its plain version")

    def fused(n, r):
        """The windows of the fused phases on rank r of n (the table's inner
        s halo planes real, its outer hx planes zero, the grids wrapped by h
        = s + hx): advect_pack.cu's x_start forms against their plain
        versions and the two x_start launches they replace (G2P, then the x
        pack), and their cores against the whole grid's two launches."""
        xl = X // n
        x0 = r * xl
        for step, s_, hx in (("advect", g2p.ADVECT_SHIFT, 2 if solids else 1), ("correct", g2p.CORRECT_SHIFT, 1)):
            if step == "correct" and solids:
                continue
            h = s_ + hx
            win = {"x_start": x0 - h, "domain": dom}

            def table(a):
                return torch.nn.functional.pad(x_window(a, 2, x0, xl, s_, False), (0, 0, 0, 0, hx, hx))

            if step == "advect":
                pq = table(t.posq)
                vw = [x_window(v, 0, x0, xl, h, True) for v in inp["velf"]]
                sw = ((x_window(sol.occupancy, 0, x0, xl, h, True), x_window(sol.velocity, 1, x0, xl, h, True))
                      if solids else (None, None))
                name = "advect_pack_solids_xs" if solids else "advect_pack_xs"
                k_fn = lambda: advect_pack.advect_pack(pq, vw, dt, *sw, k_mid, with_counts=True, **win)  # noqa: E731
                p_fn = lambda: advect_pack.advect_pack_plain(pq, vw, dt, *sw, k_mid, x0 - h, dom)  # noqa: E731
                gp, gd, gms = g2p.advect(pq, vw, dt, *sw, **win)
                op, od, odr, okp = rebin.pack(gp, gd, 0, s_, k_mid, x_start=x0 - h, dim=X)
                two = (op, od, gms, torch.stack([odr, okp]))
                two_fn = lambda: rebin.pack(*g2p.advect(pq, vw, dt, *sw, **win)[:2], 0, s_, k_mid,  # noqa: E731
                                            x_start=x0 - h, dim=X)
                whole = ref_p
                moved = gp
                empty = torch.zeros_like(pq)
                floor_fn = lambda: advect_pack.advect_pack(empty, vw, dt, *sw, k_mid, **win)  # noqa: E731
                nv = int(valid_mask(pq).sum().item())
                nb = 4 * k * (xl + 2 * h) * plane + 4 * nv + (28 if solids else 12) * (xl + 2 * h) * plane
                ops = nv * (730 if solids else 600)
            else:
                pq, dq = table(inp["posq_den"]), table(inp["dyn_den"])
                cw = [x_window(c, 0, x0, xl, h, True) for c in inp["change"]]
                mw = x_window(inp["marker2"], 0, x0, xl, h, True)
                name = "correct_pack_xs"
                k_fn = lambda: advect_pack.correct_pack(pq, dq, cw, mw, k_mid, with_counts=True, **win)  # noqa: E731
                p_fn = lambda: advect_pack.correct_pack_plain(pq, dq, cw, mw, k_mid, x0 - h, dom)  # noqa: E731
                moved = g2p.correct(pq, cw, mw, **win)
                empty = torch.zeros_like(pq)
                floor_fn = lambda: advect_pack.correct_pack(empty, dq, cw, mw, k_mid, **win)  # noqa: E731
                op, od, odr, okp = rebin.pack(moved, dq, 0, s_, k_mid, x_start=x0 - h, dim=X)
                two = (op, od, torch.stack([odr, okp]))
                two_fn = lambda: rebin.pack(g2p.correct(pq, cw, mw, **win), dq, 0, s_, k_mid,  # noqa: E731
                                            x_start=x0 - h, dim=X)
                whole = ref_pc
                nv = int(valid_mask(pq).sum().item())
                nb = 4 * k * (xl + 2 * h) * plane + 28 * nv + 13 * (xl + 2 * h) * plane
                ops = nv * 200
            got = k_fn()
            plain_same(f"fused {step} + pack x n={n} rank {r}", got, p_fn())
            if not all(torch.equal(a, b) for a, b in zip(got, two)):
                raise AssertionError(f"[mesh] {label} fused {step} + pack x n={n} rank {r}: the x_start kernel "
                                     f"differs from G2P then the x pack")
            same(f"fused {step} + pack x n={n} rank {r}", core(got[0], 2, h, xl), whole[0].narrow(2, x0, xl))
            same(f"fused {step} + pack x dyn n={n} rank {r}", core(got[1], 2, h, xl), whole[1].narrow(2, x0, xl))
            if n == MESH_TIME_N and r == 0:
                rows[name] = (cuda_ms(k_fn, iters), cuda_ms(p_fn, 1),
                              bound_ms(nb + k_mid * 8 * (xl + 2 * h) * plane * 4, ops))
                # device time back to back in turns with the two launches
                turns = [device_ms(f, iters) for f in (two_fn, k_fn, k_fn, two_fn)]
                two_launch[name] = {"ms": cuda_ms(two_fn, iters), "device_ms": (turns[0] + turns[3]) / 2,
                                    "device_ms_turns": turns}
                device_win[name] = (turns[1] + turns[2]) / 2
                splits[name] = fused_split(name, f"{label} window n={n} rank 0", k_fn, floor_fn, moved, got[0],
                                           iters, card, device_win[name])

    if solids:
        sol = inp["solids"]
        ref = g2p.advect(t.posq, inp["velf"], dt, sol.occupancy, sol.velocity)
    else:
        ref = g2p.advect(t.posq, inp["velf"], dt)
        ref_c = g2p.correct(inp["posq_den"], inp["change"], inp["marker2"])
        pk = inp["packs"][0]
        ref_pc = rebin.pack(*inp["packs"][-1])  # the correct's x pack
        ref_acc, ref_den = p2g.p2g(t.posq, t.dyn), p2g.p2g(inp["posq_den"], None, True)
        ref_gf = gridfix.gridfix_remove(inp["vel"], inp["pvel"], inp["marker"])
        ref_gc = gridfix.gridfix_change(inp["pvel"], inp["marker2"], dt)
    ref_p = rebin.pack(ref[0], ref[1], 0, g2p.ADVECT_SHIFT, k_mid)  # the advect's x pack
    for n in MESH_WINDOWS:
        xl = X // n
        for r in range(n):
            fused(n, r)
            x0 = r * xl
            h = 2 if solids else 1
            pq = x_window(t.posq, 2, x0, xl, h, False)
            vw = [x_window(v, 0, x0, xl, h, True) for v in inp["velf"]]
            if solids:
                sw = (x_window(sol.occupancy, 0, x0, xl, h, True), x_window(sol.velocity, 1, x0, xl, h, True))
            else:
                sw = (None, None)
            gp, gd, gms = g2p.advect(pq, vw, dt, *sw, x_start=x0 - h, domain=dom)
            same(f"g2p advect n={n} rank {r}", core(gp, 2, h, xl), ref[0].narrow(2, x0, xl))
            same(f"g2p advect dyn n={n} rank {r}", core(gd, 2, h, xl), ref[1].narrow(2, x0, xl))
            # the x_start variant against its plain version on the same window
            rp, rd, rms = g2p.advect_plain(pq, vw, dt, *sw, x0 - h, dom)
            plain_same(f"g2p advect n={n} rank {r}", (gp, gd, gms), (rp, rd, torch.sqrt(rms)))
            if n == MESH_TIME_N and r == 0:
                nw, nv = (xl + 2 * h) * plane, int(valid_mask(pq).sum().item())
                if solids:
                    rows["g2p_solids_xs"] = (
                        cuda_ms(lambda: g2p.advect(pq, vw, dt, *sw, x_start=x0 - h, domain=dom), iters),
                        cuda_ms(lambda: g2p.advect_plain(pq, vw, dt, *sw, x0 - h, dom), 1),
                        bound_ms(4 * k * nw + 4 * nv + 12 * nw + 16 * nw + k * 8 * nw * 4, nv * 730))
                else:
                    win_adv = (pq, vw, x0 - h, nw, nv)
            if solids:
                continue
            pq2 = x_window(inp["posq_den"], 2, x0, xl, 1, False)
            cw = [x_window(c, 0, x0, xl, 1, True) for c in inp["change"]]
            mw = x_window(inp["marker2"], 0, x0, xl, 1, True)
            gc = g2p.correct(pq2, cw, mw, x_start=x0 - 1, domain=dom)
            same(f"g2p correct n={n} rank {r}", core(gc, 2, 1, xl), ref_c.narrow(2, x0, xl))
            plain_same(f"g2p correct n={n} rank {r}", (gc,), (g2p.correct_plain(pq2, cw, mw, x0 - 1, dom),))
            s = pk[3]
            pp, pd = x_window(pk[0], 2, x0, xl, s, False), x_window(pk[1], 2, x0, xl, s, False)
            op, od, odr, okp = rebin.pack(pp, pd, 0, s, pk[4], x_start=x0 - s, dim=X)
            plain_same(f"pack x n={n} rank {r}", (op, od, odr, okp), rebin.pack_plain(pp, pd, 0, s, pk[4], x0 - s, X))
            same(f"pack x n={n} rank {r}", core(op, 2, s, xl), ref_p[0].narrow(2, x0, xl))
            same(f"pack x dyn n={n} rank {r}", core(od, 2, s, xl), ref_p[1].narrow(2, x0, xl))
            tq, td = x_window(t.posq, 2, x0, xl, 1, False), x_window(t.dyn, 2, x0, xl, 1, False)
            same(f"p2g n={n} rank {r}", core(p2g.p2g(tq, td), 1, 1, xl), ref_acc.narrow(1, x0, xl))
            same(f"p2g density n={n} rank {r}", core(p2g.p2g(x_window(inp["posq_den"], 2, x0, xl, 1, False), None, True),
                                                     1, 1, xl), ref_den.narrow(1, x0, xl))
            gv = [x_window(v, 0, x0, xl, 1, False) for v in inp["vel"]]
            gpv, gm = x_window(inp["pvel"], 0, x0, xl, 1, False), x_window(inp["marker"], 0, x0, xl, 1, False)
            for a, b in zip(gridfix.gridfix_remove(gv, gpv, gm), ref_gf):
                same(f"gridfix remove n={n} rank {r}", core(a, 0, 1, xl), b.narrow(0, x0, xl))
            gm2 = x_window(inp["marker2"], 0, x0, xl, 1, False)
            for a, b in zip(gridfix.gridfix_change(gpv, gm2, dt), ref_gc):
                same(f"gridfix change n={n} rank {r}", core(a, 0, 1, xl), b.narrow(0, x0, xl))
            if n == MESH_TIME_N and r == 0:
                pq_a, vw_a, xs_a, nw, nv = win_adv
                nv2 = int(valid_mask(pq2).sum().item())
                nw2 = (xl + 2) * plane

                def g2p_k():
                    g2p.advect(pq_a, vw_a, dt, x_start=xs_a, domain=dom)
                    g2p.correct(pq2, cw, mw, x_start=x0 - 1, domain=dom)

                def g2p_p():
                    g2p.advect_plain(pq_a, vw_a, dt, None, None, xs_a, dom)
                    g2p.correct_plain(pq2, cw, mw, x0 - 1, dom)

                rows["g2p_xs"] = (cuda_ms(g2p_k, iters), cuda_ms(g2p_p, 1),
                                  bound_ms(4 * k * nw + 4 * nv + 12 * nw + k * 8 * nw * 4 + 4 * k * nw2 + 4 * nv2
                                           + 13 * nw2 + k * 2 * nw2 * 4, nv * 600 + nv2 * 200))
                # p2g and gridfix as they are on the extended window (not
                # rows of their own: the whole-grid rows' kernels)
                pqd = x_window(inp["posq_den"], 2, x0, xl, 1, False)
                nvt, nvd = int(valid_mask(tq).sum().item()), int(valid_mask(pqd).sum().item())
                extra["p2g on the window"] = (
                    cuda_ms(lambda: (p2g.p2g(tq, td), p2g.p2g(pqd, None, True)), iters),
                    cuda_ms(lambda: (p2g.p2g_plain(tq, td, False), p2g.p2g_plain(pqd, None, True)), 1),
                    bound_ms(4 * k * nw2 + 28 * nvt + 7 * nw2 * 4 + 4 * k * nw2 + 4 * nvd + 2 * nw2 * 4,
                             nvt * 280 + nvd * 30))
                extra["gridfix on the slab"] = (
                    cuda_ms(lambda: (gridfix.gridfix_remove(gv, gpv, gm), gridfix.gridfix_change(gpv, gm2, dt)), iters),
                    cuda_ms(lambda: (extrapolate_velocity(remove_divergence(gv, gpv, gm), gm),
                                     extrapolate_velocity(position_change_field(gpv, gm2, dt), gm2)), 1),
                    bound_ms(nw2 * (12 + 4 + 1 + 12) + nw2 * (4 + 1 + 12), nw2 * 3 * 2 * 12))
                nvp = int(valid_mask(pp).sum().item())
                nwp = (xl + 2 * s) * plane
                rows["pack_xs"] = (cuda_ms(lambda: rebin.pack(pp, pd, 0, s, pk[4], x_start=x0 - s, dim=X), iters),
                                   cuda_ms(lambda: rebin.pack_plain(pp, pd, 0, s, pk[4], x0 - s, X), 1),
                                   bound_ms(4 * pk[0].shape[0] * nwp + 28 * nvp + pk[4] * 8 * nwp * 4, 0))
    names = (["g2p_solids_xs", "advect_pack_solids_xs"] if solids else
             ["g2p_xs", "pack_xs", "advect_pack_xs", "correct_pack_xs", "p2g (extended windows)", "gridfix (slabs)"])
    for name, row in rows.items():
        two = ""
        if name in two_launch:
            t2 = two_launch[name]
            two = (f"; device {device_win[name]:.4f} ms; G2P then pack x, two launches: {t2['ms']:.4f} ms, device "
                   f"{t2['device_ms']:.4f} (turns two, fused, fused, two {t2['device_ms_turns']})")
        log(f"[mesh] {label} {name}: {row[0]:.4f} ms per window (n=2, rank 0; plain {row[1]:.3f} ms, bound "
            f"{row[2][0]:.4f} ms by {row[2][1]}{two}) [{card}]")
    for name, (ms, plain, bound) in extra.items():
        log(f"[mesh] {label} {name}: {ms:.4f} ms (n=2, rank 0; both calls of a substep; plain {plain:.3f} ms, bound "
            f"{bound[0]:.4f} ms by {bound[1]}) [{card}]")
    rows["times"] = {name: {"ms": ms, "plain_ms": plain, "bound_ms": b[0], "bound_by": b[1]}
                     for name, (ms, plain, b) in extra.items()}
    rows["two_launch"] = two_launch
    rows["device"] = device_win
    rows["split"] = splits
    log(f"[mesh] {label} windows n={list(MESH_WINDOWS)}: {', '.join(names)} bit for bit with the whole-grid "
        f"kernels' cores; the x_start kernels bit for bit with their plain versions on every window "
        f"(max_abs_err 0) [{card}]")
    return rows


def mesh_ctx():
    """The one-rank NCCL group of this process (started once) and its
    ShardCtx."""
    import torch.distributed as dist

    from blub_tpu_torch.parallel import sharded_sm as ss
    from blub_tpu_torch.parallel import world

    dev = torch.device("cuda", 0)
    if not dist.is_initialized():
        world.one_rank_group(dev)
    return ss.ShardCtx.from_group(dev)


def mesh_pcg(ctx, inp, card, iters):
    """The mesh's solve (the pcg.cu pass kernels on the slab with the
    exchanges and all-reduces between them) on the dam's two solves at world
    size 1: pcg_solve_kernel's bits (pressure, error, iterations) or a
    failure, and held against the plain solve as the whole-grid solve is
    (hold_pcg_against_plain). Then the slab passes on n = 2 and 4 x-windows
    of the velocity solve's marker, halos cut from the whole grid, against
    the whole-grid pass kernels, bit for bit. Then [mesh pcg graph]: both
    solves captured as one chain (``ops/graph.ChainGraph``), each loop a
    CUDA WHILE node with its all-reduces inside, launched twice against the
    eager slab solve and pcg_solve_kernel (bits, iterations, the body's
    runs), and its ms per substep, the main path's (the row's ms)."""
    import torch.nn.functional as F

    from blub_tpu_torch.ops import pcg
    from blub_tpu_torch.parallel import sharded_sm as ss
    from blub_tpu_torch.sim.pressure import solve_pressure_plain
    from blub_tpu_torch.testing import x_window

    dt = inp["dt"]
    err, its = 0.0, []
    ext = [F.pad(m, (0, 0, 0, 0, 1, 1)) for _, _, m, _ in inp["pcg"]]
    for (p0, rhs, marker, cfg), mx in zip(inp["pcg"], ext):
        got = ss.solve_pressure_sharded(ctx, p0, rhs, mx, cfg, dt)
        ref = pcg.solve_pressure(p0, rhs, marker, cfg, dt)
        its.append([int(got.stats.iterations), int(ref.stats.iterations)])
        if ctx.n == 1 and not (its[-1][0] == its[-1][1] and torch.equal(got.pressure, ref.pressure)
                               and torch.equal(got.stats.error, ref.stats.error)):
            d = (got.pressure - ref.pressure).abs().max().item()
            raise AssertionError(f"[mesh] pcg_slab at world size 1 differs from pcg_solve_kernel: iterations "
                                 f"{its[-1]}, max|dp| {d}")
        err = max(err, hold_pcg_against_plain(got, p0, rhs, marker, cfg, dt, "[mesh] pcg_slab"))

    # the passes on windows: s and r on every plane of the window (the
    # passes carry them onto the halo planes), As, z and p on its own planes
    marker = inp["pcg"][0][2]
    shape = tuple(marker.shape)
    gen = torch.Generator(device=marker.device).manual_seed(0)
    z, s_old, r_old, p = (torch.where(marker == 1, torch.randn(shape, generator=gen, device=marker.device), 0.0)
                          for _ in range(4))
    diag, dfl = pcg.pass_setup(marker)
    scal = torch.tensor([2.5, 0.0, 0.5, 0.0], device=marker.device)  # [sigma, alpha, beta, err]
    s, As, _ = pcg.k1_pass(z, s_old, scal.clone(), diag, dfl)
    sAs = torch.tensor([3.25], device=marker.device)  # one partial for every k2 pass: the same alpha
    p_new = p.clone()
    r, z_new = pcg.k2_pass(p_new, r_old, s, As, sAs, scal.clone(), diag, dfl)
    for n in MESH_WINDOWS[1:]:
        xl = shape[0] // n
        for x0 in range(0, shape[0], xl):
            def win(a):
                return x_window(a, 0, x0, xl, 1, False)

            def core(a):
                return a.narrow(0, 1, xl)

            def part():
                return pcg.slab_partials((xl,) + shape[1:], marker.device)

            d_w, f_w = pcg.slab_setup(win(marker))
            s_w, As_w = torch.zeros_like(win(z)), torch.zeros_like(win(z))
            pcg.slab_k1(win(z), (win(s_old), s_w), 0, scal.clone(), win(diag), win(dfl), As_w, part())
            p_w, r_w, z_w = win(p), torch.zeros_like(s_w), torch.zeros_like(s_w)
            pcg.slab_k2(p_w, (win(r_old), r_w), (win(s), win(s)), 0, win(As), sAs, scal.clone(), win(dfl), z_w,
                        part(), part())
            sl = (lambda a: a.narrow(0, x0, xl))
            if not (torch.equal(core(d_w), sl(diag)) and torch.equal(core(f_w), sl(dfl)) and torch.equal(s_w, win(s))
                    and torch.equal(core(As_w), sl(As)) and torch.equal(core(p_w), sl(p_new))
                    and torch.equal(r_w, win(r)) and torch.equal(core(z_w), sl(z_new))):
                raise AssertionError(f"[mesh] pcg_slab passes on the window x0={x0} of n={n} differ from the "
                                     f"whole-grid passes")

    # [mesh pcg graph]: both solves captured as one chain, each loop a CUDA
    # WHILE node with its all-reduces inside, launched as one graph
    from blub_tpu_torch.ops import cuda, graph

    eager = [ss.solve_pressure_sharded(ctx, p0, rhs, mx, cfg, dt) for (p0, rhs, _, cfg), mx in zip(inp["pcg"], ext)]
    outs = []

    def both(chain):
        for (p0, rhs, _, cfg), mx in zip(inp["pcg"], ext):
            outs.append(ss.solve_pressure_sharded(ctx, p0, rhs, mx, cfg, dt, chain))

    captures = graph.Captures((cuda, ctx))
    chain = captures.capture(both)
    while_graph = graph.ChainGraph(captures, chain)
    for launch in (1, 2):
        while_graph.replay()
        torch.cuda.synchronize()
        for k, (got, ref, (p0, rhs, marker, cfg)) in enumerate(zip(outs, eager, inp["pcg"])):
            want = pcg.solve_pressure(p0, rhs, marker, cfg, dt)
            same = [int(got.stats.iterations) == int(ref.stats.iterations) == int(want.stats.iterations)
                    and int(while_graph.runs[k]) == launch * int(ref.stats.iterations),
                    torch.equal(got.pressure, ref.pressure) and torch.equal(got.stats.error, ref.stats.error)]
            if ctx.n == 1:
                same.append(torch.equal(got.pressure, want.pressure) and torch.equal(got.stats.error,
                                                                                      want.stats.error))
            if not all(same):
                raise AssertionError(f"[mesh pcg graph] solve {k} in a WHILE node differs (iterations and runs, "
                                     f"bits against the eager slab solve, against pcg_solve_kernel): {same}")
    graph_ms = cuda_ms(while_graph.replay, iters)
    body_nodes = [graph.node_counts(lp.body) for lp in chain.loops]
    del outs, while_graph, chain, captures, eager
    body = slab_body_ms(ctx, inp["pcg"][0], ext[0], dt)

    def slab_k():
        for (p0, rhs, _, cfg), mx in zip(inp["pcg"], ext):
            ss.solve_pressure_sharded(ctx, p0, rhs, mx, cfg, dt)

    def solve_k():
        for p0, rhs, marker, cfg in inp["pcg"]:
            pcg.solve_pressure(p0, rhs, marker, cfg, dt)

    def plain_k():
        for p0, rhs, marker, cfg in inp["pcg"]:
            solve_pressure_plain(p0, rhs, marker, cfg, dt)

    n = inp["pcg"][0][1].numel()
    fluid = [int((a[2] == 1).sum().item()) for a in inp["pcg"]]
    n_its = sum(i[0] for i in its)
    res = {"iterations_slab_persistent": its, "same_bits_as_pcg_solve_kernel": ctx.n == 1,
           "windows_bit_for_bit": list(MESH_WINDOWS[1:]),
           "ms_per_substep": graph_ms, "ms_per_iteration": graph_ms / n_its,
           "eager_ms_per_substep": cuda_ms(slab_k, iters),
           "pcg_solve_kernel_ms_per_substep": cuda_ms(solve_k, iters), "while_body_nodes": body_nodes,
           "plain_ms": cuda_ms(plain_k, 1), "max_abs_err_vs_plain": err,
           "bound": bound_ms(*bwm.pcg(n, [i[0] for i in its], fluid)),
           # the passes' own bound at every iteration (pcg_passes.measure), which an iterative solve cannot go
           # below unless its grids stay on chip between passes
           "pass_bound": bound_ms(*(v * n_its for v in bwm.pcg_iteration(n))),
           "launch": pcg.pass_config((inp["pcg"][0][1].shape[0] // ctx.n,) + tuple(inp["pcg"][0][1].shape[1:]), 1),
           "velocity_solve_body": body, "card": card}
    log(f"[mesh] pcg_slab: " + json.dumps(res))
    log(f"[mesh] pcg_slab: the dam's two solves at world size 1: iterations {[i[0] for i in its]}, "
        f"pcg_solve_kernel's bits; the passes on x-windows n={list(MESH_WINDOWS[1:])} bit for bit with the "
        f"whole-grid passes [{card}]")
    log(f"[mesh pcg graph] both solves as one chain, each loop a CUDA WHILE node (body nodes {body_nodes}): the "
        f"eager slab solve's and pcg_solve_kernel's bits and iterations, launched twice; "
        f"{res['ms_per_substep']:.4f} ms per substep ({n_its} iterations, {res['ms_per_iteration']:.5f} ms each; "
        f"the passes' bound {res['pass_bound'][0]:.4f} per substep, once through {res['bound'][0]:.4f}) against "
        f"{res['eager_ms_per_substep']:.4f} for the eager slab solve and "
        f"{res['pcg_solve_kernel_ms_per_substep']:.4f} for pcg_solve_kernel [{card}]")
    log(f"[mesh pcg graph] the velocity solve's iteration: k1 {body['k1_ms']:.5f}, k2 {body['k2_ms']:.5f}, tail "
        f"{body['tail_ms']:.5f} ms device back to back; the iteration as one plain graph replay "
        f"{body['graph_iteration_ms']:.5f} ms against {res['ms_per_iteration']:.5f} in the WHILE node [{card}]")
    return res


def slab_body_ms(ctx, solve, mx, dt, reps=40):
    """The slab solve's iteration on one of the dam's solves at its start:
    each kernel's device ms back to back (k1 and k2 read the same inputs at
    every call, the tail the same partials), and the whole iteration
    captured as one plain CUDA graph, replayed back to back (the WHILE
    node's body without the node)."""
    from blub_tpu_torch.ops import pcg
    from blub_tpu_torch.parallel import sharded_sm as ss

    p0, rhs, _, cfg = solve
    st = ss.slab_start(ctx, p0, rhs, mx, cfg, dt)
    out = {"k1_ms": device_ms(lambda: pcg.slab_k1(st.z, st.s, st.it, st.scal, st.diag, st.dfl, st.As, st.part), reps),
           "k2_ms": device_ms(lambda: pcg.slab_k2(st.p, st.r, st.s, st.it, st.As, st.part, st.scal, st.dfl, st.z,
                                                  st.part_zr, st.part_max), reps),
           "tail_ms": device_ms(lambda: pcg.slab_tail(st.part_zr, st.part_max, st.scal), reps)}
    st = ss.slab_start(ctx, p0, rhs, mx, cfg, dt)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm, outside the capture
        ss.slab_iteration(ctx, st)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):  # NCCL's watchdog queries events meanwhile
        ss.slab_iteration(ctx, st)
    out["graph_iteration_ms"] = device_ms(g.replay, reps)
    return out


def run_mesh_dam(ctx, card, dam_eager, dam_graphs, label="mesh dam", graphs=True, mesh_eager=None):
    """The dam cell on ``ctx``'s group: 1 warm + TIMED_FRAMES frames through
    frame_dense_sharded's graph launches (n_sub and each solve's loop on the
    card: nothing read per frame) or, without ``graphs``, eagerly
    (eager_frame with ShardedPhases, n_sub read on the host, each solve's
    predicate read per iteration); counts and the collective tally reset
    before and read after; lost and the n_sub sequence beside [dam
    eager]'s; with ``mesh_eager`` (the eager run's (result, final state))
    the final table, n_sub, each frame's PCG iterations and the launch
    counts against it, bit for bit. -> (result, params, final slab
    state)."""
    from blub_tpu_torch.ops import cuda, graph
    from blub_tpu_torch.parallel import sharded_sm as ss
    from blub_tpu_torch.sim.step_dense import eager_frame, make_dense_state, substep_count

    params, pos = dam_params_and_positions()
    n0 = pos.shape[0]
    if graphs:
        def frame(s):
            return ss.frame_dense_sharded(params, ctx, s, None, DAM_CFL, DAM_MAX_SUB)
    else:
        phases = ss.ShardedPhases(params, ctx)

        def frame(s):
            k = substep_count(params, s, DAM_CFL, DAM_MAX_SUB)
            return eager_frame(params, s, lambda i, n: None, k, phases), k

    torch.cuda.reset_peak_memory_stats()
    state = ss.shard_sm_state(ctx, make_dense_state(params, pos, DAM_K, device="cpu"))
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    ctx.reset_tally()
    subs, iters = [], []
    t0 = time.perf_counter()
    for i in range(TIMED_FRAMES + 1):
        if i == 1:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        state, k = frame(state)
        subs.append(k.clone() if isinstance(k, torch.Tensor) else k)
        iters.append(torch.stack([state.stats_vel.iterations, state.stats_den.iterations]))  # device copies
    t_enqueued = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    subs = ints(subs)
    iters = torch.stack(iters).tolist()
    launches = cuda.launch_counts()
    tally = {kind: dict(v) for kind, v in ctx.tally.items()}
    count = int(ctx.all_reduce(state.table.num_particles().reshape(1).clone()).item())
    lost = int(state.table.lost.item())
    nsub = sum(subs)
    cap = capture_seconds(state)
    runner = state.runner
    res = {
        "path": "graphs" if graphs else "eager", "ranks": ctx.n, "backend": "nccl", "frames": TIMED_FRAMES,
        "warm_frame_s": t1 - t0, "ms_per_frame": 1e3 * (t2 - t1) / TIMED_FRAMES, "captures_s": cap,
        "ms_per_frame_without_captures": 1e3 * (t2 - t1 - cap) / TIMED_FRAMES,
        "host_ms_per_frame_call": 1e3 * (t_enqueued - t1) / TIMED_FRAMES,
        "n_sub": subs, "lost": lost, "lost_pct": 100.0 * lost / n0,
        "count_plus_lost_eq_n0": count + lost == n0, "no_nan": state_is_finite(state),
        "lost_eager": dam_eager["lost"], "same_lost_as_eager": lost == dam_eager["lost"],
        "same_n_sub_as_eager": subs == dam_eager["n_sub"],
        "eager_ms_per_frame": dam_eager["ms_per_frame"], "graphs_ms_per_frame": dam_graphs["ms_per_frame"],
        "pcg_iterations_vel_den": iters[-1], "pcg_iterations_per_frame": iters,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
        "collectives_per_substep": {kind: {"calls": v["calls"] / nsub, "bytes": v["bytes"] / nsub,
                                           "max_bytes": v["max_bytes"]} for kind, v in tally.items()},
        "card": card,
    }
    if runner is not None:
        res["nodes_per_branch"] = {n: {"chain": graph.node_counts(b), "loops": len(b.loops),
                                       "per_loop_body": [graph.node_counts(lp.body)["total"] for lp in b.loops]}
                                   for n, b in enumerate(runner.graph.branches, 1)}
        res["loop_body_runs"] = runner.graph.runs.tolist()
        res["graph_launches"] = int(runner.frames.sum())  # one per frame after the runner's eager first
    if mesh_eager is not None:
        ref, ref_state = mesh_eager
        res["same_as_eager_mesh"] = {
            "table": torch.equal(state.table.posq, ref_state.table.posq) and torch.equal(state.table.dyn,
                                                                                        ref_state.table.dyn),
            "lost": lost == ref["lost"], "n_sub": subs == ref["n_sub"],
            "pcg_iterations_per_frame": iters == ref["pcg_iterations_per_frame"],
            "launches": launches == ref["launches"],
            "collectives": res["collectives_per_substep"] == ref["collectives_per_substep"]}
        res["eager_mesh_ms_per_frame"] = ref["ms_per_frame"]
    log(f"[{label}] " + json.dumps(res))
    log(f"[{label}] world size {ctx.n} over NCCL, {res['path']}: lost {lost} against [dam eager]'s "
        f"{dam_eager['lost']}: {'the same' if res['same_lost_as_eager'] else 'DIFFERENT'}; n_sub "
        f"{'the same' if res['same_n_sub_as_eager'] else 'DIFFERENT'}; {res['ms_per_frame']:.3f} ms/frame "
        f"({res['ms_per_frame_without_captures']:.3f} without the capture; single card eager "
        f"{dam_eager['ms_per_frame']:.3f}, graphs {dam_graphs['ms_per_frame']:.3f}); peak "
        f"{res['peak_mem_gib']:.3f} GiB; collectives per substep "
        f"{ {k: round(v['calls'], 2) for k, v in res['collectives_per_substep'].items()} } [{card}]")
    if not res["count_plus_lost_eq_n0"]:
        raise AssertionError(f"[{label}] count {count} + lost {lost} != n0 {n0}")
    if not res["no_nan"]:
        raise AssertionError(f"[{label}] the state holds NaN or inf")
    if ctx.n == 1 and not (res["same_lost_as_eager"] and res["same_n_sub_as_eager"]):
        # one rank repeats the whole-grid kernels' bits, so the trajectory is [dam eager]'s
        raise AssertionError(f"[{label}] at world size 1: lost {lost} vs {dam_eager['lost']}, n_sub "
                             f"{'the same' if res['same_n_sub_as_eager'] else 'DIFFERENT'}")
    if mesh_eager is not None and not all(res["same_as_eager_mesh"].values()):
        raise AssertionError(f"[{label}] differs from the eager mesh: {res['same_as_eager_mesh']}")
    if graphs and not (runner and runner.graph and any(b.loops for b in runner.graph.branches)):
        raise AssertionError(f"[{label}] the frames launched no graph with WHILE nodes")
    if "all_gather" in tally:
        raise AssertionError(f"[{label}] the step all-gathered: {tally['all_gather']}")
    missing = [k for k in ("advect_pack_xs", "correct_pack_xs", "pcg_slab", "p2g", "gridfix", "pack_yz")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"[{label}] kernels never launched on the mesh path: {missing}")
    stray = [k for k in ("pcg", "advect_pack", "correct_pack") + UNFUSED_KERNELS if launches[k]]
    if stray:
        raise AssertionError(f"[{label}] the mesh path launched whole-grid kernels: {stray}")
    return res, params, state


def run_mesh_wave(card, graphs=True, eager=None):
    """Scene(wavegenerator, capacity 24, mesh=1) for MESH_WAVE_FRAMES frames,
    through graph launches or (``graphs=False``) eagerly: the solids on the
    mesh (advect_pack_solids_xs), conservation, no NaN, the Scene's waits on its
    ring; with ``eager`` (the eager run's (result, final state)) the final
    table, lost and n_sub against it, bit for bit. -> (result, state)."""
    from blub_tpu_torch.ops import cuda
    from blub_tpu_torch.runtime.scene import Scene

    scene = Scene(ROOT / WAVE_SCENE, capacity=WAVE_K, mesh=1, graphs=graphs)
    n0 = scene.params.num_particles
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    subs = []
    for _ in range(MESH_WAVE_FRAMES):
        scene.step()
        subs.append(frame_n_sub(scene))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    subs = ints(subs)
    launches = cuda.launch_counts()
    lost = scene.solver_stats()["lost_particles"]
    count = scene.num_particles()
    label = "mesh graph wave" if graphs else "mesh wave"
    res = {"path": "graphs" if graphs else "eager", "frames": MESH_WAVE_FRAMES,
           "ms_per_frame": 1e3 * wall / MESH_WAVE_FRAMES, "n_sub": subs, "lost": lost,
           "count_plus_lost_eq_n0": count + lost == n0, "no_nan": state_is_finite(scene.state),
           "pacing_waits": scene.pacing_waits, "launches": launches, "card": card}
    if graphs:
        res["capture_s"] = scene._runner.capture_s
    if eager is not None:
        ref, ref_state = eager
        t = scene.state.table
        res["same_as_eager"] = {"table": torch.equal(t.posq, ref_state.table.posq) and torch.equal(t.dyn,
                                                                                               ref_state.table.dyn),
                                "lost": lost == ref["lost"], "n_sub": subs == ref["n_sub"]}
    log(f"[{label}] " + json.dumps(res))
    if not (res["count_plus_lost_eq_n0"] and res["no_nan"]):
        raise AssertionError(f"[{label}] conservation or finiteness failed: {res}")
    if launches["advect_pack_solids_xs"] == 0 or any(launches[k] for k in UNFUSED_KERNELS):
        raise AssertionError(f"[{label}] advect_pack_solids_xs never launched, or the unfused kernels did: "
                             f"{launches}")
    if eager is not None and not all(res["same_as_eager"].values()):
        raise AssertionError(f"[{label}] differs from the eager Scene(mesh=1): {res['same_as_eager']}")
    if graphs and not (scene._runner and scene._runner.graph):
        raise AssertionError(f"[{label}] the frames launched no CUDA graph")
    return res, clone_state(scene.state)


def mesh_rank_dam(rank, n, device, dam_eager, dam_graphs, card):
    """Rank ``rank`` of a world of n cards (parallel/world.run_world): the
    dam through the mesh."""
    from blub_tpu_torch.parallel import sharded_sm as ss

    res = run_mesh_dam(ss.ShardCtx.from_group(device), card, dam_eager, dam_graphs,
                       label=f"mesh graph dam {n} cards")[0]
    return res if rank == 0 else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None, help="directory for chip_smoke.json and the trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 1
    from blub_tpu_torch.ops import cuda

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    built = cuda.build()
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in built.items()})} total {time.perf_counter() - t0:.1f}s")
    from blub_tpu_torch.ops import graph

    log(f"[build] CUDA versions (the frame graph's IF nodes need 12.4 or later in the runtime and the driver): "
        f"{json.dumps(graph.versions())}")
    registers = {}
    for name in cuda.SOURCES:
        rep = ptxas_report(cuda._lib_path(name).with_suffix(".log").read_text())
        registers[name] = rep
        for fn, r in rep.items():
            log(f"[build] {name}: {fn}: {r['registers']} registers, {r['smem']} bytes static smem, stack frame "
                f"{r['stack_frame']}, spill stores {r['spill_stores']} loads {r['spill_loads']} bytes")
    from blub_tpu_torch.ops import p2g, rebin
    from blub_tpu_torch.sim.slot_major import BYTES_PER_SLOT

    smem = {}
    for label, grid, k in (("dam", DAM_GRID, DAM_K), ("wave", DAM_GRID, WAVE_K), ("highres", HIGHRES_GRID, HIGHRES_K),
                           (f"dam shape K={WIDE_K}", DAM_GRID, WIDE_K)):
        k_mid = k + rebin.default_slack(k * BYTES_PER_SLOT * int(np.prod(grid)), k)
        smem[label] = {"pack_yz_kernel s2": rebin.smem_bytes(k_mid, k, grid, 2),
                       "pack_yz_kernel s1": rebin.smem_bytes(k_mid, k, grid, 1), "p2g_kernel": p2g.smem_bytes(k, grid)}
    log(f"[build] dynamic shared memory per block (bytes): {json.dumps(smem)}")
    from blub_tpu_torch.ops import advect_pack

    fused_launch = {}
    for label, grid, k in (("dam", DAM_GRID, DAM_K), ("wave", DAM_GRID, WAVE_K), (f"K={WIDE_K}", DAM_GRID, WIDE_K),
                           ("highres", HIGHRES_GRID, HIGHRES_K), ("mesh window 70 planes", (70,) + DAM_GRID[1:], DAM_K)):
        k_mid = k + rebin.default_slack(k * BYTES_PER_SLOT * int(np.prod(grid)), k)
        for form, phase, solids in (("advect", "advect", False), ("advect solids", "advect", True),
                                    ("correct", "correct", False)):
            fused_launch[f"{label} {form}"] = advect_pack.launch_config(phase, k, k_mid, grid, solids,
                                                                        window=label.startswith("mesh"))
    smem["fused"] = fused_launch
    log(f"[build] advect_pack.cu fused_kernel launches (x planes a tile, dynamic shared memory bytes, resident "
        f"blocks per SM, registers, threads, cached moved slots): {json.dumps(fused_launch)}")
    from blub_tpu_torch.ops import pcg

    pcg_blocks = {name: pcg.solve_blocks(shape) for name, shape in (("dam", DAM_GRID), ("highres", HIGHRES_GRID))}
    log(f"[build] pcg_solve_kernel: {json.dumps(pcg_blocks)} blocks of {pcg.SOLVE_THREADS} threads "
        f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs; the order of the dot products does not depend on it)")
    pass_launch = {f"{name} halo {h}": pcg.pass_config(shape, h) for name, shape in (("dam", DAM_GRID),
                   ("highres", HIGHRES_GRID)) for h in (0, 1)}
    log(f"[build] pcg pass kernels k1_kernel / k2_kernel: blocks of {pcg.SOLVE_THREADS} threads, dynamic shared "
        f"memory per block, tiles of 2 chunks, x planes per march: {json.dumps(pass_launch)}")

    # (a) mid size, with and without solids
    from blub_tpu_torch.core.types import SimParams, SolverStats
    from blub_tpu_torch.sim.step_dense import DenseFluidState
    from blub_tpu_torch.testing import moving_box, random_table

    mid = (32, 16, 16)
    rng = np.random.default_rng(0)
    mt = random_table(mid, 8, 1, device="cuda")
    mparams = SimParams(grid_dim=mid, dt=1.0 / 120.0, gravity_grid=(0.0, -981.0, 0.0),
                        num_particles=int(mt.num_particles().item()))
    mstate = DenseFluidState(
        table=mt, pressure_vel=torch.from_numpy(rng.standard_normal(mid).astype(np.float32)).cuda(),
        pressure_den=torch.zeros(mid, device="cuda"), step_index=torch.zeros((), dtype=torch.int32, device="cuda"),
        stats_vel=SolverStats.zero("cuda"),
        stats_den=SolverStats.zero("cuda"), max_speed=torch.zeros((), device="cuda"),
    )
    check_all(phase_inputs(mparams, mstate), "mid 32x16x16 K=8", card)
    box = moving_box(mid, (8, 2, 3), (14, 12, 12), (-35.0, 4.0, 2.0), device="cuda")
    check_solids(phase_inputs(mparams, mstate, box, keep_packs=False), "mid 32x16x16 K=8 + moving box", card)
    wide = check_wide(mid, card)
    # the scene load's mesh bakes at every scene file's shape
    sdf_res = run_sdf(card)

    # (b) the main path on the dam cell: eager frames first (the reference),
    # then the main path, one graph replay per frame
    from blub_tpu_torch.sim.step_dense import multi_frame_dense

    dam_eager = run_dam(card, graphs=False)[3]
    params, state, launches, dam = run_dam(card)
    dam["eager"] = dam_eager
    dam["graph_vs_eager"] = compare_paths("graph dam", dam_eager, dam, card)
    dam["branches"] = check_branches(params, state, card)
    dam["sync_check"] = check_step_syncs(params, state, card)
    dam["quality"] = run_quality(f"dam after its 1 + {TIMED_FRAMES} frames", state,
                                 params.solver_vel.error_tolerance, card)
    dam["fixed_dt"] = run_fixed_dt(params, state, card)
    dam_state = [state]

    def dam_frames(n):
        dam_state[0], subs = multi_frame_dense(params, dam_state[0], n, cfl_target=DAM_CFL, max_substeps=DAM_MAX_SUB)
        return subs


    # (a) dam shape, inputs from the dam state after its 64 frames; times per substep
    inp = phase_inputs(params, state)
    errs = check_all(inp, "dam 128x64x64 K=14", card)
    errs["correct_pack"] = errs["advect_pack"]  # check_advect_pack holds both fused kernels
    dam["glue_check"] = check_glue(params, inp, "dam 128x64x64 K=14", card)
    rows, device = time_kernels(inp, iters=10, card=card)
    pcg_history = {"dam": check_pcg_history(inp["pcg"], inp["dt"], "dam 128x64x64 K=14", card)}
    # the mesh's kernels on x-windows of the same inputs, and its solve
    ctx = mesh_ctx()
    mesh = {"windows": mesh_windows(inp, "dam 128x64x64 K=14", card, iters=10)}
    mesh["pcg"] = mesh_pcg(ctx, inp, card, iters=10)
    del inp
    from blub_tpu_torch.sim.step_dense import substep_count

    dam["graph_sync"] = check_graph_syncs(
        lambda: dam_frames(1), lambda: dam_state[0].runner.graph is not None, GRAPH_SYNC_FRAMES, "dam", card,
        control=lambda: substep_count(params, dam_state[0], DAM_CFL, DAM_MAX_SUB))

    # the solids path on the wavegenerator scene, then its kernels at that
    # shape on inputs replayed from the frame-96 state
    wscene_eager, _, wave_eager = run_wave(card, graphs=False)
    wscene, (wstate, wsolids), wave = run_wave(card)
    wave["eager"] = wave_eager
    wave["graph_vs_eager"] = compare_paths("graph wave", wave_eager, wave, card)
    wave["quality"] = run_quality(f"wave K={WAVE_K} after its 1 + {WAVE_FRAMES} frames", wscene.state,
                                  wscene.params.solver_vel.error_tolerance, card)
    wave["graph_sync"] = check_graph_syncs(
        wscene.step, lambda: wscene._runner.graph is not None, GRAPH_SYNC_FRAMES, "wave", card,
        control=lambda: substep_count(wscene.params, wscene.state, wscene.settings.cfl_target,
                                      wscene.settings.max_substeps),
        pacing_waits=lambda: wscene.pacing_waits)
    wparams = wscene.params
    winp = phase_inputs(wparams, wstate, wsolids, keep_packs=False)
    errs.update(check_solids(winp, f"wave 128x64x64 K={WAVE_K} frame 96", card))
    wave["glue_check"] = check_glue(wparams, winp, f"wave 128x64x64 K={WAVE_K} frame 96", card)
    wrows, wdevice = time_solids(winp, iters=10, card=card)
    rows.update(wrows)
    wave_windows = mesh_windows(winp, f"wave 128x64x64 K={WAVE_K} frame 96", card, iters=10, solids=True)
    for name in ("g2p_solids_xs", "advect_pack_solids_xs"):
        mesh["windows"][name] = wave_windows[name]
    for key in ("two_launch", "device", "split"):
        mesh["windows"][key].update(wave_windows[key])
    device["two_launch"].update(wdevice.pop("two_launch"))
    device["split"].update(wdevice.pop("split"))
    device.update(wdevice)
    del winp, wstate, wsolids
    wave["app_capacity"] = run_wave(card, WAVE_K_APP, lost_budget=False)[2]
    launches = dict(launches, gridfix_solids=wave["launches"]["gridfix_solids"],
                    advect_pack_solids=wave["launches"]["advect_pack_solids"])

    highres = run_highres(card)
    pcg_history["highres"] = highres["pcg_history"]

    # the mesh path: the dam at world size 1 over NCCL, eagerly (the
    # reference) and through graph launches (the main path), the graph
    # frames under the sync debug mode, the wave scene on Scene(mesh=1) both
    # ways, and two ranks where the host has two cards
    mesh_eager = run_mesh_dam(ctx, card, dam_eager, dam, label="mesh dam", graphs=False)
    mesh["dam"] = mesh_eager[0]
    mesh["graph_dam"], mesh_params, mesh_state = run_mesh_dam(ctx, card, dam_eager, dam, label="mesh graph dam",
                                                              mesh_eager=(mesh_eager[0], mesh_eager[2]))
    mesh_eager_state = mesh_eager[2]
    del mesh_eager
    from blub_tpu_torch.parallel.sharded_sm import frame_dense_sharded

    mesh_live = [mesh_state]

    def mesh_graph_frame():
        mesh_live[0], _ = frame_dense_sharded(mesh_params, ctx, mesh_live[0], None, DAM_CFL, DAM_MAX_SUB)

    mesh["graph_sync"] = check_graph_syncs(
        mesh_graph_frame, lambda: mesh_live[0].runner.graph is not None, GRAPH_SYNC_FRAMES, "mesh dam", card,
        control=lambda: substep_count(mesh_params, mesh_live[0], DAM_CFL, DAM_MAX_SUB))
    mesh_state = mesh_live[0]
    del mesh_live
    mesh["quality"] = run_mesh_quality(ctx, mesh_params, mesh_state, card)
    wave_eager = run_mesh_wave(card, graphs=False)
    mesh["wave"] = wave_eager[0]
    mesh["graph_wave"] = run_mesh_wave(card, eager=wave_eager)[0]
    del wave_eager
    if torch.cuda.device_count() >= 2:
        from blub_tpu_torch.parallel.world import run_world

        mesh["dam_2_cards"] = run_world(2, mesh_rank_dam, (dam_eager, dam, card), device="cuda")[0]
    else:
        log(f"[mesh] 2 ranks over NCCL: not run: this host has {torch.cuda.device_count()} card, and NCCL takes "
            f"one rank per card (two ranks on one card fail with 'Duplicate GPU detected') [{card}]")
    for name in ("g2p_xs", "pack_xs", "g2p_solids_xs", "advect_pack_xs", "correct_pack_xs", "advect_pack_solids_xs"):
        rows[name] = mesh["windows"][name]
    mp = mesh["pcg"]
    rows["pcg_slab"] = (mp["ms_per_substep"], mp["plain_ms"], mp["bound"])
    device["pcg_slab"] = None
    errs.update({"g2p_xs": 0.0, "g2p_solids_xs": 0.0, "pack_xs": 0.0, "pcg_slab": mp["max_abs_err_vs_plain"],
                 "advect_pack_xs": 0.0, "correct_pack_xs": 0.0, "advect_pack_solids_xs": 0.0})
    launches = dict(launches, **{k: mesh["graph_dam"]["launches"][k]
                                 for k in ("advect_pack_xs", "correct_pack_xs", "pcg_slab")},
                    advect_pack_solids_xs=mesh["graph_wave"]["launches"]["advect_pack_solids_xs"])
    two_launch = dict(device["two_launch"], **mesh["windows"]["two_launch"])
    device.update(mesh["windows"]["device"])
    device["split"].update(mesh["windows"]["split"])

    # the probe path on one seeded dam table (K slots + the stage slack,
    # empty): copy, relops, the yz floor, the rebin sweep, the pcg passes
    from blub_tpu_torch.probes import yz_floor
    from blub_tpu_torch.sim.step_dense import stage_slack

    slack = stage_slack(params.grid_dim, DAM_K)
    posq, dyn, lost = yz_floor.seeded_table(DAM_GRID, DAM_K, pad=slack)
    copy = run_copy(card, posq[:DAM_K], dyn[:DAM_K])
    errs["copy"] = copy["max_abs_err"]
    launches["copy"] = copy["launches"]
    rows["copy"] = (copy["kernel"]["ms"], copy["plain"]["ms"], bound_ms(copy["bytes"], 0))
    probes = {"relops": run_relops(card), "yz_floor": run_yz_floor(card, posq, dyn, DAM_K)}
    probes["rebin_sweep"] = run_rebin_sweep(card, posq[:DAM_K], dyn[:DAM_K], lost, slack)
    del posq, dyn
    probes["pcg_passes"] = run_pcg_passes(card)
    rel, floor = probes["relops"], probes["yz_floor"]
    errs["relops"], launches["relops"] = rel["max_abs_err"], rel["launches"]
    rows["relops"] = (rel["ms"], rel["plain_ms"], (rel["bound_ms"], rel["bound_by"]))
    zeros = floor["variants"]["zeros"]
    errs["yz_floor"] = max(floor["max_abs_err"].values())
    launches["yz_floor"] = floor["launches"]["yz_floor"]
    rows["yz_floor"] = (zeros["ms"], zeros["plain_ms"], (zeros["bound_ms"], zeros["bound_by"]))
    read = floor["variants"]["read"]
    errs["yz_floor_read"] = max(floor["max_abs_err"]["read"], floor["highres"]["max_abs_err"])
    launches["yz_floor_read"] = floor["launches"]["yz_floor_read"]
    rows["yz_floor_read"] = (read["ms"], read["plain_ms"], (read["bound_ms"], read["bound_by"]))

    for k in (16, WIDE_K):
        reference_small(card, k)

    # traces: eager frames for the per-phase device time, graph replays for
    # the idle share of the main path
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out or pathlib.Path(tmp)
        out_dir.mkdir(parents=True, exist_ok=True)

        # every call starts from one snapshot, so the untraced and the traced
        # frames of a trace are the same frames
        dam_snap, dam_runner = clone_state(dam_state[0]), dam_state[0].runner
        dam_valid = int(dam_snap.table.num_particles())
        wave_valid = int(wscene_eager.state.table.num_particles())

        def dam_eager_frames(n):
            return eager_frames(params, dam_snap, n, DAM_CFL, DAM_MAX_SUB)[1]

        def dam_graph_frames(n):
            dam_state[0] = dataclasses.replace(dam_snap, runner=dam_runner)  # the runner copies it in
            return ints(dam_frames(n))

        def scene_frames(scene):
            snap, t = clone_state(scene.state), scene.total_simulated_time

            def run(n):
                scene.state, scene.total_simulated_time = snap, t
                subs = []
                for _ in range(n):
                    scene.step()
                    subs.append(frame_n_sub(scene))
                return ints(subs)
            return run

        # the mesh's dam frames (world size 1) from one snapshot, eager (their
        # per-phase device time) and through the graph (its idle share)
        from blub_tpu_torch.parallel.sharded_sm import ShardedPhases
        from blub_tpu_torch.sim.step_dense import eager_frame

        mesh_snap, mesh_runner = clone_state(mesh_state), mesh_state.runner
        mesh_phases = ShardedPhases(mesh_params, ctx)
        del mesh_state, mesh_eager_state

        def mesh_eager_frames(n):
            s, subs = mesh_snap, []
            for _ in range(n):
                k = substep_count(mesh_params, s, DAM_CFL, DAM_MAX_SUB)
                s = eager_frame(mesh_params, s, lambda i, m: None, k, mesh_phases)
                subs.append(k)
            return subs

        def mesh_graph_frames(n):
            s, subs = dataclasses.replace(mesh_snap, runner=mesh_runner), []  # the runner copies it in
            for _ in range(n):
                s, k = frame_dense_sharded(mesh_params, ctx, s, None, DAM_CFL, DAM_MAX_SUB)
                subs.append(k.clone())
            return ints(subs)

        # the host's costs and the untraced windows first: the profiler, once
        # run, makes every later launch cost the host more
        dam["branch_cost"] = branch_costs(dam_runner, params, "dam", card)
        wave["branch_cost"] = branch_costs(wscene._runner, wparams, "wave", card)
        cells = ((dam["eager"], dam_eager_frames, "dam_eager"), (dam, dam_graph_frames, "dam_graphs"),
                 (wave["eager"], scene_frames(wscene_eager), "wave_eager"),
                 (wave, scene_frames(wscene), "wave_graphs"), (mesh["dam"], mesh_eager_frames, "mesh_dam"),
                 (mesh["graph_dam"], mesh_graph_frames, "mesh_dam_graphs"))
        untraced = [untraced_window(run) for _, run, _ in cells]
        for (cell, run, label), window in zip(cells, untraced):
            cell["trace"] = trace_frames(run, window, cell["ms_per_frame"], out_dir, card, label)
        del mesh_snap, mesh_runner, cells
        # the eager traces' phases against the bytes each must move (the
        # traced frames start from the snapshots, whose particles these are)
        phase_rates = {
            "dam": phase_bytes_report("dam", dam["eager"]["trace"], DAM_GRID, DAM_K, dam_valid, False,
                                      dam["ms_per_frame_without_captures"] / dam["substeps_per_frame"], card),
            "wave": phase_bytes_report(f"wave K={WAVE_K}", wave["eager"]["trace"], tuple(wparams.grid_dim), WAVE_K,
                                       wave_valid, True,
                                       wave["ms_per_frame_without_captures"] / wave["substeps_per_frame"], card)}
        md, mg = mesh["dam"], mesh["graph_dam"]
        log(f"[mesh graph dam] ms/frame eager {md['ms_per_frame']:.3f} graphs {mg['ms_per_frame']:.3f} "
            f"({mg['ms_per_frame_without_captures']:.3f} without the capture of {mg['captures_s']:.3f} s); device "
            f"idle share eager {md['trace']['device_idle_share']:.3f} graphs {mg['trace']['device_idle_share']:.3f} "
            f"(the traced run itself {mg['trace']['traced_run_idle_share']:.3f}); device busy ms/frame eager "
            f"{md['trace']['device_busy_ms_per_frame']:.3f} graphs {mg['trace']['device_busy_ms_per_frame']:.3f}; "
            f"peak GiB eager {md['peak_mem_gib']:.3f} graphs {mg['peak_mem_gib']:.3f} [{card}]")
        dam["graph_launch"] = graph_launch_times(dam_runner, params, "dam", card)
        wave["graph_launch"] = graph_launch_times(wscene._runner, wparams, "wave", card)
        for label, cell in (("dam", dam), ("wave", wave)):
            log(f"[graph {label}] ms/frame eager {cell['eager']['ms_per_frame']:.3f} graphs {cell['ms_per_frame']:.3f} "
                f"({cell['ms_per_frame_without_captures']:.3f} without the captures); "
                f"device idle share eager {cell['eager']['trace']['device_idle_share']:.3f} graphs "
                f"{cell['trace']['device_idle_share']:.3f} (the traced run itself "
                f"{cell['trace']['traced_run_idle_share']:.3f}); capture s {json.dumps(cell['capture_s'])}; peak GiB "
                f"eager {cell['eager']['peak_mem_gib']:.3f} graphs {cell['peak_mem_gib']:.3f} [{card}]")

        # the renderer at the dam state, the app, every scene file (each
        # Scene bakes its solids on the card)
        render = run_render(params, dam_state[0], args.out, card)
        app_res = run_app(card)
        scenes = run_scenes(card, sdf_res["meshed"])
        if render["failed"]:  # checked after the phases that follow it, which still run
            raise AssertionError(f"[render] the card's images differ from the plain ones: {render['failed']}")
        launches["pcg_history"] = app_res["profile --solver-history"]["launches"]["pcg_history"]
    # the history instantiation: its time on the dam solves beside the plain
    # version with history, the bound of the solve it rides on (and its
    # history written once), its launches on its path (profile --solver-history)
    ph = pcg_history["dam"]
    rows["pcg_history"] = (ph["ms"], ph["plain_ms"], (ph["bound_ms"], ph["bound_by"]))
    errs["pcg_history"] = max(ph["max_abs_err"], pcg_history["highres"]["max_abs_err"])
    device["pcg_history"] = ph["device_ms_history"]
    # the mesh bake: the row's numbers are the bunny's (the most pairs), every
    # scene file's beside them; its launches those of [scenes]' scene loads
    bunny = sdf_res["scenes"]["dam_halfhalf_staticbunny.json:0"]
    rows["sdf"] = (bunny["ms"], bunny["plain_ms"], (bunny["bound_ms"], bunny["bound_by"]))
    errs["sdf"] = max(r["max_abs_err"] for r in sdf_res["scenes"].values())
    for name in SDF_KERNELS:
        launches[name] = scenes["sdf_launches"][name]
    for name, part in (("sdf_bounds", "bounds"), ("sdf_unite", "unite"), ("sdf_keys", "keys")):
        bb = bunny[part]
        rows[name] = (bb["device_ms"], bb["plain_ms"], (bb["bound_ms"], bb["bound_by"]))
        errs[name] = max(r[part]["max_abs_err"] for r in sdf_res["scenes"].values())
    kernels = []
    library = {"copy": copy["plain"]["ms"], "yz_floor": zeros["library_ms"]}
    for name in cuda.KERNELS:
        ms, plain, (bms, by) = rows[name]
        src, rep = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": library.get(name),
        })
        if name == "yz_floor":  # the row's numbers are the zeros variant's; every variant beside them
            kernels[-1]["variants"] = floor["variants"]
        if name == "yz_floor_read":
            kernels[-1]["highres"] = floor["highres"]["read"]
        if name == "sdf":
            fields = ("points", "triangles", "needed", "inside", "ms", "device_ms", "kernel_device_ms", "plain_ms",
                      "bound_ms", "brute_bound_ms")
            kernels[-1]["bakes"] = {k: {f: r.get(f) for f in fields} for k, r in sdf_res["scenes"].items()}
        per = {"copy": "round trip", "relops": "call", "yz_floor": "sweep (zeros variant)",
               "yz_floor_read": "sweep (dam table)", "sdf": "bake (the bunny's)",
               "sdf_bounds": "bake's bounds (the bunny's)", "sdf_unite": "bake's groups (the bunny's)",
               "sdf_keys": "bake's point keys (the bunny's)", "g2p_xs": "window",
               "g2p_solids_xs": "window", "pack_xs": "window", "advect_pack_xs": "window",
               "correct_pack_xs": "window", "advect_pack_solids_xs": "window"}.get(name, "substep")
        extra = ""
        if name in UNFUSED_KERNELS:
            kernels[-1]["launches_path"] = "off the main path: the fused kernels replace it"
        if name in two_launch:  # no PyTorch call computes G2P + the x pack: the two launches it replaces
            t2 = two_launch[name]
            kernels[-1]["two_launch_ms"] = t2["ms"] if isinstance(t2, dict) else t2
            extra += f", G2P then pack x as two launches {kernels[-1]['two_launch_ms']:.4f} ms"
            if isinstance(t2, dict):
                kernels[-1]["two_launch_device_ms"] = t2["device_ms"]
                kernels[-1]["device_ms_turns"] = t2["device_ms_turns"]
                extra += f" (device {t2['device_ms']:.4f}; turns two, fused, fused, two {t2['device_ms_turns']})"
        if name in device["split"]:  # the fused kernels' time split (fused_split)
            kernels[-1]["split"] = device["split"][name]
        if device.get(name) is not None:  # beside the CUDA-event time: device time back to back
            kernels[-1]["device_ms"] = device[name]
            extra += f", device {device[name]:.4f} ms"
        if name == "p2g":  # besides the main path: one density launch per quality reading
            kernels[-1]["launches_quality"] = {label: q["launches"].get("p2g", 0) for label, q in (
                ("dam", dam["quality"]), ("wave", wave["quality"]), ("highres", highres["quality"]),
                ("mesh dam", mesh["quality"]))}
            extra += f", quality launches {kernels[-1]['launches_quality']}"
        if name == "pcg":
            kernels[-1]["blocks"] = pcg_blocks
            extra += f", blocks {pcg_blocks}"
        if name == "g2p":
            floors = {"empty_tables": device["g2p_empty_tables"], "outputs_memset": device["g2p_outputs_memset"]}
            kernels[-1]["floors_device_ms"] = floors
            extra += (f", on empty tables {floors['empty_tables']:.4f}, "
                      f"memset of its outputs {floors['outputs_memset']:.4f}")
        log(f"[time] {name}: {ms:.4f} ms/{per} (plain {plain:.3f} ms, bound {bms:.4f} ms by {by}{extra}) "
            f"launches {launches[name]} [{card}]")

    log(f"[total] {time.perf_counter() - t_start:.1f}s [{card}]")
    if args.out:
        (args.out / "chip_smoke.json").write_text(json.dumps(
            {"dam": dam, "wave": wave, "highres": highres, "wide": wide, "copy": copy, "probes": probes,
             "pcg_history": pcg_history, "render": render, "app": app_res, "scenes": scenes, "sdf": sdf_res,
             "mesh": mesh, "phase_bytes": phase_rates,
             "kernels": kernels, "registers": registers, "dynamic_smem": smem, "card": card}, indent=1))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
