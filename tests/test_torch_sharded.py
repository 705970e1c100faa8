"""The mesh path (blub_tpu_torch/parallel/sharded_sm.py) on the CPU, at the
JAX test's size (tests/test_sharded_sm.py): 32x8x8, K=8, the dam cube
add_fluid_cube((1,1,1), (16,5,7)).

In this process, on x-windows cut by hand at n = 2, 4 and 8 (halos taken
from the whole arrays: the neighbours' planes, wrapping for G2P's grids,
zeros beyond the domain for tables and the glue): the x_start variants of
G2P (advect with and without solids, correct) and the x pack, P2G on
extended windows and the dense glue on slabs with the domain's border give
the whole-grid plain versions' cores bit for bit, and the cores put together
match the JAX XLA oracles (one 2^-13 quantum, one bf16 ulp; the pack bit for
bit against the placement spec). The mesh's PCG passes on those windows give
the whole-grid passes' values bit for bit, and the mesh's solve on a one-rank
gloo group in this process gives the plain solve's bits, eagerly and with its
iteration run as a CUDA WHILE node runs it, and the JAX package's
solve_pressure within 1e-4 at an odd and an even iteration count (the r and s
pairs end on either parity); its tail (the scalars and the loop predicate) is
the JAX solver's at every edge.

In spawned gloo worlds of 2 and 8 ranks (8: four-plane slabs, where the
widest halo is a whole neighbour's slab), each spawned once: every sharded
wrapper against the unsharded phase bit for bit; the slab PCG solve against
the JAX package's solve_pressure at an odd and an even iteration count; one
frame's n_sub (a 0-d int32, substep_count_device's); 3 steps against the port's
single-process step at K=8 (sorted positions within 1e-3, counts and lost
exact, max speed within 1e-3) and against the JAX package's step_dense at
K=16 (its single-device oracle on the CPU is the "pt" layout, whose rebin
drops other particles than the slot pack when cells overflow, so the
comparison runs where nothing overflows; max speed within 2^-7, as pt keeps
f32 velocities and the port bf16); one step with a moving solid across the
seam; the steps' collectives (P2P halos and all-reduces, no all-gather);
physics_quality through ShardedPhases on each rank's slab of one state
against the single process's on the whole state (interior count exact,
drift within 1e-6); at
n = 8, 30 steps of that flow against the single-process step (conservation
on both paths at every step, lost within max(10, n0 // 50), p95 sorted
drift <= 1.5 cells, centre of mass within 0.25), and Scene(mesh=8) on
scenes/mini_dam.json for 2 frames against the single-process scene."""

import concurrent.futures
import os
import pickle
import time
import traceback
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_sharded_worker as W
from blub_tpu.core.types import SimParams as JaxSimParams
from blub_tpu.core.types import SolidState as JaxSolidState
from blub_tpu.sim import slot_major as jsm
from blub_tpu.sim.sm_phases import advect_slot_major, correct_slot_major
from blub_tpu.sim.step_dense import make_dense_state as jax_make_state, step_dense
from blub_tpu.sim.table import to_positions
from blub_tpu_torch import convert
from blub_tpu_torch.core.config import SimSettings, SolverConfig, scenes_dir
from blub_tpu_torch.ops import g2p, p2g, pcg, rebin
from blub_tpu_torch.parallel import sharded_sm as ss
from blub_tpu_torch.parallel.world import one_rank_group, run_world
from blub_tpu_torch.runtime.scene import Scene
from blub_tpu_torch.sim.dense_transfer import density_rhs_from_raw
from blub_tpu_torch.sim.divergence import compute_divergence_rhs
from blub_tpu_torch.sim.pressure import solve_pressure_plain
from blub_tpu_torch.sim.quality import density_drift, physics_quality
from blub_tpu_torch.sim.slot_major import unpack_dyn, unpack_posq
from blub_tpu_torch.sim.sm_phases import marker_from_counts
from blub_tpu_torch.sim.step_dense import step_core
from blub_tpu_torch.testing import random_table, x_window
from test_rebin_overflow_spec import _decode, _encode, _pack_axis_spec

torch.set_num_threads(1)

G, K, DT = W.GRID, W.K, W.DT
DRIFT_STEPS = 30


def _pad(a, dim, h):
    """Zero planes around ``a`` along ``dim``."""
    return x_window(a, dim, 0, a.shape[dim], h, wrap=False) if h else a


def _core(a, dim, h, xl):
    return a.narrow(dim, h, xl)


def _slab(a, dim, x0, xl):
    return a.narrow(dim, x0, xl)


@pytest.fixture(scope="module")
def inputs():
    t = random_table(G, K, seed=3, hi=(30, 6, 7))
    vel, occ, sv, change, marker = W.fields(4)
    return t, vel, occ, sv, change, marker


@pytest.fixture(scope="module")
def whole(inputs):
    """The whole-grid plain versions."""
    t, vel, occ, sv, change, marker = inputs
    adv = g2p.advect(t.posq, vel, DT)
    adv_s = g2p.advect(t.posq, vel, DT, occ, sv)
    return {"advect": adv, "advect_solids": adv_s, "correct": g2p.correct(t.posq, change, marker),
            "pack": rebin.pack(adv[0], adv[1], 0, 2, K + 4), "p2g": p2g.p2g(t.posq, t.dyn),
            "p2g_density": p2g.p2g(t.posq, None, density=True)}


def _x_windows(n):
    xl = G[0] // n
    return [(r * xl, xl) for r in range(n)]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_g2p_windows_match_the_whole_grid(inputs, whole, n):
    """Advect (without and with solids, reach 1 and 2) and correct on each
    x-window give the whole grid's cores bit for bit, max speed included."""
    t, vel, occ, sv, change, marker = inputs
    ms, ms_s = [], []
    for x0, xl in _x_windows(n):
        for solid, h in ((False, 1), (True, 2)):
            pq = x_window(t.posq, 2, x0, xl, h, wrap=False)
            vw = [x_window(v, 0, x0, xl, h, wrap=True) for v in vel]
            ow, sw = (x_window(occ, 0, x0, xl, h, True), x_window(sv, 1, x0, xl, h, True)) if solid else (None, None)
            p, d, m = g2p.advect(pq, vw, DT, ow, sw, x_start=x0 - h, domain=G)
            rp, rd, _ = whole["advect_solids" if solid else "advect"]
            assert torch.equal(_core(p, 2, h, xl), _slab(rp, 2, x0, xl)), (x0, solid)
            assert torch.equal(_core(d, 2, h, xl), _slab(rd, 2, x0, xl)), (x0, solid)
            (ms_s if solid else ms).append(m)
        pq = x_window(t.posq, 2, x0, xl, 1, wrap=False)
        c = g2p.correct(pq, [x_window(v, 0, x0, xl, 1, True) for v in change], x_window(marker, 0, x0, xl, 1, True),
                        x_start=x0 - 1, domain=G)
        assert torch.equal(_core(c, 2, 1, xl), _slab(whole["correct"], 2, x0, xl)), x0
    assert torch.equal(torch.stack(ms).max(), whole["advect"][2])
    assert torch.equal(torch.stack(ms_s).max(), whole["advect_solids"][2])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_pack_and_p2g_windows_match_the_whole_grid(inputs, whole, n):
    """The x pack with x_start on the s-extended window, and P2G as it is on
    the window extended by one table plane."""
    t = inputs[0]
    rp, rd, _ = whole["advect"]
    wp, wd, _, _ = whole["pack"]
    for x0, xl in _x_windows(n):
        s = 2
        p, d, _, _ = rebin.pack(x_window(rp, 2, x0, xl, s, False), x_window(rd, 2, x0, xl, s, False), 0, s, K + 4,
                                x_start=x0 - s, dim=G[0])
        assert torch.equal(_core(p, 2, s, xl), _slab(wp, 2, x0, xl)), x0
        assert torch.equal(_core(d, 2, s, xl), _slab(wd, 2, x0, xl)), x0
        pq, dy = x_window(t.posq, 2, x0, xl, 1, False), x_window(t.dyn, 2, x0, xl, 1, False)
        assert torch.equal(_core(p2g.p2g(pq, dy), 1, 1, xl), _slab(whole["p2g"], 1, x0, xl)), x0
        assert torch.equal(_core(p2g.p2g(pq, None, density=True), 1, 1, xl), _slab(whole["p2g_density"], 1, x0, xl))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_glue_on_slabs_matches_the_whole_grid(inputs, whole, n):
    """The marker from the slab's x origin (the domain's border), and the
    normalization and the divergence and density right-hand sides on the
    slab extended by one plane (zeros at the domain's ends)."""
    _, _, occ, sv, _, _ = inputs
    acc, dacc = whole["p2g"], whole["p2g_density"]
    marker = marker_from_counts(acc[-1], G, occ)
    vel = p2g.normalize_velocity(acc, marker, (0.0, -981.0, 0.0), DT)
    div = compute_divergence_rhs(vel, marker, sv)
    den = density_rhs_from_raw(dacc[0], marker, DT)
    for x0, xl in _x_windows(n):
        mk = marker_from_counts(_slab(acc[-1], 0, x0, xl), G, _slab(occ, 0, x0, xl), x_start=x0)
        assert torch.equal(mk, _slab(marker, 0, x0, xl)), x0
        mk_e = x_window(marker, 0, x0, xl, 1, False)
        v = p2g.normalize_velocity(_pad(_slab(acc, 1, x0, xl), 1, 1), mk_e, (0.0, -981.0, 0.0), DT)
        for c in range(3):
            assert torch.equal(_core(v[c], 0, 1, xl), _slab(vel[c], 0, x0, xl)), (x0, c)
        d = compute_divergence_rhs([x_window(u, 0, x0, xl, 1, False) for u in vel], mk_e,
                                   x_window(sv, 1, x0, xl, 1, False))
        assert torch.equal(_core(d, 0, 1, xl), _slab(div, 0, x0, xl)), x0
        r = density_rhs_from_raw(_pad(_slab(dacc[0], 0, x0, xl), 0, 1), mk_e, DT)
        assert torch.equal(_core(r, 0, 1, xl), _slab(den, 0, x0, xl)), x0



def _pcg_problem(inputs, whole, seed):
    """(marker, rhs, vectors) of a PCG solve on the glue's marker: the
    divergence right-hand side, and random vectors that vanish off fluid
    (as the passes' inputs do)."""
    _, _, occ, sv, _, _ = inputs
    marker = marker_from_counts(whole["p2g"][-1], G, occ)
    vel = p2g.normalize_velocity(whole["p2g"], marker, (0.0, -981.0, 0.0), DT)
    rng = np.random.default_rng(seed)
    fluid = marker == 1
    vecs = [torch.where(fluid, torch.from_numpy(rng.standard_normal(G).astype(np.float32)), 0.0) for _ in range(4)]
    return marker, compute_divergence_rhs(vel, marker, sv), vecs


@pytest.mark.parametrize("n", [2, 4, 8])
def test_pcg_slab_passes_on_windows_match_the_whole_grid(inputs, whole, n):
    """The mesh's PCG passes (ops/pcg.slab_*) on x-windows whose halo planes
    hold the neighbours' planes (zeros beyond the domain) give the
    whole-grid passes' values bit for bit: s and r on every plane of the
    window (the passes carry them onto the halo planes), the setup, As, z
    and p on the window's own planes."""
    marker, _, (z, s_old, r_old, p) = _pcg_problem(inputs, whole, 5)
    diag, dfl = pcg.pass_setup(marker)
    scal = torch.tensor([2.5, 0.0, 0.5, 0.0])  # [sigma, alpha, beta, err]
    s, As, _ = pcg.k1_pass(z, s_old, scal.clone(), diag, dfl)
    sAs = torch.tensor([3.25])  # one partial for every pass: the same alpha
    p_new = p.clone()
    r, z_new = pcg.k2_pass(p_new, r_old, s, As, sAs, scal.clone(), diag, dfl)
    for x0, xl in _x_windows(n):
        def win(a):
            return x_window(a, 0, x0, xl, 1, wrap=False)

        d_w, f_w = pcg.slab_setup(win(marker))
        assert torch.equal(_core(d_w, 0, 1, xl), _slab(diag, 0, x0, xl)), x0
        assert torch.equal(_core(f_w, 0, 1, xl), _slab(dfl, 0, x0, xl)), x0
        part, part_max = pcg.slab_partials((xl,) + G[1:], "cpu"), pcg.slab_partials((xl,) + G[1:], "cpu")
        s_w, As_w = torch.zeros_like(win(z)), torch.zeros_like(win(z))
        pcg.slab_k1(win(z), (win(s_old), s_w), 0, scal.clone(), win(diag), win(dfl), As_w, part)
        assert torch.equal(s_w, win(s)), x0
        assert torch.equal(_core(As_w, 0, 1, xl), _slab(As, 0, x0, xl)), x0
        # it odd: the older grid of each pair is the second
        s_odd = torch.zeros_like(s_w)
        pcg.slab_k1(win(z), (s_odd, win(s_old)), torch.tensor(3, dtype=torch.int32), scal.clone(), win(diag),
                    win(dfl), As_w, part)
        assert torch.equal(s_odd, win(s)), x0
        p_w, r_w, z_w = win(p), torch.zeros_like(s_w), torch.zeros_like(s_w)
        pcg.slab_k2(p_w, (win(r_old), r_w), (win(s), win(s)), 0, win(As), sAs, scal.clone(), win(dfl), z_w, part,
                    part_max)
        assert torch.equal(_core(p_w, 0, 1, xl), _slab(p_new, 0, x0, xl)), x0
        assert torch.equal(r_w, win(r)), x0
        assert torch.equal(_core(z_w, 0, 1, xl), _slab(z_new, 0, x0, xl)), x0


class _WhileLoops:
    """The capture's ``loop(body, go)`` as a CUDA WHILE node runs it: the
    body while the device int32 go is nonzero, checked before each run."""

    def __init__(self):
        self.runs = []

    def loop(self, body, go):
        n = 0
        while int(go):
            body()
            n += 1
        self.runs.append(n)


@pytest.mark.parametrize("cfg", [SolverConfig(), SolverConfig(error_tolerance=0.01, max_num_iterations=20,
                                                              error_check_frequency=3),
                                 SolverConfig(error_tolerance=0.0, max_num_iterations=7, error_check_frequency=4),
                                 SolverConfig(error_check_frequency=1),
                                 SolverConfig(max_num_iterations=1)],
                         ids=["default", "tight", "capped", "every_iteration", "one_iteration"])
def test_mesh_pcg_at_world_size_1_gives_the_plain_solve(inputs, whole, cfg):
    """solve_pressure_sharded on a one-rank gloo group in this process (its
    halos are zeros, its all-reduces of one rank) gives solve_pressure_plain's
    pressure, error and iterations bit for bit: its setup, then its
    iteration driven by the device predicate, eagerly (the host reads go)
    and as the frame graph's WHILE node runs it (the body while go != 0),
    whose runs are the iterations."""
    marker, rhs, (p0, _, _, _) = _pcg_problem(inputs, whole, 6)
    loops = _WhileLoops()
    one_rank_group(torch.device("cpu"))
    try:
        ctx = ss.ShardCtx.from_group("cpu")
        got = [ss.solve_pressure_sharded(ctx, p0, rhs, _pad(marker, 0, 1), cfg, DT, lp) for lp in (None, loops)]
    finally:
        dist.destroy_process_group()
    ref = solve_pressure_plain(p0, rhs, marker, cfg, DT)
    assert loops.runs == [int(ref.stats.iterations)]
    for g in got:
        assert g.stats.iterations.dtype == torch.int32 and g.stats.iterations.dim() == 0
        assert int(g.stats.iterations) == int(ref.stats.iterations) > 0
        assert torch.equal(g.pressure, ref.pressure)
        assert torch.equal(g.stats.error, ref.stats.error)


@pytest.fixture(scope="module")
def jax_pcg():
    """The JAX package's solve_pressure (XLA, jitted once per config) on
    numpy inputs: -> (pressure, iterations)."""
    from blub_tpu.core.config import SolverConfig as JaxSolverConfig
    from blub_tpu.sim import pressure as jp

    fns = {}

    def solve(cfg, marker, rhs, p0):
        if cfg not in fns:
            jcfg = JaxSolverConfig(**vars(cfg))

            def run(p, r, m, jcfg=jcfg):
                res = jp.solve_pressure(p, r, m, jcfg, float(DT))
                return res.pressure, res.stats.iterations

            fns[cfg] = jax.jit(run)
        p, it = fns[cfg](jnp.asarray(p0), jnp.asarray(rhs), jnp.asarray(marker))
        return np.asarray(p), int(it)

    return solve


def _assert_jax_solve(p, its, cfg, jax_pcg):
    """The pressure of W.pcg_problem within test_solve_matches_oracle's
    tolerance of the JAX solve's (1e-4, and 1e-4 of its scale), the
    iterations equal."""
    ref_p, ref_it = jax_pcg(cfg, *W.pcg_problem())
    assert its == ref_it == cfg.max_num_iterations
    np.testing.assert_allclose(p, ref_p, rtol=1e-4, atol=1e-4 * np.abs(ref_p).max())


@pytest.mark.parametrize("cfg", W.PCG_CONFIGS, ids=["odd", "even"])
def test_mesh_pcg_at_world_size_1_matches_jax_solve_pressure(jax_pcg, cfg):
    """solve_pressure_sharded on a one-rank gloo group against the JAX
    package's solve_pressure on the same seeded problem, at an odd and an
    even iteration count (the r and s pairs end on either parity)."""
    marker, rhs, p0 = (torch.from_numpy(a) for a in W.pcg_problem())
    one_rank_group(torch.device("cpu"))
    try:
        got = ss.solve_pressure_sharded(ss.ShardCtx.from_group("cpu"), p0, rhs, _pad(marker, 0, 1), cfg, DT)
    finally:
        dist.destroy_process_group()
    _assert_jax_solve(got.pressure.numpy(), int(got.stats.iterations), cfg, jax_pcg)


def test_slab_continue_is_the_jax_loop_predicate():
    """The mesh solve's tail after an iteration (pcg.slab_tail, its plain
    version: the scalars and the predicate in one launch) against the JAX
    solver's predicate, its body's check and convergence, then its cond
    (blub_tpu/sim/pressure.py:147-163), at every edge of a few configs: i %
    freq == 0, i == max - 1, i + 1 == max, and err below, at and above the
    tolerance; and the scalars as the separate reductions gave them (beta =
    z.r / (sigma +- 1e-10), sigma = z.r, err = max|r|, from the partials)."""
    def jax_go(i, err, tol, max_iter, freq):  # the JAX solver's lines, on jnp scalars
        i, err = jnp.int32(i), jnp.float32(err)
        max_iter, freq, tol = jnp.int32(max_iter), jnp.int32(max(freq, 1)), jnp.float32(tol)
        check = ((i % freq) == 0) | (i == max_iter - 1)
        converged = check & (err < tol)
        return bool((i + 1 < max_iter) & jnp.logical_not(converged)), int(i + 1)

    tol = float(np.float32(0.1) / np.float32(DT))
    errs = [0.0, float(np.nextafter(np.float32(tol), np.float32(0))), tol, float(np.nextafter(np.float32(tol),
            np.float32(np.inf))), float("inf"), float("nan")]
    part_zr = torch.tensor([1.5, -0.25])  # z.r = 1.25
    for max_iter, freq in ((32, 4), (20, 3), (7, 4), (5, 1), (1, 4), (3, 0)):
        for i in range(max_iter):
            for err in errs:
                it, go = torch.tensor(i, dtype=torch.int32), torch.tensor(1, dtype=torch.int32)
                scal = torch.tensor([0.5, 0.25, 0.0, 0.0], dtype=torch.float32)
                part_max = torch.tensor([err, 0.0], dtype=torch.float32)
                pcg.slab_tail(part_zr, part_max, scal, it=it, go=go, tol=tol, max_iter=max_iter, freq=max(freq, 1))
                assert (bool(go), int(it)) == jax_go(i, err, tol, max_iter, freq), (max_iter, freq, i, err)
                want = torch.tensor([1.25, 0.25, 1.25 / (0.5 + 1e-10), err], dtype=torch.float32)
                assert torch.equal(scal, want) or (np.isnan(err) and torch.equal(scal[:3], want[:3])
                                                   and bool(torch.isnan(scal[3]))), (scal, want)
    # the start's tail: beta = 0, no predicate
    scal = torch.tensor([0.5, 0.0, 0.75, 0.0], dtype=torch.float32)
    pcg.slab_tail(part_zr, torch.tensor([2.0, 3.0]), scal, first=True)
    assert torch.equal(scal, torch.tensor([1.25, 0.0, 0.0, 3.0]))


def _jax_sm(t):
    out = convert.table_to_jax(t)
    return jsm.SlotMajorTable(posq=jnp.asarray(out["posq"]), dyn=jnp.asarray(out["dyn"]), lost=jnp.int32(0),
                              grid_dim=G)


def _assert_close_to_oracle(posq, ref, dyn=None, vel_atol=1e-6, aff_atol=1e-6):
    ref_t = convert.table_from_jax(ref.posq, ref.dyn, ref.lost, G, device="cpu")
    g, r = unpack_posq(posq[:, 0], posq[:, 1]), unpack_posq(ref_t.posq[:, 0], ref_t.posq[:, 1])
    assert torch.equal(g[3], r[3])
    for a in range(3):
        assert (g[a] - r[a]).abs().max().item() <= 1
    if dyn is not None:
        gv, ga = unpack_dyn([dyn[:, c] for c in range(6)])
        rv, ra = unpack_dyn([ref_t.dyn[:, c] for c in range(6)])
        for i, (u, w) in enumerate(zip(gv + ga, rv + ra)):
            atol = vel_atol if i < 3 else aff_atol
            assert torch.all((u - w).abs() <= 2.0 ** -7 * torch.maximum(u.abs(), w.abs()) + atol), i


def test_windows_put_together_match_the_jax_oracles(inputs):
    """The cores of the n = 4 windows, concatenated, against the XLA
    oracles (sm_phases.advect_slot_major with and without solids,
    correct_slot_major) and the pack against the placement spec. The solid
    is the seam-spanning box: the oracle reads a z-padded grid, so where
    occupancy touches the z = Z-1 wall its wrapped reads from z-bin 0 see the
    padding's zeros, not the wall (ROADMAP section 3)."""
    t, vel, _, _, change, marker = inputs
    solid = W.seam_solid()
    occ, sv = solid.occupancy, solid.velocity
    n = 4
    parts = {"adv": [], "adv_s": [], "cor": []}
    for x0, xl in _x_windows(n):
        for key, h, o, v in (("adv", 1, None, None), ("adv_s", 2, occ, sv)):
            ow = None if o is None else x_window(o, 0, x0, xl, h, True)
            svw = None if v is None else x_window(v, 1, x0, xl, h, True)
            p, d, _ = g2p.advect(x_window(t.posq, 2, x0, xl, h, False), [x_window(u, 0, x0, xl, h, True) for u in vel],
                                 DT, ow, svw, x_start=x0 - h, domain=G)
            parts[key].append((_core(p, 2, h, xl), _core(d, 2, h, xl)))
        c = g2p.correct(x_window(t.posq, 2, x0, xl, 1, False), [x_window(u, 0, x0, xl, 1, True) for u in change],
                        x_window(marker, 0, x0, xl, 1, True), x_start=x0 - 1, domain=G)
        parts["cor"].append(_core(c, 2, 1, xl))
    sm = _jax_sm(t)
    jv = tuple(jnp.asarray(u.numpy()) for u in vel)
    # an affine entry is a difference of interpolated face values: beside one
    # bf16 ulp, the f32 rounding of that difference (4 f32 ulps of the
    # largest face value), which the oracle's order of operations moves
    aff_atol = 4 * 2.0 ** -24 * max(float(u.abs().max()) for u in vel)
    ref = jax.jit(lambda s_, v_: advect_slot_major(s_, v_, None, None, jnp.float32(DT)))(sm, jv)
    _assert_close_to_oracle(torch.cat([p for p, _ in parts["adv"]], 2), ref, torch.cat([d for _, d in parts["adv"]], 2),
                            aff_atol=aff_atol)
    solids = JaxSolidState(occupancy=jnp.asarray(occ.numpy()), velocity=jnp.asarray(sv.permute(1, 2, 3, 0).numpy()))
    ref_s = jax.jit(lambda s_, v_: advect_slot_major(s_, v_, solids.occupancy, solids.velocity,
                                                     jnp.float32(DT)))(sm, jv)
    # with solids a penetrating particle's velocity is a position difference
    # over dt: one f32 ulp of a position (< 32) over dt beside the bf16 ulp,
    # as tests/test_torch_solids.py holds it
    _assert_close_to_oracle(torch.cat([p for p, _ in parts["adv_s"]], 2), ref_s,
                            torch.cat([d for _, d in parts["adv_s"]], 2), vel_atol=2.0 ** -19 / float(DT),
                            aff_atol=aff_atol)
    ref_c = jax.jit(correct_slot_major)(sm, tuple(jnp.asarray(u.numpy()) for u in change), jnp.asarray(marker.numpy()))
    _assert_close_to_oracle(torch.cat(parts["cor"], 2), ref_c)
    # the x pack of the advected table, windows put together, against the spec
    ap = torch.cat([p for p, _ in parts["adv"]], 2)
    ad = torch.cat([d for _, d in parts["adv"]], 2)
    pos, valid = _decode(ap.numpy().view(np.float32))
    exp_pos, exp_valid, exp_dyn, _ = _pack_axis_spec(pos, valid, ad.numpy(), 0, 2, K + 4, G[0])
    got_p = torch.cat([_core(rebin.pack(x_window(ap, 2, x0, xl, 2, False), x_window(ad, 2, x0, xl, 2, False), 0, 2,
                                        K + 4, x_start=x0 - 2, dim=G[0])[0], 2, 2, xl) for x0, xl in _x_windows(n)], 2)
    np.testing.assert_array_equal(got_p.numpy(), _encode(exp_pos, exp_valid).view(np.int32))


# --------------------------------------------------------------------------
# spawned gloo worlds


def _single(params, state, steps, solids=None):
    """The port's single-process steps: per step sorted positions, count,
    lost and max speed."""
    out = []
    for _ in range(steps):
        state = step_core(params, state, DT, solids)
        out.append({"pos": np.sort(state.table.particles()[0].numpy(), axis=0),
                    "count": int(state.table.num_particles()), "lost": int(state.table.lost),
                    "max_speed": float(state.max_speed)})
    return out


def _jax_initial(pos, k):
    """The JAX package's initial state ("pt" layout) and its fields on the
    slot-major layout, in numpy (what convert.slab_state_from_jax takes)."""
    params = JaxSimParams(grid_dim=G, dt=float(DT), gravity_grid=(0.0, -981.0, 0.0), num_particles=pos.shape[0])
    state = jax_make_state(params, pos, capacity=k, layout="pt")
    sm = jsm.from_table(state.table)
    fields = {"posq": np.asarray(sm.posq), "dyn": np.asarray(sm.dyn), "lost": np.asarray(sm.lost), "grid_dim": G,
              "pressure_vel": np.asarray(state.pressure_vel), "pressure_den": np.asarray(state.pressure_den),
              "max_speed": np.asarray(state.max_speed)}
    return params, state, fields


def _jax_steps(params, state):
    step = jax.jit(partial(step_dense, params))
    out = []
    for _ in range(3):
        state = jax.block_until_ready(step(state))
        out.append({"pos": np.sort(np.asarray(to_positions(state.table)), axis=0),
                    "count": int(state.table.num_particles()), "lost": int(state.table.lost),
                    "max_speed": float(state.max_speed)})
    return out


def _single_scene(frames):
    scene = Scene(scenes_dir() / "mini_dam.json", SimSettings(), device="cpu")
    out = []
    for _ in range(frames):
        scene.step()
        out.append(np.sort(scene.particle_positions(), axis=0))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, spawned once each, with the single-process references
    (the port's steps, the JAX steps, the single-process scene) computed
    meanwhile in this process. Under pytest-xdist the first worker to ask
    computes them and the others load its result (the directory above each
    worker's base temp is the session's), so the worlds are spawned once
    per session, whichever workers run these tests."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _worlds()
    root = tmp_path_factory.getbasetemp().parent
    data, lock = root / "torch_sharded_worlds.pkl", root / "torch_sharded_worlds.lock"
    try:
        os.close(os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:  # another worker computes them
        deadline = time.monotonic() + 600
        while not data.exists():
            if time.monotonic() > deadline:
                raise TimeoutError("the worker spawning the gloo worlds never finished")
            time.sleep(0.5)
        ok, out = pickle.loads(data.read_bytes())
        if not ok:
            raise RuntimeError(f"the worker spawning the gloo worlds failed:\n{out}")
        return out
    try:
        out = (True, _worlds())
    except Exception:
        out = (False, traceback.format_exc())
    tmp = data.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(out))
    tmp.rename(data)  # whole, at once
    if not out[0]:
        raise RuntimeError(out[1])
    return out[1]


def _quality_state(params, state):
    """The single-process state after 3 steps at K=8 (the mesh's quality is
    held on its slabs) and its physics quality with the unrounded drift."""
    for _ in range(3):
        state = step_core(params, state, DT)
    d = density_drift(state.table)
    return state, {"quality": physics_quality(state, params.solver_vel.error_tolerance), "interior": int(d.interior),
                   "mean": float(d.mean), "max": float(d.max)}


def _worlds():
    params, pos, state = W.dam()
    params16, _, _ = W.dam(16)
    jparams, jstate, jfields = _jax_initial(pos, 16)
    state16 = convert.state_from_jax(**jfields, device="cpu")  # both packages start from the same state
    qstate, quality = _quality_state(params, state)
    leaves = convert.state_leaves(qstate)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:  # both worlds and the references at once
        worlds = {2: pool.submit(run_world, 2, W.run, (jfields, 0, False, leaves), device="cpu"),
                  8: pool.submit(run_world, 8, W.run, (jfields, DRIFT_STEPS, True, leaves), device="cpu")}
        refs = pool.submit(lambda: {"quality": quality,
            "k8": _single(params, state, 3), "k16": _single(params16, state16, 3),
            "jax_k16": _jax_steps(jparams, jstate), "solid": _single(params, state, 1, W.seam_solid()),
            "drift": _single(params, state, DRIFT_STEPS, W.seam_solid()), "scene": _single_scene(2)})
        got = {n: f.result()[0] for n, f in worlds.items()}
        return got, refs.result(), int(state.table.num_particles())


WORLDS = [2, 8]


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_wrappers_match_the_unsharded_phases(worlds, n):
    res = worlds[0][n]["wrappers"]
    assert res and all(res.values()), {k: v for k, v in res.items() if not v}


def _assert_steps_close(got, ref, speed_abs=0.0, speed_rel=0.0):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g["count"] == r["count"] and g["lost"] == r["lost"], (i, g["count"], r["count"], g["lost"], r["lost"])
        assert np.max(np.abs(g["pos"] - r["pos"])) < 1e-3, i
        assert abs(g["max_speed"] - r["max_speed"]) <= speed_abs + speed_rel * abs(r["max_speed"]), i


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_steps_match_the_single_process_step(worlds, n):
    got, refs, _ = worlds
    _assert_steps_close(got[n]["steps_k8"], refs["k8"], speed_abs=1e-3)
    _assert_steps_close(got[n]["steps_k16"], refs["k16"], speed_abs=1e-3)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_steps_match_jax_step_dense(worlds, n):
    got, refs, _ = worlds
    assert refs["jax_k16"][-1]["lost"] == 0  # nothing overflows at K=16
    _assert_steps_close(got[n]["steps_k16"], refs["jax_k16"], speed_rel=2.0 ** -7)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_frame_returns_the_device_n_sub(worlds, n):
    """frame_dense_sharded returns n_sub as the JAX mesh frame does: a 0-d
    int32 tensor, substep_count_device of the all-reduced max speed, and
    the frame ran that many substeps."""
    f = worlds[0][n]["frame"]
    assert (f["dtype"], f["dim"]) == ("torch.int32", 0)
    assert f["n_sub"] == f["expected"] == f["substeps"] == 2


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_step_with_moving_solid(worlds, n):
    got, refs, _ = worlds
    g, r = got[n]["solid_step"][0], refs["solid"][0]
    assert g["count"] == r["count"] and g["lost"] == r["lost"]
    assert np.max(np.abs(g["pos"] - r["pos"])) < 1e-3


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_step_collectives(worlds, n):
    """Halos go point to point, the sums and maxima by all-reduce, and the
    steps all-gather nothing (no table or grid is replicated)."""
    tally = worlds[0][n]["tally"]
    assert tally["p2p"]["calls"] > 0 and tally["all_reduce"]["calls"] > 0
    assert "all_gather" not in tally, tally
    table_plane = K * 8 * G[1] * G[2] * 4  # bytes of one x plane of the table (posq + dyn)
    assert tally["p2p"]["max_bytes"] <= 2 * table_plane  # the widest table halo: s = 2 planes


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_pcg_matches_jax_solve_pressure(worlds, jax_pcg, n):
    """The slab solve on each rank of the gloo world (halos exchanged,
    partials all-reduced), gathered, against the JAX package's
    solve_pressure on the whole grid, at an odd and an even iteration
    count."""
    for cfg, (p, its) in zip(W.PCG_CONFIGS, worlds[0][n]["pcg"]):
        _assert_jax_solve(p, its, cfg, jax_pcg)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_physics_quality_matches_the_single_process(worlds, n):
    """physics_quality with ShardedPhases on each rank's slab of one state
    (the density on the slab's window, the edge planes' neighbours from the
    halo, the sums all-reduced) against the single process on the whole
    state: the interior count exact, the drift within 1e-6, the max (the
    slab P2G's bits) exact, the solve's numbers equal."""
    got, refs, _ = worlds
    g, r = got[n]["quality"], refs["quality"]
    assert g["interior"] == r["interior"] > 0
    assert abs(g["mean"] - r["mean"]) <= 1e-6 and g["max"] == r["max"], (g, r)
    for key in ("max_divergence", "solver_converged"):
        assert g["quality"][key] == r["quality"][key]
    assert r["quality"]["max_divergence"] > 0


def test_sharded_drift_stays_bounded(worlds):
    """30 steps of the seam-solid flow on 8 ranks against the single-process
    step, at every step (the JAX test's envelope)."""
    got, refs, n0 = worlds
    drift = got[8]["drift"]
    assert len(drift) == DRIFT_STEPS
    for i, (g, r) in enumerate(zip(drift, refs["drift"])):
        assert g["count"] + g["lost"] == n0 and r["count"] + r["lost"] == n0, i
        assert abs(g["lost"] - r["lost"]) <= max(10, n0 // 50), i
        m = min(len(g["pos"]), len(r["pos"]))
        err = np.abs(g["pos"][:m] - r["pos"][:m]).max(axis=1)
        assert np.percentile(err, 95) <= 1.5, i
        assert np.abs(g["pos"][:m].mean(axis=0) - r["pos"][:m].mean(axis=0)).max() <= 0.25, i


def test_scene_runs_on_the_mesh(worlds):
    """Scene(mesh=8) on scenes/mini_dam.json: 2 frames conserve, the
    positions match the single-process scene's."""
    got, refs, _ = worlds
    assert ss.sharded_sm_supports((32, 16, 16), 16, 8)
    n0, frames = got[8]["scene"]
    for f, ref in zip(frames, refs["scene"]):
        assert f["count"] + f["lost"] == n0
        assert f["pos"].shape == ref.shape
        np.testing.assert_allclose(f["pos"], ref, rtol=1e-3, atol=1e-3)


def test_unsupported_grids_raise():
    assert not ss.sharded_sm_supports(G, K, 3)  # 32 planes do not split in 3
    assert not ss.sharded_sm_supports(G, K, 16)  # 2-plane slabs: narrower than the widest halo
    assert not ss.sharded_sm_supports(G, 61, 2)  # K + slack > 64
    with pytest.raises(ValueError):
        Scene(scenes_dir() / "mini_dam.json", SimSettings(), device="cpu", mesh=3)


def test_run_world_defaults_to_the_card():
    """run_world's default device is the card: without CUDA it raises before
    any rank is spawned (no silent gloo world on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("the rule's raise needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_world(2, W.run, ())
