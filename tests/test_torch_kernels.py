"""The port's CUDA kernels against their plain PyTorch versions, and the
no-fallback rule. JAX-free, so it also runs on a machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The ``gpu`` tests need a CUDA card and skip without one. The kernels repeat
the plain versions' arithmetic in the same order (built with -fmad=false),
so p2g, gridfix, g2p, pack, pack_yz, the mesh bake (sdf) and the probes'
kernels (copy, relops, yz_floor) must match bit for bit; the PCG dot products sum in another order, so its
iteration count may differ by one check window and its pressure by 1e-4 of
its scale. The PCG solve is one cooperative launch that reads nothing back
(``test_pcg_solve_no_host_sync``). The dense glue around the kernels gives
the same bits on the card as on the CPU (``test_glue_on_the_card``)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from blub_tpu_torch.core.config import SolverConfig
from blub_tpu_torch.core import models
from blub_tpu_torch.ops import advect_pack, cuda, g2p, gridfix, p2g, pcg, rebin, sdf
from blub_tpu_torch.probes import copy_bw, pcg_passes, rebin_sweep, relops, yz_floor
from blub_tpu_torch.sim.dense_transfer import density_rhs_from_raw
from blub_tpu_torch.sim.divergence import compute_divergence_rhs
from blub_tpu_torch.sim.pressure import solve_pressure_plain
from blub_tpu_torch.sim.slot_major import valid_mask
from blub_tpu_torch.sim.sm_phases import marker_from_counts
from blub_tpu_torch.testing import crowded_table, moving_box, random_table, x_window, z_wall_inputs

torch.set_num_threads(1)

G = (16, 8, 8)
DT = np.float32(1.0 / 120.0)


def _table(k, seed):
    return random_table(G, k, seed, hi=(8, 6, 7))


def _marker(rng, fluid=0.7, shape=G):
    m = np.where(rng.random(shape) < fluid, 1, -1).astype(np.int8)
    m[0], m[-1], m[:, 0], m[:, -1], m[:, :, 0], m[:, :, -1] = 0, 0, 0, 0, 0, 0
    return torch.from_numpy(m)


def _faces(rng, scale, shape=G):
    out = []
    for c in range(3):
        g = (rng.standard_normal(shape) * scale).astype(np.float32)
        idx = [slice(None)] * 3
        idx[c] = -1
        g[tuple(idx)] = 0.0
        out.append(torch.from_numpy(g))
    return out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_versions():
    t = _table(8, 0)
    np.testing.assert_array_equal(p2g.p2g(t.posq, t.dyn).numpy(), p2g.p2g_plain(t.posq, t.dyn, False).numpy())
    got = rebin.pack(t.posq, t.dyn, 0, 2, 10)
    ref = rebin.pack_plain(t.posq, t.dyn, 0, 2, 10)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_kernel_arguments_are_validated():
    t = _table(8, 1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.require(t.posq, torch.int32, t.posq.shape, "posq")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="int32"):
            cuda.require(t.posq.cuda().float(), torch.int32, t.posq.shape, "posq")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda.build(["pack"])


def test_frame_graph_without_conditional_nodes_raises(monkeypatch):
    """Where the runtime or the driver has no conditional nodes, composing
    the frame graph raises, naming PyTorch's CUDA, the library's runtime and
    the driver's version; nothing falls back to a host read."""
    from blub_tpu_torch.ops import graph

    class NoConditionals:
        def frame_graph_build(self, head, maxn, n_sub, segs, nsegs, bodies, gos, runs, g, e):
            return 801  # cudaErrorNotSupported

        def blub_error_string(self, err):
            return b"operation not supported"

        def cuda_versions(self, runtime, driver):
            runtime._obj.value, driver._obj.value = 12030, 12020
            return 0

    class Captured:
        def raw_cuda_graph(self):
            return 1

    def chain():
        c = graph.Chain(None)
        c.segments.append(Captured())
        return c

    monkeypatch.setattr(graph, "_lib", lambda: NoConditionals())
    with pytest.raises(RuntimeError, match=r"conditional nodes failed.*12\.4.*'runtime': '12\.3', 'driver': '12\.2'"):
        graph.BranchGraph(graph.Captures(), chain(), [chain(), chain()], torch.zeros((), dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [G, (13, 11, 9)], ids=["16x8x8", "13x11x9"])
@pytest.mark.parametrize("k", [8, 24])
def test_p2g_kernel(card, k, grid):
    """Exact in both modes. At K=8 the seeded cube fills every slot of its
    cells; the cells around it are empty."""
    t = random_table(grid, k, 2, hi=(grid[0] // 2, grid[1] - 2, grid[2] - 2))
    counts = valid_mask(t.posq).sum(0)
    assert (counts == 0).any() and (k > 8 or (counts == k).any())
    before = cuda.launch_counts()["p2g"]
    for density in (False, True):
        ref = p2g.p2g_plain(t.posq, t.dyn, density)
        got = p2g.p2g(t.posq.to(card), t.dyn.to(card), density)
        assert torch.equal(got.cpu(), ref)
    assert cuda.launch_counts()["p2g"] == before + 2


# 274,365 cells: not a multiple of 256, and more than the 2048 x 132 threads
# an H100 holds at once, so the persistent solve's threads walk several cells
PCG_GRID = (67, 65, 63)
PCG_CONFIGS = [SolverConfig(), SolverConfig(error_tolerance=0.01, max_num_iterations=20, error_check_frequency=3),
               SolverConfig(error_tolerance=0.0, max_num_iterations=7, error_check_frequency=4)]


def _pcg_problem(shape, seed):
    """(marker, rhs, p0) on the CPU: 85 % fluid at random, a SOLID border."""
    rng = np.random.default_rng(seed)
    marker = _marker(rng, 0.85, shape)
    rhs = torch.where(marker == 1, torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * 30, 0.0)
    return marker, rhs, torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [G, PCG_GRID], ids=["16x8x8", "67x65x63"])
@pytest.mark.parametrize("cfg", PCG_CONFIGS, ids=["default", "tight", "capped"])
def test_pcg_kernel(card, cfg, shape):
    marker, rhs, p0 = _pcg_problem(shape, 3)
    if shape == PCG_GRID:
        assert pcg.solve_blocks(shape) * pcg.SOLVE_THREADS < marker.numel()  # grid-stride
    ref = solve_pressure_plain(p0, rhs, marker, cfg, DT)
    got = pcg.solve_pressure(p0.to(card), rhs.to(card), marker.to(card), cfg, DT)
    its = got.stats.iterations
    assert its.dtype == torch.int32 and its.dim() == 0 and its.is_cuda
    its = int(its)
    assert abs(its - int(ref.stats.iterations)) <= cfg.error_check_frequency
    if cfg.error_tolerance == 0.0:
        assert its == cfg.max_num_iterations
    # the plain solve run for exactly the kernel's iteration count
    fixed = dataclasses.replace(cfg, max_num_iterations=its, error_tolerance=0.0)
    ref = solve_pressure_plain(p0, rhs, marker, fixed, DT)
    assert int(ref.stats.iterations) == its
    scale = ref.pressure.abs().max().item()
    np.testing.assert_allclose(got.pressure.cpu().numpy(), ref.pressure.numpy(), rtol=1e-4, atol=1e-4 * scale)
    # max|r| after the last iteration, which is a check iteration of both runs
    np.testing.assert_allclose(got.stats.error.item(), ref.stats.error.item(), rtol=1e-3)
    if its < cfg.max_num_iterations:
        assert got.stats.error.item() < cfg.error_tolerance


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [G, PCG_GRID], ids=["16x8x8", "67x65x63"])
@pytest.mark.parametrize("freq", [1, 3])
def test_pcg_history_kernel(card, shape, freq):
    """The history instantiation against the plain version: the production
    solve's bits with the flag on, one launch counted under its own name,
    the history finite exactly for the iterations run and +inf after, its
    last entry the stats error, iterations within one check window of the
    plain solve, and against the plain solve run for the kernel's iteration
    count every entry within rtol 1e-3 (the dot products sum in another
    order)."""
    cfg = SolverConfig(error_tolerance=0.01, max_num_iterations=24, error_check_frequency=freq)
    marker, rhs, p0 = _pcg_problem(shape, 6)
    args = (p0.to(card), rhs.to(card), marker.to(card), cfg, DT)
    before = cuda.launch_counts()
    got = pcg.solve_pressure(*args, with_history=True)
    prod = pcg.solve_pressure(*args)
    after = cuda.launch_counts()
    assert (after["pcg_history"] - before["pcg_history"], after["pcg"] - before["pcg"]) == (1, 1)
    for a, b in ((got.pressure, prod.pressure), (got.stats.iterations, prod.stats.iterations),
                 (got.stats.error, prod.stats.error)):
        assert torch.equal(a, b)
    its = int(got.stats.iterations)
    hist = got.history.cpu().numpy()
    assert np.all(np.isfinite(hist[:its])) and np.all(np.isposinf(hist[its:]))
    assert hist[its - 1] == np.float32(got.stats.error.item())
    ref = solve_pressure_plain(p0, rhs, marker, cfg, DT, with_history=True)
    assert abs(its - int(ref.stats.iterations)) <= freq
    fixed = dataclasses.replace(cfg, max_num_iterations=its, error_tolerance=0.0)
    ref = solve_pressure_plain(p0, rhs, marker, fixed, DT, with_history=True)
    np.testing.assert_allclose(hist[:its], ref.history.numpy(), rtol=1e-3)

@pytest.mark.gpu
def test_pcg_solve_no_host_sync(card):
    """A solve reads nothing back (PyTorch's sync debug mode raises on any
    synchronising call), launches once, and repeats bit for bit."""
    marker, rhs, p0 = (t.to(card) for t in _pcg_problem(PCG_GRID, 4))
    cfg = SolverConfig()
    pcg.solve_pressure(p0, rhs, marker, cfg, DT)  # build, load and size outside the check
    torch.cuda.synchronize()
    before = cuda.launch_counts()["pcg"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = pcg.solve_pressure(p0, rhs, marker, cfg, DT)
        b = pcg.solve_pressure(p0, rhs, marker, cfg, DT)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda.launch_counts()["pcg"] == before + 2
    for x, y in ((a.pressure, b.pressure), (a.stats.iterations, b.stats.iterations), (a.stats.error, b.stats.error)):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_pcg_solve_sums_in_the_pass_order(card, monkeypatch):
    """The solve sums in the pass kernels' order whatever its block count,
    so a grid of 8 blocks gives the bits of the grid that fills the card,
    and both give those of the passes run one launch at a time."""
    marker, rhs, _ = (t.to(card) for t in _pcg_problem(PCG_GRID, 5))
    zero = torch.zeros_like(rhs)  # p0 = 0: r0 = rhs on fluid cells
    cfg = SolverConfig(error_tolerance=0.0, max_num_iterations=6)
    full = pcg.solve_pressure(zero, rhs, marker, cfg, DT)
    monkeypatch.setitem(pcg._BLOCKS, (torch.cuda.current_device(), PCG_GRID, False), 8)
    few = pcg.solve_pressure(zero, rhs, marker, cfg, DT)
    diag, dfl = pcg.pass_setup(marker)
    p, r, s = zero.clone(), torch.where(dfl > 0.0, rhs, 0.0), zero.clone()
    scal = torch.zeros(4, dtype=torch.float32, device=card)
    r, z = pcg.k2_pass(p, r, s, s, None, scal, diag, dfl)
    for _ in range(cfg.max_num_iterations):
        s, As, part = pcg.k1_pass(z, s, scal, diag, dfl)
        r, z = pcg.k2_pass(p, r, s, As, part, scal, diag, dfl)
    for got in (full, few):
        assert int(got.stats.iterations) == cfg.max_num_iterations
        assert torch.equal(got.pressure, p)
        assert torch.equal(got.stats.error, scal[pcg.ERR] * float(DT))


@pytest.mark.gpu
def test_gridfix_kernel(card):
    rng = np.random.default_rng(4)
    marker = _marker(rng)
    p = torch.from_numpy(rng.standard_normal(G).astype(np.float32))
    vel = [torch.from_numpy(rng.standard_normal(G).astype(np.float32)) for _ in range(3)]
    pairs = (
        (gridfix.gridfix_remove(vel, p, marker), gridfix.gridfix_remove([v.to(card) for v in vel], p.to(card), marker.to(card))),
        (gridfix.gridfix_change(p, marker, DT), gridfix.gridfix_change(p.to(card), marker.to(card), DT)),
    )
    for ref, got in pairs:
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


@pytest.mark.gpu
def test_g2p_kernel(card):
    rng = np.random.default_rng(5)
    t = _table(16, 5)
    vel = _faces(rng, 60.0)
    rp, rd, rms = g2p.advect(t.posq, vel, DT)
    gp, gd, gms = g2p.advect(t.posq.to(card), [v.to(card) for v in vel], DT)
    np.testing.assert_array_equal(gp.cpu().numpy(), rp.numpy())
    np.testing.assert_array_equal(gd.cpu().numpy(), rd.numpy())
    assert gms.item() == rms.item()
    change, marker = _faces(rng, 0.3), _marker(rng)
    ref = g2p.correct(t.posq, change, marker)
    got = g2p.correct(t.posq.to(card), [c.to(card) for c in change], marker.to(card))
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("axis,s,k_out", [(0, 2, 12), (0, 1, 4), (1, 2, 8), (2, 1, 4)])
def test_pack_kernel(card, axis, s, k_out):
    """Pack the table that a fast advect left off its bins (overflow at
    k_out 4 included)."""
    t = _table(8, 6)
    posq, dyn, _ = g2p.advect(t.posq, _faces(np.random.default_rng(6), 150.0), DT)
    ref = rebin.pack_plain(posq, dyn, axis, s, k_out)
    assert ref[2].item() > 0 or k_out > 4
    got = rebin.pack(posq.to(card), dyn.to(card), axis, s, k_out)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


def _moved(grid, k, seed, speed):
    """A seeded table of k slots moved by a fast advect, off its bins."""
    t = random_table(grid, k, seed, hi=(grid[0] // 2, grid[1] - 2, grid[2] - 2))
    posq, dyn, _ = g2p.advect(t.posq, _faces(np.random.default_rng(seed), speed, grid), DT)
    return posq, dyn


# (grid, K, s, k_out): the y stage takes the x pack's K + 1 slots (K_mid up
# to 25); 13x11x9 and 9x13x40 leave ragged y tiles (the block owns whole z
# rows, min(Y, 256 // Z) of them); k_out 3 and 4 overflow
PACK_YZ_CASES = [((13, 11, 9), 8, 1, 8), ((13, 11, 9), 8, 2, 4), ((9, 13, 40), 24, 2, 24),
                 ((9, 13, 40), 24, 1, 3), ((16, 8, 8), 16, 2, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("grid,k,s,k_out", PACK_YZ_CASES, ids=[f"{g[0]}x{g[1]}x{g[2]}-K{k}-s{s}-{ko}"
                                                                 for g, k, s, ko in PACK_YZ_CASES])
def test_pack_yz_kernel(card, grid, k, s, k_out):
    """The fused y + z kernel against pack_plain(y) then pack_plain(z), bit
    for bit, with the y and z stages' dropped and kept counts; one launch."""
    posq, dyn = _moved(grid, k, 11, 150.0)
    posq, dyn, _, _ = rebin.pack_plain(posq, dyn, 0, s, k + 1)
    ref = rebin.pack_yz_plain(posq, dyn, s, k_out)
    if k_out < 5:
        assert ref[2][2].item() > 0  # the z stage overflows
    before = cuda.launch_counts()["pack_yz"]
    got = rebin.pack_yz(posq.to(card), dyn.to(card), s, k_out)
    assert cuda.launch_counts()["pack_yz"] == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_kernels_raise_beyond_64_slots(card):
    t = _table(13, 1)
    posq = torch.cat([t.posq] * 5).to(card)  # 65 slots
    dyn = torch.cat([t.dyn] * 5).to(card)
    with pytest.raises(ValueError, match="64"):
        p2g.p2g(posq, dyn)
    with pytest.raises(ValueError, match="64"):
        rebin.pack(posq, dyn, 0, 2, 8)
    with pytest.raises(ValueError, match="64"):
        rebin.pack(posq[:40], dyn[:40], 0, 2, 65)
    with pytest.raises(ValueError, match="64"):
        rebin.pack_yz(posq, dyn, 2, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [33, 40, 64])
def test_wide_tables(card, k):
    """Beyond 32 slots (the 64-bit mask instantiations): p2g on a table
    whose cells use every slot, then an x pack to k + 4 (at most 64) and the
    fused y + z pack back to k of one moved off its bins, with overflow; bit
    for bit against the plain versions, one launch each."""
    grid = (13, 11, 9)
    t = crowded_table(grid, k, 20, fill=0.9)
    assert valid_mask(t.posq).sum(0).max().item() > 32
    for density in (False, True):
        assert torch.equal(p2g.p2g(t.posq.to(card), t.dyn.to(card), density).cpu(),
                           p2g.p2g_plain(t.posq, t.dyn, density))
    m = crowded_table(grid, k, 21, fill=0.6, reach=2.45)
    k_mid = min(k + 4, 64)
    ref = rebin.pack_plain(m.posq, m.dyn, 0, 2, k_mid)
    before = cuda.launch_counts()
    got = rebin.pack(m.posq.to(card), m.dyn.to(card), 0, 2, k_mid)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
    ref_yz = rebin.pack_yz_plain(ref[0], ref[1], 2, k)
    assert ref_yz[2][2].item() > 0  # the z stage overflows
    got_yz = rebin.pack_yz(ref[0].to(card), ref[1].to(card), 2, k)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got_yz, ref_yz))
    after = cuda.launch_counts()
    assert (after["pack"] - before["pack"], after["pack_yz"] - before["pack_yz"]) == (1, 1)


# no multiple of the kernels' tiles, and particles and fluid on every border:
# the cyclic wrap of the G2P windows and the zero fill of gridfix's
ODD = (20, 12, 10)


def _odd_marker(rng, solids=None):
    """A fluid-rich marker with fluid on every border and air and solid
    cells anywhere; with ``solids`` also solid where they are."""
    m = np.where(rng.random(ODD) < 0.75, 1, -1).astype(np.int8)
    m[rng.random(ODD) < 0.08] = 0
    if solids is not None:
        m[solids.occupancy.numpy() != 0] = 0
    return torch.from_numpy(m)


@pytest.mark.gpu
def test_g2p_kernel_odd_shape(card):
    """Advect (both specialisations, the box on the -x border so the solid
    windows wrap) and correct at 20x12x10 with particles in every cell."""
    rng = np.random.default_rng(22)
    t = crowded_table(ODD, 12, 22, fill=0.7)
    assert (valid_mask(t.posq).sum(0) > 0).all()
    vel, change = _faces(rng, 60.0, ODD), _faces(rng, 0.3, ODD)
    sol = moving_box(ODD, (0, 1, 2), (4, 7, 10), (-35.0, 4.0, 2.0))
    for occ, sv in ((None, None), (sol.occupancy, sol.velocity)):
        ref = g2p.advect(t.posq, vel, DT, occ, sv)
        got = g2p.advect(t.posq.to(card), [v.to(card) for v in vel], DT,
                         *(None if a is None else a.to(card) for a in (occ, sv)))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
    marker = _odd_marker(rng)
    ref = g2p.correct(t.posq, change, marker)
    got = g2p.correct(t.posq.to(card), [c.to(card) for c in change], marker.to(card))
    assert torch.equal(got.cpu(), ref)


@pytest.mark.gpu
def test_gridfix_kernel_odd_shape(card):
    """Both modes, and remove with solids, at 20x12x10 with fluid on every
    border."""
    rng = np.random.default_rng(23)
    p = torch.from_numpy(rng.standard_normal(ODD).astype(np.float32))
    vel = [torch.from_numpy(rng.standard_normal(ODD).astype(np.float32)) for _ in range(3)]
    sol = moving_box(ODD, (0, 1, 2), (4, 7, 10), (-35.0, 4.0, 2.0))
    marker, smarker = _odd_marker(rng), _odd_marker(rng, sol)
    for m in (marker, smarker):
        assert all(bool((m[tuple(idx)] == 1).any()) for idx in ((0,), (-1,), (slice(None), 0), (slice(None), -1),
                                                                 (slice(None), slice(None), 0),
                                                                 (slice(None), slice(None), -1)))
    gv, gp = [v.to(card) for v in vel], p.to(card)
    pairs = (
        (gridfix.gridfix_remove(vel, p, marker), gridfix.gridfix_remove(gv, gp, marker.to(card))),
        (gridfix.gridfix_change(p, marker, DT), gridfix.gridfix_change(gp, marker.to(card), DT)),
        (gridfix.gridfix_remove(vel, p, smarker, sol.velocity),
         gridfix.gridfix_remove(gv, gp, smarker.to(card), sol.velocity.to(card))),
    )
    for ref, got in pairs:
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))


@pytest.mark.gpu
def test_glue_on_the_card(card):
    """The dense glue gives the CPU's bits on the card: the density RHS
    (which divides by a device tensor, as JAX divides), the marker with and
    without solids, normalize_velocity, the divergence RHS and the
    voxelization of a moving box."""
    t = _table(16, 24)
    sol = moving_box(G, (4, 2, 2), (7, 5, 6), (-35.0, 4.0, 2.0))
    gsol = moving_box(G, (4, 2, 2), (7, 5, 6), (-35.0, 4.0, 2.0), device=card)
    assert torch.equal(gsol.occupancy.cpu(), sol.occupancy) and torch.equal(gsol.velocity.cpu(), sol.velocity)
    acc, dacc = p2g.p2g(t.posq, t.dyn), p2g.p2g(t.posq, None, density=True)
    for dt in (DT, DT / np.float32(3)):  # the substep dts of n_sub 1 and 3
        for s in (None, sol):
            occ, sv = (None, None) if s is None else (s.occupancy, s.velocity)
            outs = []
            for dev in ("cpu", card):
                def on(x):
                    return None if x is None else x.to(dev)
                marker = marker_from_counts(on(acc)[6], G, on(occ))
                vel = p2g.normalize_velocity(on(acc), marker, (0.0, -981.0, 0.0), dt)
                outs.append([marker, *vel, compute_divergence_rhs(vel, marker, on(sv)),
                             density_rhs_from_raw(on(dacc)[0], marker_from_counts(on(dacc)[1], G, on(occ)), dt)])
            for a, b in zip(*outs):
                assert torch.equal(b.cpu(), a)


def _solids():
    """A box inside the test table's pool, moving -x (escape toward -x)."""
    return moving_box(G, (4, 2, 2), (7, 5, 6), (-35.0, 4.0, 2.0))


@pytest.mark.gpu
def test_g2p_solids_kernel(card):
    """The solids specialisation: escape, occupancy penetration, push."""
    rng = np.random.default_rng(7)
    t = _table(16, 7)
    vel = _faces(rng, 60.0)
    sol = _solids()
    rp, rd, rms = g2p.advect(t.posq, vel, DT, sol.occupancy, sol.velocity)
    before = cuda.launch_counts()["g2p_solids"]
    gp, gd, gms = g2p.advect(t.posq.to(card), [v.to(card) for v in vel], DT, sol.occupancy.to(card),
                             sol.velocity.to(card))
    assert cuda.launch_counts()["g2p_solids"] == before + 1
    np.testing.assert_array_equal(gp.cpu().numpy(), rp.numpy())
    np.testing.assert_array_equal(gd.cpu().numpy(), rd.numpy())
    assert gms.item() == rms.item()


@pytest.mark.gpu
def test_gridfix_solids_kernel(card):
    rng = np.random.default_rng(8)
    sol = _solids()
    counts = torch.from_numpy((rng.random(G) < 0.7).astype(np.float32))
    marker = marker_from_counts(counts, G, sol.occupancy)
    p = torch.from_numpy(rng.standard_normal(G).astype(np.float32))
    vel = [torch.from_numpy(rng.standard_normal(G).astype(np.float32)) for _ in range(3)]
    ref = gridfix.gridfix_remove(vel, p, marker, sol.velocity)
    got = gridfix.gridfix_remove([v.to(card) for v in vel], p.to(card), marker.to(card), sol.velocity.to(card))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


def test_copy_probe_plain():
    t = _table(8, 9)
    posq, dyn = copy_bw.round_trip(t.posq, t.dyn)
    assert torch.equal(posq, t.posq + 1) and torch.equal(dyn, t.dyn + 1)


@pytest.mark.gpu
def test_copy_kernel(card):
    """Both forms bit for bit against posq + 1, dyn + 1, one launch per
    round trip, at shapes that reach the kernel's edges: one 32-row tile
    (both halo clamps at once), Y = 96 (a middle tile), Z = 4 (one 16-byte
    word a row), many planes, an odd X, a ragged last block and the end of
    posq inside a block."""
    rng = np.random.default_rng(9)
    for k, x, y, z in ((3, 4, 64, 8), (2, 3, 32, 16), (1, 5, 96, 4), (40, 7, 32, 4), (5, 9, 64, 12)):
        posq = torch.from_numpy(rng.integers(-2**31, 2**31, (k, 2, x, y, z), dtype=np.int64).astype(np.int32))
        dyn = torch.from_numpy(rng.integers(-2**31, 2**31, (k, 6, x, y, z), dtype=np.int64).astype(np.int32))
        ref = copy_bw.round_trip_plain(posq, dyn)
        for halo in (False, True):
            before = cuda.launch_counts()["copy"]
            got = copy_bw.round_trip(posq.to(card), dyn.to(card), halo)
            assert cuda.launch_counts()["copy"] == before + 1
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


@pytest.mark.gpu
def test_relops_kernel(card):
    """Kernel, plain version and the script's numpy expressions on the seed-0
    inputs, the tie, the +-1.5, -0.5 and +2.5 quantum ties and +-3.5 cells."""
    before = cuda.launch_counts()["relops"]
    assert relops.check(card) == 0.0
    assert cuda.launch_counts()["relops"] == before + len(relops.cases())


def _noisy_invalid_slots(posq, dyn, seed):
    """Random words in the invalid slots, valid bit clear, so that reading
    them (ungated) or copying them shows."""
    rng = np.random.default_rng(seed)
    v = (posq[:, 1:2] & 1) == 1
    gp = torch.from_numpy(rng.integers(-2**31, 2**31, posq.shape, dtype=np.int64).astype(np.int32))
    gp[:, 1] &= -2
    gd = torch.from_numpy(rng.integers(-2**31, 2**31, dyn.shape, dtype=np.int64).astype(np.int32))
    return torch.where(v, posq, gp), torch.where(v, dyn, gd)


def _random_slots(k, grid, seed):
    """posq, dyn [k, ., *grid]: random words, the valid bit set on 40 % of
    the slots (any slot, so that high slots hold particles too) and clear on
    the others, whose words stay noise."""
    rng = np.random.default_rng(seed)
    pq = rng.integers(-2**31, 2**31, (k, 2) + grid, dtype=np.int64).astype(np.int32)
    dy = rng.integers(-2**31, 2**31, (k, 6) + grid, dtype=np.int64).astype(np.int32)
    valid = rng.random((k,) + grid) < 0.4
    pq[:, 1] = np.where(valid, pq[:, 1] | 1, pq[:, 1] & -2)
    return torch.from_numpy(pq), torch.from_numpy(dy)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", yz_floor.VARIANTS)
def test_yz_floor_kernel(card, variant):
    """Each variant against its plain version at 32x16x16 (K=8 + 2 empty
    slots, s=2), particles moved off their seeding lattice; for all but full
    (the pack, which needs valid tables) with noise in the invalid slots.
    read also at k_in 1, 15 and 33, s 0, 1 and 2, Y 12 (with Z = 6: 4-cell
    words that span rows) and 64, valid slots anywhere, and one launch of
    its kernel a call."""
    posq, dyn, _ = yz_floor.seeded_table((32, 16, 16), 8, pad=2, device="cpu")
    posq = torch.cat([rebin_sweep.jiggle(posq[:8], 1, 1.2), posq[8:]])
    if variant != "full":
        posq, dyn = _noisy_invalid_slots(posq, dyn, 10)
    ref = yz_floor.run_plain(variant, posq, dyn, 2, 8)
    got = yz_floor.run(variant, posq.to(card), dyn.to(card), 2, 8)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    if variant != "read":
        return
    for i, (k, grid, s) in enumerate((k, grid, s) for k in (1, 15, 33) for grid in ((5, 12, 6), (3, 64, 16))
                                     for s in (0, 1, 2)):
        posq, dyn = _random_slots(k, grid, 20 + i)
        (ref,) = yz_floor.run_plain("read", posq, dyn, s, 1)
        before = cuda.launch_counts()["yz_floor_read"]
        (got,) = yz_floor.run("read", posq.to(card), dyn.to(card), s, 1)
        assert cuda.launch_counts()["yz_floor_read"] == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy(), err_msg=f"k_in {k}, grid {grid}, s {s}")


@pytest.mark.gpu
def test_pcg_passes_kernel(card):
    """k1_pass and k2_pass against their plain versions on the card."""
    pcg_passes.check(pcg_passes.inputs(G, card))


# -- the frame as CUDA-graph replays ------------------------------------------


def _frame_setup(k=16):
    from blub_tpu_torch.core.seeding import add_fluid_cube
    from blub_tpu_torch.core.types import SimParams

    pos = add_fluid_cube(G, (1, 1, 1), (8, 6, 7), 10**9)
    return SimParams(grid_dim=G, dt=float(DT), gravity_grid=(0.0, -981.0, 0.0), num_particles=pos.shape[0]), pos


def _state_bits(s):
    """Every tensor of a state, cloned to the CPU."""
    return [t.detach().cpu().clone() for t in (
        s.table.posq, s.table.dyn, s.table.lost, s.pressure_vel, s.pressure_den, s.max_speed,
        s.stats_vel.error, s.stats_vel.iterations, s.stats_den.error, s.stats_den.iterations, s.step_index)]


def _frames(params, state, maxs, graphs, forced=None):
    """Frames at a tiny CFL target (n_sub = max_substeps once anything
    moves), max_substeps from ``maxs`` per frame, or (``forced``: a list of
    n) at CFL 1.9 with at most 4 substeps, the max speed set before each
    frame so that the count is that n: graph launches or eager frames. ->
    (bits after each frame, n_sub per frame, launch counts, last state)."""
    from blub_tpu_torch.sim.step_dense import eager_frame, frame_dense, substep_count

    cfl = 1e-6 if forced is None else 1.9
    cuda.reset_launch_counts()
    bits, subs = [], []
    for i, m in enumerate(maxs if forced is None else [4] * len(forced)):
        if forced is not None:
            state.max_speed.fill_(float(np.float32((forced[i] - 0.5) * cfl / params.dt)))
        if graphs:
            state, n = frame_dense(params, state, None, cfl_target=cfl, max_substeps=m)
        else:
            n = substep_count(params, state, cfl, m)
            state = eager_frame(params, state, lambda i, n: None, n)
        bits.append(_state_bits(state))
        subs.append(int(n))
    torch.cuda.synchronize()
    return bits, subs, cuda.launch_counts(), state


@pytest.mark.gpu
@pytest.mark.parametrize("n_sub", [1, 2, 3, 4])
def test_graph_frame_matches_eager(card, n_sub):
    """Graph launches give the eager frames' bits (table, lost, both
    pressures, max speed, solver stats, step_index), the same n_sub (picked
    on the card) and the same launch counts."""
    from blub_tpu_torch.sim.step_dense import make_dense_state

    params, pos = _frame_setup()
    eager = _frames(params, make_dense_state(params, pos, 16, device=card), [n_sub] * 5, graphs=False)
    graph = _frames(params, make_dense_state(params, pos, 16, device=card), [n_sub] * 5, graphs=True)
    runner = graph[3].runner
    assert runner is not None and runner.graph is not None and runner.maxn == n_sub
    assert graph[1] == eager[1] == [1] + [n_sub] * 4
    assert graph[2] == eager[2]
    for a, b in zip(graph[0], eager[0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_graph_frames_interleave_their_n_sub(card):
    """The branches of one frame graph share one memory pool: forced by the
    max speed into any order, they give the eager bits."""
    from blub_tpu_torch.sim.step_dense import make_dense_state

    params, pos = _frame_setup()
    forced = [1, 4, 2, 3, 4, 1, 2, 2, 3]
    eager = _frames(params, make_dense_state(params, pos, 16, device=card), None, graphs=False, forced=forced)
    graph = _frames(params, make_dense_state(params, pos, 16, device=card), None, graphs=True, forced=forced)
    assert graph[1] == eager[1] == forced and graph[3].runner.maxn == 4
    assert graph[2] == eager[2]
    for a, b in zip(graph[0], eager[0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


_PISTON = {
    "gravity": {"x": 0.0, "y": -9.81, "z": 0.0},
    "fluid": {
        "world_position": {"x": 0.0, "y": 0.0, "z": 0.0}, "grid_to_world_scale": 0.01,
        "grid_dimension": {"x": 24, "y": 16, "z": 16}, "max_num_particles": 10**7,
        "fluid_cubes": [{"min": {"x": 0.04, "y": 0.0, "z": 0.0}, "max": {"x": 0.24, "y": 0.06, "z": 0.14}}],
    },
    "static_objects": [{
        "model": "cube.obj", "world_position": {"x": 0.24, "y": 0.0, "z": 0.0}, "scale": 0.08,
        "rotation_angles": {"x": 0.0, "y": 0.0, "z": 0.0},
        "animation": {"translation": {"target": {"x": 0.12, "y": 0.0, "z": 0.0}, "curve": "Linear",
                                      "duration": 0.2}},
    }],
}  # the piston scene of tests/test_torch_solids.py


@pytest.mark.gpu
def test_graph_scene_matches_eager(card):
    """The piston Scene on the card: graph launches (voxelization captured,
    every split's parameters uploaded per frame, n_sub picked on the card)
    against Scene(graphs=False), frame by frame: state bits, n_sub, the last
    substep's solids, launch counts; the non-blocking stats and
    last_substeps catch up with the blocking ones."""
    from blub_tpu_torch.core import config
    from blub_tpu_torch.runtime.scene import Scene

    cfg = config.load_scene_dict(_PISTON, "piston")
    settings = config.SimSettings(cfl_target=0.25)  # n_sub 2-4 at the piston's 60 cells/s and the fall
    runs = []
    for graphs in (False, True):
        scene = Scene(cfg, settings, capacity=16, device=card, graphs=graphs)
        cuda.reset_launch_counts()
        frames = []
        for _ in range(14):
            scene.step()
            n_sub = int(scene._runner.n_sub) if graphs else scene.last_substeps
            frames.append((_state_bits(scene.state), n_sub, scene.solids.occupancy.cpu().clone(),
                           scene.solids.velocity.cpu().clone()))
        torch.cuda.synchronize()
        runs.append((frames, cuda.launch_counts(), scene))
    (eager, eager_counts, _), (graph, graph_counts, scene) = runs
    assert scene._runner is not None and scene._runner.graph is not None
    assert [f[1] for f in graph] == [f[1] for f in eager] and max(f[1] for f in graph) > 1
    assert graph_counts == eager_counts and graph_counts["advect_pack_solids"] > 0
    for (a, _, occ_a, vel_a), (b, _, occ_b, vel_b) in zip(graph, eager):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert torch.equal(occ_a, occ_b) and torch.equal(vel_a, vel_b)
    scene.step()
    torch.cuda.synchronize()
    for _ in range(2):
        got = scene.solver_stats(block=False)
    assert got == scene.solver_stats(block=True) and scene.last_substeps == int(scene._runner.n_sub)
    scene.reset()
    scene.step()  # the graphs run on from the refilled static state
    assert scene.num_particles() + scene.solver_stats()["lost_particles"] == scene.params.num_particles


@pytest.mark.gpu
def test_pcg_solve_in_a_graph(card):
    """The cooperative PCG launch captured into a CUDA graph and replayed
    twice gives the eager solve's bits."""
    marker, rhs, p0 = (t.to(card) for t in _pcg_problem(PCG_GRID, 6))
    cfg = SolverConfig()
    ref = pcg.solve_pressure(p0, rhs, marker, cfg, DT)
    graph = torch.cuda.CUDAGraph()
    with cuda.capture_tally() as tally, torch.cuda.graph(graph):
        got = pcg.solve_pressure(p0, rhs, marker, cfg, DT)
    assert tally == {"pcg": 1}
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for x, y in ((got.pressure, ref.pressure), (got.stats.iterations, ref.stats.iterations),
                     (got.stats.error, ref.stats.error)):
            assert torch.equal(x, y)


@pytest.mark.gpu
def test_graph_frame_syncs_once(card):
    """A frame that launches the graph never waits for the card: its n_sub
    is picked on the card (PyTorch's sync debug mode names every wait; each
    is counted against the frame that made it). The eager frame's max-speed
    read after them is the positive control."""
    import traceback
    import warnings

    from blub_tpu_torch.sim.step_dense import frame_dense, make_dense_state, substep_count

    params, pos = _frame_setup()
    state = make_dense_state(params, pos, 16, device=card)
    for _ in range(3):  # the eager first frame, then the capture
        state, _ = frame_dense(params, state, None, cfl_target=1e-6, max_substeps=2)
    torch.cuda.synchronize()
    frame, syncs = [-1], []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            names = [f.name for f in traceback.extract_stack() if "blub_tpu_torch" in f.filename]
            syncs.append((frame[0], names[-1] if names else f"{filename}:{lineno}"))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(4):
                frame[0] = i
                state, n = frame_dense(params, state, None, cfl_target=1e-6, max_substeps=2)
            frame[0] = "control"
            substep_count(params, state, 1e-6, 2)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert int(n) == 2 and state.runner.graph is not None
    syncs = [s for s in syncs if s[0] != -1]  # -1: the mode's own notice as it is switched on
    assert syncs and all(f == "control" for f, _ in syncs), syncs


@pytest.mark.gpu
@pytest.mark.parametrize("grid,k", [((24, 16, 16), 8), ((8, 8, 128), 4)], ids=["Z16", "Z128"])
def test_g2p_kernel_z_walls(card, grid, k):
    """Every G2P instantiation on inputs whose reads meet both z walls
    (``testing.z_wall_inputs``: zeros past them at Z = 16, cyclic at Z =
    128) against its plain version, bit for bit: advect with and without
    solids, correct, and their x-window forms on two windows."""
    d = z_wall_inputs(grid, k, 12)
    g = {key: ([t.to(card) for t in v] if isinstance(v, list) else v) for key, v in d.items()}
    posq, gposq = d["table"].posq, d["table"].posq.to(card)
    for solid in (False, True):
        o, v = (d["occupancy"], d["solid_velocity"]) if solid else (None, None)
        rp, rd, rms = g2p.advect(posq, d["faces"], DT, o, v)
        gp, gd, gms = g2p.advect(gposq, g["faces"], DT, None if o is None else o.to(card),
                                 None if v is None else v.to(card))
        assert torch.equal(gp.cpu(), rp) and torch.equal(gd.cpu(), rd) and gms.item() == rms.item()
    ref = g2p.correct(posq, d["change"], d["marker"])
    assert torch.equal(g2p.correct(gposq, g["change"], d["marker"].to(card)).cpu(), ref)
    xl, h = grid[0] // 2, 2
    for x0 in (0, xl):
        pq = x_window(posq, 2, x0, xl, h, False)
        fw = [x_window(f, 0, x0, xl, h, True) for f in d["faces"]]
        ow, sw = x_window(d["occupancy"], 0, x0, xl, h, True), x_window(d["solid_velocity"], 1, x0, xl, h, True)
        rp, rd, _ = g2p.advect_plain(pq, fw, DT, ow, sw, x0 - h, grid)
        gp, gd, _ = g2p.advect(pq.to(card), [f.to(card) for f in fw], DT, ow.to(card), sw.to(card), x_start=x0 - h,
                               domain=grid)
        assert torch.equal(gp.cpu(), rp) and torch.equal(gd.cpu(), rd)
        cw, mw = [x_window(c, 0, x0, xl, h, True) for c in d["change"]], x_window(d["marker"], 0, x0, xl, h, True)
        got = g2p.correct(pq.to(card), [c.to(card) for c in cw], mw.to(card), x_start=x0 - h, domain=grid)
        assert torch.equal(got.cpu(), g2p.correct_plain(pq, cw, mw, x0 - h, grid))


@pytest.mark.gpu
def test_profile_step_on_the_card(card):
    """The profiler's eager per-phase timing runs the kernels on the card
    and names JAX's phases."""
    from blub_tpu_torch.runtime import profiler
    from blub_tpu_torch.sim.step_dense import frame_dense, make_dense_state

    params, pos = _frame_setup()
    state, _ = frame_dense(params, make_dense_state(params, pos, 16, device=card), None)
    before = cuda.launch_counts()
    means, _ = profiler.profile_step(params, state, repeats=2)
    after = cuda.launch_counts()
    assert list(means) == list(profiler.PHASES) and means["extrapolate"] == 0.0
    assert all(v > 0 for k, v in means.items() if k != "extrapolate")
    assert after["pcg"] - before["pcg"] == 3 * 2 and after["pack_yz"] - before["pack_yz"] == 3 * 2
    # G2P fused with the x pack, as the step runs it
    assert after["advect_pack"] - before["advect_pack"] == 3 and after["correct_pack"] - before["correct_pack"] == 3
    assert after["g2p"] == before["g2p"] and after["pack"] == before["pack"]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4])
def test_g2p_window_kernels(card, n):
    """The x_start instantiations (advect with and without solids, correct)
    on each x-window against their plain versions and against the whole-grid
    kernel's core, bit for bit."""
    rng = np.random.default_rng(11)
    t = _table(16, 11)
    vel = [v.to(card) for v in _faces(rng, 60.0)]
    change = [c.to(card) for c in _faces(rng, 0.3)]
    marker = _marker(rng).to(card)
    sol = _solids()
    occ, sv = sol.occupancy.to(card), sol.velocity.to(card)
    posq = t.posq.to(card)
    xl = G[0] // n
    for solid in (False, True):
        o, v = (occ, sv) if solid else (None, None)
        wp, wd, wms = g2p.advect(posq, vel, DT, o, v)
        h = 2 if solid else 1
        name = "g2p_solids_xs" if solid else "g2p_xs"
        for x0 in range(0, G[0], xl):
            pq = x_window(posq, 2, x0, xl, h, False)
            vw = [x_window(u, 0, x0, xl, h, True) for u in vel]
            ow, svw = (x_window(occ, 0, x0, xl, h, True), x_window(sv, 1, x0, xl, h, True)) if solid else (None, None)
            before = cuda.launch_counts()[name]
            gp, gd, _ = g2p.advect(pq, vw, DT, ow, svw, x_start=x0 - h, domain=G)
            assert cuda.launch_counts()[name] == before + 1
            rp, rd, _ = g2p.advect_plain(pq.cpu(), [u.cpu() for u in vw], DT, None if ow is None else ow.cpu(),
                                         None if svw is None else svw.cpu(), x0 - h, G)
            assert torch.equal(gp.cpu(), rp) and torch.equal(gd.cpu(), rd)
            assert torch.equal(gp.narrow(2, h, xl), wp.narrow(2, x0, xl))
            assert torch.equal(gd.narrow(2, h, xl), wd.narrow(2, x0, xl))
    wc = g2p.correct(posq, change, marker)
    for x0 in range(0, G[0], xl):
        pq = x_window(posq, 2, x0, xl, 1, False)
        cw = [x_window(c, 0, x0, xl, 1, True) for c in change]
        mw = x_window(marker, 0, x0, xl, 1, True)
        gc = g2p.correct(pq, cw, mw, x_start=x0 - 1, domain=G)
        assert torch.equal(gc.cpu(), g2p.correct_plain(pq.cpu(), [c.cpu() for c in cw], mw.cpu(), x0 - 1, G))
        assert torch.equal(gc.narrow(2, 1, xl), wc.narrow(2, x0, xl))


@pytest.mark.gpu
@pytest.mark.parametrize("n,s", [(2, 2), (4, 2), (4, 1)])
def test_pack_window_kernel(card, n, s):
    """pack_kernel's x_start instantiation on each s-extended x-window
    against its plain version and the whole-grid pack's core."""
    t = crowded_table(G, 12, seed=5, reach=2.4 if s == 2 else 1.4)
    posq, dyn = t.posq.to(card), t.dyn.to(card)
    whole = rebin.pack(posq, dyn, 0, s, 14)
    xl = G[0] // n
    for x0 in range(0, G[0], xl):
        pq, dy = x_window(posq, 2, x0, xl, s, False), x_window(dyn, 2, x0, xl, s, False)
        before = cuda.launch_counts()["pack_xs"]
        gp, gd, _, _ = rebin.pack(pq, dy, 0, s, 14, x_start=x0 - s, dim=G[0])
        assert cuda.launch_counts()["pack_xs"] == before + 1
        rp, rd, _, _ = rebin.pack_plain(pq.cpu(), dy.cpu(), 0, s, 14, x0 - s, G[0])
        assert torch.equal(gp.cpu(), rp) and torch.equal(gd.cpu(), rd)
        assert torch.equal(gp.narrow(2, s, xl), whole[0].narrow(2, x0, xl))
        assert torch.equal(gd.narrow(2, s, xl), whole[1].narrow(2, x0, xl))


def _two_launches(posq, dyn, grids, solids, k_out, x_start=None, domain=None, advect=True):
    """G2P then the x pack, two launches (or their plain versions on the
    CPU): -> (posq, dyn, max speed or None, counts [dropped, kept])."""
    window = {} if x_start is None else {"x_start": x_start, "domain": domain}
    pack_window = {} if x_start is None else {"x_start": x_start, "dim": domain[0]}
    if advect:
        p, d, ms = g2p.advect(posq, grids, DT, *solids, **window)
        p, d, dr, kp = rebin.pack(p, d, 0, g2p.ADVECT_SHIFT, k_out, **pack_window)
    else:
        p, ms = g2p.correct(posq, grids[:3], grids[3], **window), None
        p, d, dr, kp = rebin.pack(p, dyn, 0, g2p.CORRECT_SHIFT, k_out, **pack_window)
    return p, d, ms, torch.stack([dr, kp])


def _fused_cases(grid, k, seed, fill=None):
    """A table moved off its bins by a fast flow (arrivals from both x
    neighbours, overflow at a small k_out), faces, changes, a marker and a
    moving box on the grid. ``fill``: the share of valid slots of a crowded
    table (1.0: every slot of every cell); by default 0.6 beyond 16 slots,
    else a fluid block over half the grid."""
    rng = np.random.default_rng(seed)
    if fill is None and k <= 16:
        t = random_table(grid, k, seed, hi=(grid[0] // 2,) + tuple(d - 2 for d in grid[1:]))
    else:
        t = crowded_table(grid, k, seed, fill=0.6 if fill is None else fill)
    sol = moving_box(grid, (0, 1, 2), (4, min(7, grid[1] - 1), min(6, grid[2] - 1)), (-35.0, 4.0, 2.0))
    return t, _faces(rng, 150.0, grid), _faces(rng, 0.6, grid), _odd_marker_of(rng, grid), sol


def _odd_marker_of(rng, grid):
    m = np.where(rng.random(grid) < 0.75, 1, -1).astype(np.int8)
    m[rng.random(grid) < 0.08] = 0
    return torch.from_numpy(m)


@pytest.mark.gpu
@pytest.mark.parametrize("grid,k,k_out,fill", [
    (G, 8, 12, None), (G, 8, 4, None), (ODD, 16, 17, None), ((13, 11, 9), 40, 44, None), ((13, 11, 9), 40, 64, None),
    ((37, 9, 45), 12, 13, None), ((20, 6, 36), 14, 15, 1.0), ((18, 5, 40), 64, 64, 1.0)],
    ids=["16x8x8-k8", "overflow", "20x12x10-k16", "k40", "k40-64", "37x9x45", "crowded-k14", "crowded-k64"])
def test_advect_pack_kernel(card, grid, k, k_out, fill):
    """advect_pack.cu (advect with and without solids, correct; 32-bit masks
    up to 32 slots, 64-bit beyond) against the plain composition on the CPU
    and the two launches it replaces on the card, bit for bit: posq, dyn,
    max speed, dropped and kept; one launch each. The edges of its design:
    x tiles of 13 planes with Z over 32 and not a multiple of 4 (the ragged
    row stores); every slot of every cell valid at 14 -> 15 and at 64 slots
    (the work lists and the stages at capacity; rows of 36 and 40 cells
    split into a 32-cell tile and a short one)."""
    t, vel, change, marker, sol = _fused_cases(grid, k, 31 + k, fill)
    on = [a.to(card) for a in (t.posq, t.dyn)]
    vel_c, change_c, marker_c = [v.to(card) for v in vel], [c.to(card) for c in change], marker.to(card)
    for solids in ((None, None), (sol.occupancy, sol.velocity)):
        solids_c = tuple(None if a is None else a.to(card) for a in solids)
        name = "advect_pack" if solids[0] is None else "advect_pack_solids"
        before = cuda.launch_counts()[name]
        got = advect_pack.advect_pack(*on[:1], vel_c, DT, *solids_c, k_out, with_counts=True)
        assert cuda.launch_counts()[name] == before + 1
        ref = advect_pack.advect_pack_plain(t.posq, vel, DT, *solids, k_out)
        two = _two_launches(on[0], None, vel_c, solids_c, k_out)
        assert ref[3][1].item() > 0
        for a, b, c in zip(got, ref, two):
            assert torch.equal(a.cpu(), b) and torch.equal(a, c)
    if k_out == 4:
        assert ref[3][0].item() > 0  # dropped
    before = cuda.launch_counts()["correct_pack"]
    got = advect_pack.correct_pack(*on, change_c, marker_c, k_out, with_counts=True)
    assert cuda.launch_counts()["correct_pack"] == before + 1
    ref = advect_pack.correct_pack_plain(t.posq, t.dyn, change, marker, k_out)
    two = _two_launches(on[0], on[1], change_c + [marker_c], (), k_out, advect=False)
    for a, b, c in zip(got, ref, two[:2] + two[3:]):
        assert torch.equal(a.cpu(), b) and torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("grid,n", [(G, 1), (G, 2), (G, 4), ((24, 8, 12), 2)],
                         ids=["1", "2", "4", "24x8x12-2"])
def test_advect_pack_window_kernels(card, grid, n):
    """The x_start forms of advect_pack.cu on the mesh's windows (the slab,
    its inner s halo planes real, its outer hx planes zero, the grids
    wrapped by h = s + hx) against their plain versions and the two-launch
    x_start composition, and their cores against the whole-grid fused
    kernel's, bit for bit. 24x8x12 at n = 2: advect's windows are 18 planes,
    a 16-plane tile and a 2-plane sliver had the tile stayed 16 planes."""
    t, vel, change, marker, sol = _fused_cases(grid, 12, 41)
    posq, dyn = t.posq.to(card), t.dyn.to(card)
    vel, change, marker = [v.to(card) for v in vel], [c.to(card) for c in change], marker.to(card)
    occ, sv = sol.occupancy.to(card), sol.velocity.to(card)
    k_out, xl = 13, grid[0] // n
    for phase, solid in (("advect", False), ("advect", True), ("correct", False)):
        s = g2p.ADVECT_SHIFT if phase == "advect" else g2p.CORRECT_SHIFT
        hx = 2 if solid else 1
        h = s + hx
        solids = (occ, sv) if solid else (None, None)
        if phase == "advect":
            whole = advect_pack.advect_pack(posq, vel, DT, *solids, k_out)
        else:
            whole = advect_pack.correct_pack(posq, dyn, change, marker, k_out)
        for x0 in range(0, grid[0], xl):
            def table(a):
                return torch.nn.functional.pad(x_window(a, 2, x0, xl, s, False), (0, 0, 0, 0, hx, hx))

            pq, dy = table(posq), table(dyn)
            grids = [x_window(g, 0, x0, xl, h, True) for g in (vel if phase == "advect" else change)]
            window = {"x_start": x0 - h, "domain": grid}
            if phase == "advect":
                sw = ((x_window(occ, 0, x0, xl, h, True), x_window(sv, 1, x0, xl, h, True)) if solid
                      else (None, None))
                name = "advect_pack_solids_xs" if solid else "advect_pack_xs"
                before = cuda.launch_counts()[name]
                got = advect_pack.advect_pack(pq, grids, DT, *sw, k_out, with_counts=True, **window)
                ref = advect_pack.advect_pack_plain(pq.cpu(), [g.cpu() for g in grids], DT,
                                                    *(None if a is None else a.cpu() for a in sw), k_out, x0 - h, grid)
                two = _two_launches(pq, None, grids, sw, k_out, **window)
            else:
                mw = x_window(marker, 0, x0, xl, h, True)
                name = "correct_pack_xs"
                before = cuda.launch_counts()[name]
                got = advect_pack.correct_pack(pq, dy, grids, mw, k_out, with_counts=True, **window)
                ref = advect_pack.correct_pack_plain(pq.cpu(), dy.cpu(), [g.cpu() for g in grids], mw.cpu(), k_out,
                                                     x0 - h, grid)
                two = _two_launches(pq, dy, grids + [mw], (), k_out, advect=False, **window)
                two = two[:2] + two[3:]
            assert cuda.launch_counts()[name] == before + 1
            for a, b, c in zip(got, ref, two):
                assert torch.equal(a.cpu(), b) and torch.equal(a, c)
            for a, b in zip(got[:2], whole[:2]):
                assert torch.equal(a.narrow(2, h, xl), b.narrow(2, x0, xl))


@pytest.mark.gpu
def test_advect_pack_raises_beyond_64_slots(card):
    t = _table(13, 1)
    posq = torch.cat([t.posq] * 5).to(card)  # 65 slots
    dyn = torch.cat([t.dyn] * 5).to(card)
    vel = [v.to(card) for v in _faces(np.random.default_rng(1), 1.0)]
    with pytest.raises(ValueError, match="64"):
        advect_pack.advect_pack(posq, vel, DT, None, None, 8)
    with pytest.raises(ValueError, match="64"):
        advect_pack.correct_pack(posq[:40], dyn[:40], vel, _marker(np.random.default_rng(1)).to(card), 65)


@contextlib.contextmanager
def _world_size_1(card):
    """The ShardCtx of a one-rank NCCL group on ``card`` (started here,
    unless a default group is already up, and then ended here)."""
    import torch.distributed as dist

    from blub_tpu_torch.parallel import sharded_sm as ss
    from blub_tpu_torch.parallel.world import one_rank_group

    dev = torch.device("cuda", torch.cuda.current_device())
    started = not dist.is_initialized()
    if started:
        one_rank_group(dev)
    try:
        yield ss.ShardCtx.from_group(dev)
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", PCG_CONFIGS, ids=["default", "tight", "capped"])
def test_pcg_slab_solve_at_world_size_1(card, cfg):
    """The mesh's solve (the pass kernels on an x slab with one halo plane
    each side, the all-reduces between them) on a one-rank NCCL group gives
    pcg_solve_kernel's bits: pressure, error and iterations."""
    import torch.nn.functional as F

    from blub_tpu_torch.parallel import sharded_sm as ss

    marker, rhs, p0 = (t.to(card) for t in _pcg_problem(PCG_GRID, 3))
    ref = pcg.solve_pressure(p0, rhs, marker, cfg, DT)
    with _world_size_1(card) as ctx:
        before = cuda.launch_counts()
        got = ss.solve_pressure_sharded(ctx, p0, rhs, F.pad(marker, (0, 0, 0, 0, 1, 1)), cfg, DT)
        after = cuda.launch_counts()
    its = int(got.stats.iterations)
    assert its == int(ref.stats.iterations)
    assert torch.equal(got.pressure, ref.pressure) and torch.equal(got.stats.error, ref.stats.error)
    # setup, init, the z0 pass and its tail, then k1, k2 and the tail per iteration
    assert after["pcg_slab"] - before["pcg_slab"] == 4 + 3 * its and after["pcg"] == before["pcg"]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", PCG_CONFIGS, ids=["default", "tight", "capped"])
def test_pcg_slab_solve_in_a_while_node(card, cfg):
    """The mesh's solve captured as a chain (its setup, its iteration as the
    body of a CUDA WHILE node, its end) on a one-rank NCCL group, launched
    twice, gives the eager slab solve's bits, pressure, error and
    iterations; the node ran the body once per iteration, and the launch
    counts see every run."""
    import torch.nn.functional as F

    from blub_tpu_torch.ops import graph
    from blub_tpu_torch.parallel import sharded_sm as ss

    marker, rhs, p0 = (t.to(card) for t in _pcg_problem(PCG_GRID, 3))
    mx = F.pad(marker, (0, 0, 0, 0, 1, 1))
    with _world_size_1(card) as ctx:
        ref = ss.solve_pressure_sharded(ctx, p0, rhs, mx, cfg, DT)
        out = []
        captures = graph.Captures((cuda, ctx))
        chain = captures.capture(lambda c: out.append(ss.solve_pressure_sharded(ctx, p0, rhs, mx, cfg, DT, c)))
        g = graph.ChainGraph(captures, chain)
        assert chain.loops[0].tallies[0] == {"pcg_slab": 3}
        assert graph.node_counts(chain.loops[0].body) == {"kernel": 3, "memcpy": 0, "memset": 0, "other": 0,
                                                          "total": 3}  # k1, k2 and the tail: no copy
        cuda.count_branches(g, g.runs, [lp.tallies[0] for lp in chain.loops])
        its = int(ref.stats.iterations)
        for launch in range(1, 3):
            before = cuda.launch_counts()["pcg_slab"]
            g.replay()
            torch.cuda.synchronize()
            got = out[0]
            assert int(got.stats.iterations) == its and int(g.runs[0]) == launch * its
            assert torch.equal(got.pressure, ref.pressure) and torch.equal(got.stats.error, ref.stats.error)
            assert cuda.launch_counts()["pcg_slab"] - before == 3 * its  # the loop's runs (the rest is uncounted)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4])
def test_pcg_slab_passes_kernel(card, n):
    """The slab instantiation of the pass kernels on x-windows whose halo
    planes hold the neighbours' planes (zeros beyond the domain) against the
    whole-grid pass kernels, bit for bit: s and r on every plane of the
    window (the passes carry them onto the halo planes), the setup, As, z
    and p on the window's own planes."""
    rng = np.random.default_rng(8)
    marker = _pcg_problem((64, 20, 18), 9)[0].to(card)
    shape = tuple(marker.shape)
    fluid = marker == 1
    z, s_old, r_old, p = (torch.where(fluid, torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(card),
                                      0.0) for _ in range(4))
    diag, dfl = pcg.pass_setup(marker)
    scal = torch.tensor([2.5, 0.0, 0.5, 0.0], device=card)  # [sigma, alpha, beta, err]
    s, As, _ = pcg.k1_pass(z, s_old, scal.clone(), diag, dfl)
    sAs = torch.tensor([3.25], device=card)  # one partial for every pass: the same alpha
    p_new = p.clone()
    r, z_new = pcg.k2_pass(p_new, r_old, s, As, sAs, scal.clone(), diag, dfl)
    xl = shape[0] // n
    for x0 in range(0, shape[0], xl):
        def win(a):
            return x_window(a, 0, x0, xl, 1, False)

        def core(a):
            return a.narrow(0, 1, xl)

        def part():
            return pcg.slab_partials((xl,) + shape[1:], card)

        before = cuda.launch_counts()["pcg_slab"]
        d_w, f_w = pcg.slab_setup(win(marker))
        assert torch.equal(core(d_w), diag.narrow(0, x0, xl)) and torch.equal(core(f_w), dfl.narrow(0, x0, xl))
        s_w, As_w = torch.zeros_like(win(z)), torch.zeros_like(win(z))
        pcg.slab_k1(win(z), (win(s_old), s_w), 0, scal.clone(), win(diag), win(dfl), As_w, part())
        assert torch.equal(s_w, win(s)) and torch.equal(core(As_w), As.narrow(0, x0, xl))
        p_w, r_w, z_w = win(p), torch.zeros_like(s_w), torch.zeros_like(s_w)
        pcg.slab_k2(p_w, (win(r_old), r_w), (win(s), win(s)), 0, win(As), sAs, scal.clone(), win(dfl), z_w, part(),
                    part())
        assert torch.equal(core(p_w), p_new.narrow(0, x0, xl)) and torch.equal(r_w, win(r))
        assert torch.equal(core(z_w), z_new.narrow(0, x0, xl))
        assert cuda.launch_counts()["pcg_slab"] == before + 3


@pytest.mark.gpu
def test_sharded_substep_at_world_size_1(card):
    """One dam-shaped substep of the mesh path on a one-rank NCCL group
    (its halos are local, its solve the pcg.cu pass kernels on the slab with
    their all-reduces) against step_core: the same bits."""
    from blub_tpu_torch.core.seeding import add_fluid_cube
    from blub_tpu_torch.core.types import SimParams
    from blub_tpu_torch.parallel import sharded_sm as ss
    from blub_tpu_torch.sim.step_dense import make_dense_state, step_core

    grid = (128, 64, 64)  # the dam cell
    pos = add_fluid_cube(grid, (1, 1, 1), (64, 32, 63), 10**9)
    params = SimParams(grid_dim=grid, dt=float(DT), gravity_grid=(0.0, -981.0, 0.0), num_particles=pos.shape[0])
    with _world_size_1(card) as ctx:
        state = make_dense_state(params, pos, 14, device=card)
        for _ in range(2):  # from rest, then with velocities
            ref = step_core(params, state, DT)
            before = cuda.launch_counts()
            got = ss.step_dense_sharded(params, ctx, ss.shard_sm_state(ctx, state))
            after = cuda.launch_counts()
            for a, b in ((got.table.posq, ref.table.posq), (got.table.dyn, ref.table.dyn),
                         (got.pressure_vel, ref.pressure_vel), (got.pressure_den, ref.pressure_den),
                         (got.max_speed, ref.max_speed), (got.table.lost, ref.table.lost),
                         (got.stats_vel.iterations, ref.stats_vel.iterations),
                         (got.stats_den.error, ref.stats_den.error)):
                assert torch.equal(a, b)
            assert all(after[k] > before[k] for k in ("advect_pack_xs", "correct_pack_xs", "pcg_slab", "p2g", "gridfix",
                                                      "pack_yz"))
            assert all(after[k] == before[k] for k in ("g2p", "pack", "pcg", "g2p_xs", "pack_xs", "advect_pack",
                                                       "correct_pack"))
            state = ref


def _sdf_soup(seed=21):
    rng = np.random.default_rng(seed)
    return (rng.random((240, 3)) * 1.6 - 0.3).astype(np.float32), rng.integers(0, 240, (300, 3)).astype(np.int32)


def _sdf_slivers(k=150, seed=22):
    """Needles (a corner near another) and caps (a corner near the opposite
    edge's middle), and triangles whose planes nearly contain the x axis
    (slivers in the ray's yz projection)."""
    rng = np.random.default_rng(seed)
    ts = []
    for j in range(k):
        a = rng.random(3)
        d = rng.standard_normal(3)
        b = a + d / np.linalg.norm(d) * rng.uniform(0.05, 1)
        e = 10 ** rng.uniform(-4, -1) * np.linalg.norm(b - a)
        if j % 3 == 0:
            c = a + e * rng.standard_normal(3)
        elif j % 3 == 1:
            c = (a + b) / 2 + e * rng.standard_normal(3)
        else:
            b = a + np.array([1.0, 0, 0]) + rng.standard_normal(3) * 10 ** rng.uniform(-6, -2)
            c = a + np.array([0, *rng.standard_normal(2)]) * rng.uniform(0.1, 1)
        ts.append([a, b, c])
    v = np.array(ts, np.float32).reshape(-1, 3)
    return v, np.arange(len(v), dtype=np.int32).reshape(-1, 3)


def _sdf_meshes():
    """T = 1, 12, one more than the kernel's shared-memory tile twice (257),
    400, icosphere_mesh(4) (5,120 triangles, 160 groups, 5 tiles), a random soup and
    slivers."""
    bv, bf = models.procedural_bunny()
    cv, cf = models.cube_mesh()
    return {1: (bv, bf[:1]), 12: (cv, cf), 257: (bv, bf[:257]), 400: (bv, bf), "ico4": models.icosphere_mesh(4),
            "soup": _sdf_soup(), "slivers": _sdf_slivers()}


def _sdf_same(got, ref):
    """Bit for bit where the plain version is a number; NaN where it is NaN."""
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), ref[~nan].view(torch.int32))


SDF_KERNELS = ("sdf", "sdf_bounds", "sdf_unite", "sdf_keys")


def _sdf_launch(card, v, f, pts, order=None):
    """The kernel's bake (one launch of each of its four kernels) against the
    plain version's on the same CUDA tensors; the bounds, unite and keys
    kernels against their plain versions. With ``order``, the bake kernel
    also takes the points in that order (``prepare``'s otherwise)."""
    args = [torch.from_numpy(np.ascontiguousarray(a, dt)).to(card) for a, dt in
            ((v, np.float32), (f, np.int32), (pts, np.float32))]
    before = cuda.launch_counts()
    got = sdf.mesh_sdf(*args)
    after = cuda.launch_counts()
    assert all(after[k] == before[k] + 1 for k in SDF_KERNELS)
    ref = sdf.mesh_sdf_plain(*args)
    _sdf_same(got, ref)
    tb, key, tt = sdf.bounds(args[0], args[1])
    tb_ref, key_ref, tt_ref = sdf.bounds_plain(args[0], args[1], *torch.aminmax(args[0], dim=0))
    _sdf_same(tb, tb_ref)
    _sdf_same(tt, tt_ref)
    assert torch.equal(key, key_ref)
    perm = torch.argsort(key)
    for a, b in zip(sdf.unite(tb, tt, perm), sdf.unite_plain(tb, tt, perm)):
        _sdf_same(a, b)
    assert torch.equal(sdf.point_keys(args[2]), sdf._morton(args[2], *torch.aminmax(args[2], dim=0)).int())
    if order is not None:
        prepared = sdf.prepare(*args)
        _sdf_same(sdf.run((torch.as_tensor(order, device=card), *prepared[1:]), args[2]), ref)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
@pytest.mark.parametrize("t", [1, 12, 257, 400, "ico4", "soup", "slivers"])
def test_sdf_kernel(card, n, t):
    """The mesh bake against its plain version on the same CUDA tensors, bit
    for bit, at ragged point counts (one block, one short of and one past a
    block of 256) and triangle counts (one tile, one past it), on random
    points and voxel centres around the mesh."""
    v, f = _sdf_meshes()[t]
    rng = np.random.default_rng(n + (t if isinstance(t, int) else len(f)))
    grid = (np.indices((40, 40, 40)).reshape(3, -1).T + 0.5) / 40 * 1.6 - 0.3
    pts = np.concatenate([rng.random((n, 3)) * 1.6 - 0.3, grid])[rng.permutation(n + len(grid))[:n]]
    _sdf_launch(card, v, f, pts)


@pytest.mark.gpu
@pytest.mark.parametrize("spread", ["far", "wild"])
@pytest.mark.parametrize("mesh", [400, "ico4", "slivers"])
def test_sdf_kernel_far_points(card, mesh, spread):
    """Points 10 to 1e5 away, where the face test is rounding noise and
    the margins grow as R^4: bit for bit. ``wild``: points 1e8 to 1e12 away
    (beyond WILD, where no margin holds), one in each warp of ordinary
    points around the mesh, in that order and in ``prepare``'s."""
    v, f = _sdf_meshes()[mesh]
    rng = np.random.default_rng(23)
    d = rng.standard_normal((20_000, 3))
    far = (8, 12) if spread == "wild" else (1, 5)
    pts = d / np.linalg.norm(d, axis=1, keepdims=True) * 10 ** rng.uniform(*far, (20_000, 1)) + 0.5
    if spread == "wild":
        near = rng.random((20_000, 3)) * 1.6 - 0.3
        near[::32] = pts[::32]
        pts = near
    _sdf_launch(card, v, f, pts, np.arange(len(pts)) if spread == "wild" else None)


@pytest.mark.gpu
def test_sdf_kernel_nan_vertex(card):
    """A NaN vertex makes every point's minimum NaN, as in the plain version:
    the whole field is NaN (its triangles are flagged, never skipped)."""
    v, f = models.procedural_bunny()
    v = v.copy()
    v[5] = np.nan
    pts = np.random.default_rng(24).random((30_000, 3)) * 1.6 - 0.3
    assert torch.isnan(_sdf_launch(card, v, f, pts)).all()


@pytest.mark.gpu
def test_sdf_kernel_degenerate_and_nan(card):
    """A mesh with a zero-length edge gives distance 0 at every point (as
    the JAX package's bake does), and a NaN point gives NaN; bit for bit
    with the plain version elsewhere. A mesh without triangles, an index
    outside [0, V) and tensors on two devices raise."""
    v = np.array([[0, 0, 0], [0, 0, 0], [1, 0, 1], [0, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    pts = np.random.default_rng(3).random((1000, 3)).astype(np.float32) * 2 - 0.5
    pts[7] = np.nan
    args = [torch.from_numpy(a).to(card) for a in (v, f, pts)]
    got = sdf.mesh_sdf(*args)
    _sdf_same(got, sdf.mesh_sdf_plain(*args))
    assert torch.isnan(got[7]) and torch.all(got[torch.arange(1000, device=card) != 7] == 0)
    with pytest.raises(ValueError, match="no triangles"):
        sdf.mesh_sdf(args[0], args[1][:0], args[2])
    with pytest.raises(ValueError, match="int32"):
        sdf.mesh_sdf(args[0], args[1].long(), args[2])
    for bad in (4, -1):  # an index past V, or below 0, raises before the launch
        with pytest.raises(ValueError, match="outside"):
            sdf.mesh_sdf(args[0], torch.where(args[1] == 3, bad, args[1]), args[2])
    with pytest.raises(ValueError, match="on cuda"):
        sdf.mesh_sdf(args[0], args[1], args[2].cpu())
