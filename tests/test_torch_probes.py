"""The port's probes (blub_tpu_torch/probes) on the CPU: their plain versions
against the TPU scripts' own expressions and the JAX package's XLA functions
(scripts/tpu_smoke_relops.py, tpu_bench_yz_floor.py, tpu_bench_rebin.py,
tpu_bench_pcg_kernels.py), at 16x8x8. Each JAX oracle is jitted once per
module; nothing runs Pallas."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blub_tpu.core.seeding import add_fluid_cube
from blub_tpu.sim import pressure as jp
from blub_tpu.sim import slot_major as jsm
from blub_tpu.sim import table as jtable
from blub_tpu_torch import convert
from blub_tpu_torch.ops import pcg, rebin
from blub_tpu_torch.probes import copy_bw, pcg_passes, rebin_sweep, relops, yz_floor
from blub_tpu_torch.sim.slot_major import valid_mask

torch.set_num_threads(1)

G = (16, 8, 8)
K = 8

_from_table, _to_table = jax.jit(jsm.from_table), jax.jit(jsm.to_table)


# ---------------------------------------------------------------------------
# relops


@jax.jit
def _jnp_relops(pos, cell):
    """The op sequence of tpu_smoke_relops.py::kern, in jnp."""
    ri = jnp.round((pos - cell - 1.0) * 8192.0).astype(jnp.int32)
    packed = (ri << 16) | (ri & 0xFFFF)
    pf = jnp.where(pos > -1e9, jax.lax.bitcast_convert_type(packed, jnp.float32), 0.0)
    b = jax.lax.bitcast_convert_type(pf, jnp.int32)
    return (b >> 16).astype(jnp.float32), cell + 1.0 + ((b << 16) >> 16).astype(jnp.float32) * (2.0 ** -13)


@pytest.mark.parametrize("case", ["seed0", "tie", "edges"])
def test_relops_plain_matches_script_and_jnp(case):
    pos, cell = relops.cases()[case]
    rx, rt = relops.relops(torch.from_numpy(pos), torch.from_numpy(cell))
    # the script's expectations, as it wrote them
    want_r = np.round((pos - cell - 1.0).astype(np.float32) * 8192.0)
    want_rt = (cell + 1.0 + want_r * np.float32(2.0 ** -13)).astype(np.float32)
    np.testing.assert_array_equal(rx.numpy(), want_r)
    np.testing.assert_array_equal(rt.numpy(), want_rt)
    jx, jt = (np.asarray(a) for a in _jnp_relops(jnp.asarray(pos), jnp.asarray(cell)))
    np.testing.assert_array_equal(rx.numpy().view(np.int32), jx.view(np.int32))
    np.testing.assert_array_equal(rt.numpy().view(np.int32), jt.view(np.int32))
    if case == "tie":  # pos = 1 + 0.5 quantum rounds half to even: 0
        assert not rx.numpy().any()
    if case == "edges":  # rows: +1.5, -1.5, -0.5, +2.5 quanta, +3.5, -3.5 cells, +0.5 quantum, 0
        np.testing.assert_array_equal(rx.numpy()[:, 0], [2, -2, 0, 2, 28672, -28672, 0, 0])


# ---------------------------------------------------------------------------
# the seeded table and the yz floor variants


def _jax_seeded(k, pad=0):
    pos = add_fluid_cube(G, (1, 1, 1), (G[0] // 2, G[1] // 2, G[2] - 1), 10**9)
    sm = _from_table(jtable.from_positions(pos, G, k))
    return convert.table_from_jax(np.asarray(sm.posq), np.asarray(sm.dyn), np.asarray(sm.lost), G, device="cpu")


def test_seeded_table_matches_jax():
    posq, dyn, lost = yz_floor.seeded_table(G, K, pad=2, device="cpu")
    t = _jax_seeded(K)
    assert posq.shape[0] == K + 2 and not posq[K:].any() and not dyn[K:].any()
    assert torch.equal(posq[:K], t.posq) and lost.item() == t.lost.item()
    v = valid_mask(posq)[:, None]
    assert not dyn.masked_select(~v).any() and dyn.masked_select(v).any()


def _garbage(posq, dyn, seed):
    """Random words in the invalid slots (valid bit clear): gating shows."""
    rng = np.random.default_rng(seed)
    v = valid_mask(posq)[:, None]

    def noise(a):
        return torch.from_numpy(rng.integers(-2**31, 2**31, a.shape, dtype=np.int64).astype(np.int32))

    gp = noise(posq)
    gp[:, 1] &= -2
    return torch.where(v, posq, gp), torch.where(v, dyn, noise(dyn))


def _np_window_read(pq, dy, s, gated, tile_y=4):
    """Per (x, 4-row y tile): the wrapping int32 sum of the words a y-stage
    pack's window reads (numpy, loop over y rows and slots)."""
    pq, dy = pq.astype(np.int64), dy.astype(np.int64)
    k, _, x, y, z = pq.shape
    cell = np.zeros((x, y, z), np.int64)
    for yy in range(y):
        for q in range(k):
            v = pq[q, 1, :, yy]
            ok = (v & 1) == 1 if gated else np.ones_like(v, bool)
            cell[:, yy] += v + np.where(ok, pq[q, 0, :, yy] + dy[q, :, :, yy].sum(0), 0)
            for o in [o for o in range(-s, s + 1) if o and 0 <= yy + o < y]:
                w = pq[q, 1, :, yy + o]
                okw = (w & 1) == 1 if gated else np.ones_like(w, bool)
                cell[:, yy] += w + np.where(okw, pq[q, 0, :, yy + o], 0)
    tiles = cell.reshape(x, y // tile_y, tile_y * z).sum(-1) & 0xFFFFFFFF
    return np.where(tiles >= 2**31, tiles - 2**32, tiles).astype(np.int32)


# (grid, capacity, empty slots on top, s): the module's 16x8x8 table, and Y = 12
# at k_in 1 and 20 (the shapes of the card tests' read cases; s = 13 reaches
# past the grid's Y)
_PLAIN_SHAPES = [((G, K, 2, 2), ""), (((16, 12, 8), 1, 0, 2), "y12-k1-"), (((16, 12, 8), 18, 2, 2), "y12-k20-"),
                 (((16, 12, 8), 18, 2, 13), "y12-k20-s13-")]


@pytest.mark.parametrize("shape,garbage", [pytest.param(sh, g, id=f"{pre}{g}") for sh, pre in _PLAIN_SHAPES
                                           for g in (False, True)])
def test_yz_floor_plain_variants_match_numpy(shape, garbage):
    grid, k, pad, s = shape
    posq, dyn, _ = yz_floor.seeded_table(grid, k, pad=pad, device="cpu")
    posq = torch.cat([rebin_sweep.jiggle(posq[:k], 1, 1.2), posq[k:]])  # off the seeding lattice
    if garbage:
        posq, dyn = _garbage(posq, dyn, 1)
    pq, dy = posq.numpy(), dyn.numpy()
    k_out = k
    (got,) = yz_floor.run("read", posq, dyn, s, k_out)
    np.testing.assert_array_equal(got.numpy(), _np_window_read(pq, dy, s, gated=True))
    want = _np_window_read(pq, dy, s, gated=False)
    assert garbage == (not np.array_equal(want, got.numpy()))  # gating only shows on garbage
    for v in ("zeros", "zeros_ungated"):
        p, d = yz_floor.run(v, posq, dyn, s, k_out)
        assert p.shape == (k_out, 2) + grid and d.shape == (k_out, 6) + grid and not p.any() and not d.any()
    p, d = yz_floor.run("copy", posq, dyn, s, k_out)
    ok = (pq[:k_out, 1:2] & 1) == 1
    np.testing.assert_array_equal(p.numpy(), np.where(ok, pq[:k_out], 0))
    np.testing.assert_array_equal(d.numpy(), np.where(ok, dy[:k_out], 0))


@pytest.mark.parametrize("shape,ok", [
    pytest.param((14, 128, 64, 64), True, id="dam"),
    pytest.param((15, 256, 128, 128), True, id="highres"),  # K=14 + its slack
    pytest.param((8, 16, 32, 8), True, id="small"),
    pytest.param((3, 5, 96, 4), True, id="odd-x-y96-z4"),  # three 32-row tiles, one 16-byte word a row
    pytest.param((14, 16, 8, 8), False, id="y8"),  # Y not a whole number of 32-row tiles
    pytest.param((14, 16, 64, 6), False, id="z6"),  # Z not a whole number of 16-byte words
])
def test_copy_check_shapes(shape, ok):
    """copy_bw.check_shapes takes what csrc/copy.cu takes and raises a
    ValueError naming the limit otherwise (meta tensors: no memory)."""
    k, x, y, z = shape
    posq = torch.empty((k, 2, x, y, z), dtype=torch.int32, device="meta")
    dyn = torch.empty((k, 6, x, y, z), dtype=torch.int32, device="meta")
    if ok:
        copy_bw.check_shapes(posq, dyn)
    else:
        with pytest.raises(ValueError, match=r"Y % 32 == 0, Z % 4 == 0"):
            copy_bw.check_shapes(posq, dyn)
    with pytest.raises(ValueError, match=r"dyn \[K, 6, X, Y, Z\]"):
        copy_bw.check_shapes(posq, dyn[:, :5])


def test_yz_floor_copy_is_the_tpu_copy_and_full_is_identity_at_amp0():
    """copy writes what the TPU copy mode wrote (input slot q for q < k_out,
    of the JAX table); full on the unmoved table gives the table back."""
    posq, dyn, _ = yz_floor.seeded_table(G, K, pad=2, device="cpu")
    t = _jax_seeded(K)
    p, d = yz_floor.run("copy", posq, dyn, 2, K)
    assert torch.equal(p, t.posq) and torch.equal(d, dyn[:K])
    p, d = yz_floor.run("full", posq, dyn, 2, K)
    assert torch.equal(p, posq[:K]) and torch.equal(d, dyn[:K])


# ---------------------------------------------------------------------------
# jiggle and the rebin sweep


@jax.jit
def _jax_jiggle(posq, i, amp):
    """tpu_bench_rebin.py::jiggle, restated on blub_tpu.sim.slot_major."""
    rx, ry, rz, vbit = jsm.unpack_posq(posq[:, jsm.CH_XY], posq[:, jsm.CH_ZV])
    validb = vbit == 1
    shape = vbit.shape
    rels = []
    for a, r in enumerate((rx, ry, rz)):
        cell = jax.lax.broadcasted_iota(jnp.float32, shape, 1 + a)
        p = jsm.rel_to_pos(r, cell)
        d = amp * jnp.sin(p * 17.17 + 3.7 * p * p + i.astype(jnp.float32))
        pq = jsm.quantize_pos(jnp.clip(p + d, 1.001, G[a] - 1.001))
        rels.append(jnp.where(validb, jsm.pos_to_rel(pq, cell), 0))
    ch0, ch1 = jsm.pack_posq(rels[0], rels[1], rels[2], vbit)
    return jnp.stack([ch0, ch1], axis=1)


@pytest.mark.parametrize("i,amp", [(3, 1.9), (0, 0.3)])
def test_jiggle_matches_jax(i, amp):
    """Valid bits exact; rels within one quantum (sin may differ by an ulp)."""
    t = _jax_seeded(K)
    pq = convert.table_to_jax(t)["posq"]
    want = np.asarray(_jax_jiggle(jnp.asarray(pq), jnp.int32(i), jnp.float32(amp)))[..., : G[2]].view(np.int32)
    got = rebin_sweep.jiggle(t.posq, i, amp).numpy()
    np.testing.assert_array_equal(got[:, 1] & 1, want[:, 1] & 1)
    for a, b in zip(_rels(got), _rels(want)):
        assert np.abs(a - b).max() <= 1


def _rels(pq):
    b0, b1 = pq[:, 0].astype(np.int64), pq[:, 1].astype(np.int64)
    return b0 >> 16, ((b0 & 0xFFFF) ^ 0x8000) - 0x8000, b1 >> 16


def test_rebin_chain_invariants():
    """The sweep's invariants on the plain path: amp 0 gives the table back
    bit for bit once it lies in the jiggle's clip box (the 32x16x16 seeding
    has particles below 1.001); count + lost == n0 at amp 1.9 (overflow
    included)."""
    posq, dyn, lost = yz_floor.seeded_table((32, 16, 16), K, device="cpu")
    assert not torch.equal(rebin_sweep.jiggle(posq, 0, 0.0), posq)
    posq = rebin_sweep.jiggle(posq, 0, 0.0)
    n0 = valid_mask(posq).sum().item() + lost.item()
    p, d, l0 = rebin_sweep.chain(posq, dyn, lost, 0.0, 2, 4, n=2)
    assert torch.equal(p, posq) and torch.equal(d, dyn) and l0.item() == lost.item()
    p, d, l1 = rebin_sweep.chain(posq, dyn, lost, 1.9, 1, 2, n=2)
    assert valid_mask(p).sum().item() + l1.item() == n0 and l1.item() > lost.item()


def _jax_moved_table(k, seed, amp, per_cell):
    pos = add_fluid_cube(G, (1, 1, 1), (9, 7, 7), 10**9)
    tab = jtable.from_positions(pos, G, k)
    rng = np.random.default_rng(seed)
    valid = np.asarray(tab.valid).copy()
    valid[..., per_cell:] = False
    p = np.asarray(tab.pos) + rng.uniform(-amp, amp, np.asarray(tab.pos).shape).astype(np.float32)
    p = np.clip(p, 1.001, np.array(G, np.float32) - 1.001)
    p = (np.round(p * np.float32(8192.0)) * np.float32(2.0 ** -13)).astype(np.float32) * valid[..., None]
    tab = dataclasses.replace(
        tab, pos=jnp.asarray(p), valid=jnp.asarray(valid),
        vel=jnp.asarray(rng.standard_normal(valid.shape + (3,)).astype(np.float32) * valid[..., None]),
        affine=jnp.asarray(rng.standard_normal(valid.shape + (3, 3)).astype(np.float32) * valid[..., None, None]),
    )
    return _from_table(tab)


def _cells(tab):
    pos, vel, aff, valid = (np.asarray(a) for a in (tab.pos, tab.vel, tab.affine, tab.valid))
    rows = np.concatenate([pos, vel, aff.reshape(aff.shape[:4] + (9,))], axis=-1)
    out = {}
    for cell in np.ndindex(valid.shape[:3]):
        r = rows[cell][valid[cell]]
        out[cell] = r[np.lexsort(r.T[::-1])] if len(r) else r
    return out


_jax_rebin = jax.jit(jtable.rebin, static_argnums=(1, 2))


@pytest.mark.parametrize("s,slack,amp", [(2, 4, 1.9), (1, 2, 0.9)])
def test_rebin_slot_major_multisets_match_table_rebin(s, slack, amp):
    k = 12
    sm = _jax_moved_table(k, 20 + s, amp, per_cell=3)
    ref = _jax_rebin(_to_table(sm), s, slack)
    t = convert.table_from_jax(np.asarray(sm.posq), np.asarray(sm.dyn), np.asarray(sm.lost), G, device="cpu")
    posq, dyn, lost = rebin.rebin_slot_major(t.posq, t.dyn, s, slack, t.lost)
    assert lost.item() == int(ref.lost) == 0
    out = convert.table_to_jax(dataclasses.replace(t, posq=posq, dyn=dyn, lost=lost))
    got = _to_table(jsm.SlotMajorTable(posq=jnp.asarray(out["posq"]), dyn=jnp.asarray(out["dyn"]),
                                          lost=jnp.int32(out["lost"]), grid_dim=G))
    a, b = _cells(got), _cells(ref)
    for cell in a:
        np.testing.assert_array_equal(a[cell], b[cell])
    assert sum(len(r) for r in a.values()) == valid_mask(t.posq).sum().item()


# ---------------------------------------------------------------------------
# the PCG passes


@jax.jit
def _jax_passes(marker, z, s_old, p, r_old, s_in, As_in, scal):
    """k1 (on z, s_old) and k2 (on p, r_old, s_in, As_in, with k1's alpha)
    on the JAX package's apply_A and precondition."""
    fluid = jp.fluid_mask(marker)
    diag = jp.diag_coefficients(marker)
    nbr = jp.neighbor_fluid_masks(marker)
    sigma, beta = scal[0], scal[2]
    s = z + beta * s_old
    As = jp.apply_A(s, fluid, diag, *nbr)
    alpha = jp._guarded_div(sigma, jnp.sum(s * As))
    r = r_old - alpha * As_in
    z2 = jp.precondition(r, fluid, diag, *nbr)
    sigma2 = jnp.sum(z2 * r)
    return (diag, s, As, p + alpha * s_in, r, z2, alpha, sigma2, jp._guarded_div(sigma2, sigma),
            jnp.max(jnp.abs(r)))


def test_pcg_passes_plain_match_jax():
    """pass_setup, k1_pass and k2_pass (plain; k2 takes alpha from k1's
    partial of s.As) against the JAX package's solve pieces: grids
    f32-close, scalars within 1e-5."""
    inp = pcg_passes.inputs(G, device="cpu")
    marker = pcg_passes.probe_marker(G)
    fluid = marker == 1
    rng = np.random.default_rng(1)
    z, s_old, s_in, As_in = (np.where(fluid, rng.standard_normal(G), 0).astype(np.float32) for _ in range(4))
    p = rng.standard_normal(G).astype(np.float32)
    scal = np.float32([2.5, 0.03, 0.4, 0.0])
    want = [np.asarray(a) for a in _jax_passes(jnp.asarray(marker.astype(np.int32)), z, s_old, p,
                                                 inp["r0"].numpy(), s_in, As_in, scal)]
    diag, dfl = inp["diag"], inp["dfl"]
    np.testing.assert_array_equal(diag.numpy(), want[0])
    np.testing.assert_array_equal((dfl > 0).numpy(), fluid)
    t = {k: torch.from_numpy(v) for k, v in dict(z=z, s_old=s_old, s_in=s_in, As_in=As_in, p=p).items()}
    sc = torch.from_numpy(scal.copy())
    s, As, part = pcg.k1_pass(t["z"], t["s_old"], sc, diag, dfl)
    r, z2 = pcg.k2_pass(t["p"], inp["r0"], t["s_in"], t["As_in"], part, sc, diag, dfl)
    for got, ref in zip((s, As, t["p"], r, z2), want[1:6]):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    for got, ref in zip((sc[1], sc[0], sc[2], sc[3]), want[6:]):
        np.testing.assert_allclose(got.item(), ref, rtol=1e-5)


def test_pcg_passes_iterate_to_the_jax_solve():
    """pass_setup, then k2_pass without partials (alpha = 0: z0, sigma0) and
    k1_pass + k2_pass six times (the order of the persistent solve, here on their plain
    versions) against the JAX package's solve of six iterations on the
    probe marker from p0 = 0: pressures within 1e-4 of their scale, max|r|
    within 1e-3."""
    from blub_tpu.core.config import SolverConfig as JaxSolverConfig

    its = 6
    inp = pcg_passes.inputs(G, device="cpu")
    rhs = inp["r0"] * 30.0
    marker = pcg_passes.probe_marker(G)
    jcfg = JaxSolverConfig(error_tolerance=0.0, max_num_iterations=its)

    @jax.jit
    def solve(r, m):
        res = jp.solve_pressure(jnp.zeros(G, jnp.float32), r, m, jcfg, float(pcg_passes.DT))
        return res.pressure, res.stats.iterations, res.stats.error

    want, jits, jerr = solve(jnp.asarray(rhs.numpy()), jnp.asarray(marker))
    assert int(jits) == its
    diag, dfl = inp["diag"], inp["dfl"]
    p, r, s = torch.zeros(G), torch.where(dfl > 0.0, rhs, 0.0), torch.zeros(G)
    scal = torch.zeros(4)
    r, z = pcg.k2_pass(p, r, s, s, None, scal, diag, dfl)
    for _ in range(its):
        s, As, part = pcg.k1_pass(z, s, scal, diag, dfl)
        r, z = pcg.k2_pass(p, r, s, As, part, scal, diag, dfl)
    want = np.asarray(want)
    np.testing.assert_allclose(p.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert scal[pcg.ERR].item() * float(pcg_passes.DT) == pytest.approx(float(jerr), rel=1e-3, abs=1e-6)
