"""The port's ragged-grid path on the CPU: ECP and the HEALPix family,
the ring-bucket phase engine and the plans on them, against the JAX
reference.

Host geometry (grids, FFT buckets, bucket layouts, bin maps, rotation
tables) must be array-equal.  The float64 engines and plans agree within
1e-12 relative: the same float64 arithmetic, with sums taken in another
order (the port's alias fold sums fixed gathers densely, the reference
scatters with ``.at[].add``).  Inputs are drawn with numpy from fixed
seeds and handed to both packages.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import grids as rgrids
from repro.core import phase as rphase

import repro_torch
from repro_torch import interop
from repro_torch.core import grids, phase, sht, transform
from repro_torch.kernels import fused_cuda, ops
from repro_torch.kernels import legendre_cuda as lc

GRID_FIELDS = ("cos_theta", "sin_theta", "weights", "n_phi", "phi0")
F64_TOL = 1e-12


def rel(got, want) -> float:
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def alm_np(shape, l_max, m_max, spin=0, seed=0):
    """Seeded complex alm of ``shape`` ((M, L, K) or (2, M, L, K)), zero
    below l0 = max(m, spin), real at m = 0."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    keep = np.arange(l_max + 1)[None, :] >= np.maximum(
        np.arange(m_max + 1), spin)[:, None]
    a = a * keep[..., None]
    a[..., 0, :, :] = a[..., 0, :, :].real
    return a


def grid_pair(kind, size):
    kw = dict(nside=size) if kind.startswith("healpix") else dict(l_max=size)
    return grids.make_grid(kind, **kw), rgrids.make_grid(kind, **kw)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,size", [
    ("healpix", 1), ("healpix", 2), ("healpix", 4), ("healpix", 8),
    ("healpix", 32), ("healpix_ring", 1), ("healpix_ring", 2),
    ("healpix_ring", 4), ("healpix_ring", 8), ("healpix_ring", 32),
    ("ecp", 1), ("ecp", 8), ("ecp", 31), ("ecp", 64)])
def test_grids_array_equal(kind, size):
    g, rg = grid_pair(kind, size)
    for f in GRID_FIELDS:
        np.testing.assert_array_equal(getattr(g, f), getattr(rg, f))
    assert (g.name, g.uniform, g.nside, g.n_rings, g.max_n_phi,
            g.equator_symmetric) == (rg.name, rg.uniform, rg.nside,
                                     rg.n_rings, rg.max_n_phi,
                                     rg.equator_symmetric)


def test_ecp_custom_sizes_array_equal():
    g = grids.ecp_grid(20, n_rings=30, n_phi=64)
    rg = rgrids.ecp_grid(20, n_rings=30, n_phi=64)
    for f in GRID_FIELDS:
        np.testing.assert_array_equal(getattr(g, f), getattr(rg, f))


@pytest.mark.parametrize("nside", [2, 4, 8, 32])
@pytest.mark.parametrize("max_stretch", [None, 1, 1.5, 2])
def test_ring_buckets_and_layout_array_equal(nside, max_stretch):
    g, rg = grid_pair("healpix", nside)
    got, want = g.fft_buckets(max_stretch), rg.fft_buckets(max_stretch)
    assert [b.length for b in got] == [b.length for b in want]
    for b, rb in zip(got, want):
        np.testing.assert_array_equal(b.rings, rb.rings)
    lo = grids.BucketLayout.from_buckets(got)
    rlo = rgrids.BucketLayout.from_buckets(want)
    assert lo.lengths == rlo.lengths and lo.n_buckets == rlo.n_buckets
    np.testing.assert_array_equal(lo.fft_lengths, rlo.fft_lengths)
    assert lo.padded_frac(g.n_phi) == rlo.padded_frac(rg.n_phi)
    np.testing.assert_array_equal(g.bucket_lengths(max_stretch),
                                  rg.bucket_lengths(max_stretch))
    np.testing.assert_array_equal(g.bucket_permutation(max_stretch),
                                  rg.bucket_permutation(max_stretch))


@pytest.mark.parametrize("nside", [4, 8, 16])
def test_ring_buckets_invariants(nside):
    """Port of the reference's bucket invariants: a partition of the rings,
    exact divisor embedding, real ring lengths, fewer buckets than
    lengths; max_stretch=1 merges nothing and pads nothing."""
    g = grids.make_grid("healpix", nside=nside)
    buckets = g.fft_buckets()
    seen = np.concatenate([b.rings for b in buckets])
    assert sorted(seen.tolist()) == list(range(g.n_rings))
    for b in buckets:
        assert np.all(b.length % g.n_phi[b.rings] == 0)
        assert b.length in g.n_phi
    assert len(buckets) < len(np.unique(g.n_phi))
    exact = grids.BucketLayout.from_buckets(g.fft_buckets(max_stretch=1))
    assert exact.n_buckets == len(np.unique(g.n_phi))
    assert exact.padded_frac(g.n_phi) == 0.0
    perm = g.bucket_permutation()
    lens = g.bucket_lengths()[perm]
    assert int(np.sum(lens[1:] != lens[:-1])) == len(buckets) - 1


def test_uniform_grid_single_bucket():
    for g in (grids.make_grid("gl", l_max=16),
              grids.make_grid("healpix_ring", nside=4)):
        (b,) = g.fft_buckets()
        assert b.length == g.max_n_phi and b.n_rings == g.n_rings


@pytest.mark.parametrize("nside,m_max", [(2, 4), (4, 8), (8, 16), (8, 3),
                                         (4, 40)])
def test_bucket_bin_maps_and_tables_array_equal(nside, m_max):
    g, rg = grid_pair("healpix", nside)
    m = np.arange(m_max + 1)
    blen = g.bucket_lengths()
    for got, want in zip(phase.bucket_bin_maps(m, g.n_phi, blen),
                         rphase.bucket_bin_maps(m, rg.n_phi, blen)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    mp = np.concatenate([m, [-1, -1]])
    for d in ("synth", "anal"):
        np.testing.assert_array_equal(
            phase.bucket_rotation_tables(mp, g.phi0, d),
            rphase.bucket_rotation_tables(mp, rg.phi0, d))
    ph = phase.make_phase(g, m_max)
    rph = rphase.make_phase(rg, m_max, "float64")
    np.testing.assert_array_equal(ph.index.pos, rph._pos)
    np.testing.assert_array_equal(ph.index.neg, rph._neg)
    assert ph.describe() == rph.describe()
    np.testing.assert_array_equal(ph.fft_lengths, rph.fft_lengths)


# ---------------------------------------------------------------------------
# the bucket engine against the reference and the direct DFT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nside", [2, 8])
@pytest.mark.parametrize("m_max", [None, 5])
def test_bucket_phase_matches_reference(nside, m_max):
    g, rg = grid_pair("healpix", nside)
    m_max = 2 * nside if m_max is None else m_max
    ph = phase.make_phase(g, m_max)
    rph = rphase.make_phase(rg, m_max, "float64")
    assert ph.kind == rph.kind == "bucket"
    rng = np.random.default_rng(nside)
    d = (rng.normal(size=(m_max + 1, g.n_rings, 3))
         + 1j * rng.normal(size=(m_max + 1, g.n_rings, 3)))
    assert rel(ph.synth(torch.as_tensor(d)),
               rph.synth(jnp.asarray(d))) < F64_TOL
    maps = rng.normal(size=(g.n_rings, g.max_n_phi, 3))
    assert rel(ph.anal(torch.as_tensor(maps)),
               rph.anal(jnp.asarray(maps))) < F64_TOL


def test_uniform_phase_with_ring_offsets_matches_reference():
    """healpix_ring is the first uniform grid with phi0 != 0."""
    g, rg = grid_pair("healpix_ring", 4)
    assert np.any(g.phi0 != 0)
    ph, rph = phase.make_phase(g, 8), rphase.make_phase(rg, 8, "float64")
    rng = np.random.default_rng(3)
    d = (rng.normal(size=(9, g.n_rings, 2))
         + 1j * rng.normal(size=(9, g.n_rings, 2)))
    assert rel(ph.synth(torch.as_tensor(d)),
               rph.synth(jnp.asarray(d))) < F64_TOL
    maps = rng.normal(size=(g.n_rings, g.max_n_phi, 2))
    assert rel(ph.anal(torch.as_tensor(maps)),
               rph.anal(jnp.asarray(maps))) < F64_TOL


def _dft_synth(g, dp):
    """Brute-force per-ring DFT synthesis (phi0 already in dp)."""
    M, R, K = dp.shape
    out = np.zeros((R, g.max_n_phi, K))
    for r in range(R):
        n = int(g.n_phi[r])
        j = np.arange(n)
        for m in range(M):
            w = np.exp(2j * np.pi * m * j / n)[:, None]
            out[r, :n] += (dp[m, r][None, :] * w).real
            if m > 0:
                out[r, :n] += (np.conj(dp[m, r])[None, :] / w).real
    return out


def test_bucket_synth_matches_direct_dft():
    g = grids.make_grid("healpix", nside=4)
    m_max = 8
    rng = np.random.default_rng(0)
    delta = (rng.normal(size=(m_max + 1, g.n_rings, 2))
             + 1j * rng.normal(size=(m_max + 1, g.n_rings, 2)))
    ph = np.exp(1j * np.arange(m_max + 1)[:, None] * g.phi0[None, :])
    want = _dft_synth(g, delta * ph[..., None])
    got = phase.make_phase(g, m_max).synth(torch.as_tensor(delta)).numpy()
    assert np.max(np.abs(got - want)) < 1e-12


def test_bucket_anal_matches_direct_dft():
    g = grids.make_grid("healpix", nside=4)
    m_max = 8
    rng = np.random.default_rng(0)
    maps = np.zeros((g.n_rings, g.max_n_phi, 2))
    for r in range(g.n_rings):
        maps[r, :int(g.n_phi[r])] = rng.normal(size=(int(g.n_phi[r]), 2))
    got = phase.make_phase(g, m_max).anal(torch.as_tensor(maps)).numpy()
    for r in (0, 3, g.n_rings // 2, g.n_rings - 1):
        n = int(g.n_phi[r])
        j = np.arange(n)
        for m in (0, 1, 5, m_max):
            want = (maps[r, :n]
                    * np.exp(-2j * np.pi * m * j / n)[:, None]).sum(axis=0)
            want *= np.exp(-1j * m * g.phi0[r]) * g.weights[r]
            assert np.max(np.abs(got[m, r] - want)) < 1e-12, (r, m)


def test_anal_masks_padding_garbage():
    """Samples past a ring's n_phi must not leak into the analysis."""
    g = grids.make_grid("healpix", nside=4)
    t = sht.SHT(g, l_max=8, m_max=8)
    alm = torch.as_tensor(alm_np((9, 9, 1), 8, 8))
    maps = t.alm2map(alm)
    dirty = maps.clone()
    for r in range(g.n_rings):
        dirty[r, int(g.n_phi[r]):] = 99.0
    assert float((t.map2alm(maps) - t.map2alm(dirty)).abs().max()) < 1e-12
    # and the synthesis writes exact zeros there
    for r in range(g.n_rings):
        assert bool((maps[r, int(g.n_phi[r]):] == 0).all())


def test_uniform_phase_engine_matches_ragged_on_degenerate_grid():
    """A ragged grid whose rings all share n_phi reproduces the uniform
    engine (the bucket engine is a strict generalisation)."""
    gu = grids.make_grid("healpix_ring", nside=4)
    gr = grids.RingGrid(name="healpix_ring_ragged", cos_theta=gu.cos_theta,
                        sin_theta=gu.sin_theta, weights=gu.weights,
                        n_phi=gu.n_phi, phi0=gu.phi0, uniform=False,
                        nside=gu.nside)
    pu, pr = phase.make_phase(gu, 8), phase.make_phase(gr, 8)
    assert pu.kind == "uniform" and pr.kind == "bucket"
    rng = np.random.default_rng(1)
    delta = torch.as_tensor(rng.normal(size=(9, gu.n_rings, 2))
                            + 1j * rng.normal(size=(9, gu.n_rings, 2)))
    su, sr = pu.synth(delta), pr.synth(delta)
    assert float((su - sr).abs().max()) < 1e-12
    assert float((pu.anal(su) - pr.anal(su)).abs().max()) < 1e-12


def test_bucket_fold_is_an_order_fixed_gather():
    """The alias fold's sums are gathers over plan-time index maps: the
    same bits on every call, and the same values as an index_add_ scatter
    of the +m and conjugate -m terms through the bin maps."""
    g = grids.make_grid("healpix", nside=8)
    m_max = 40                        # many m alias on every ring
    ph = phase.make_phase(g, m_max)
    rng = np.random.default_rng(2)
    vals = torch.as_tensor(rng.normal(size=(m_max + 1, g.n_rings, 2))
                           + 1j * rng.normal(size=(m_max + 1, g.n_rings, 2)))
    a = phase.bucket_scatter(vals, ph.index)
    assert torch.equal(a, phase.bucket_scatter(vals, ph.index))
    # the reference's semantics: scatter-add per bucket, then one ifft each
    ix = ph.index
    want = torch.zeros_like(a)
    m = torch.arange(m_max + 1)[:, None, None]
    for B, sl in zip(ix.layout.lengths, ix.layout.slots):
        sl = torch.as_tensor(sl)
        S = torch.zeros(len(sl), B, 2, dtype=vals.dtype)
        for i, r in enumerate(sl.tolist()):
            S[i].index_add_(0, torch.as_tensor(ix.pos[:, r]).long(),
                            vals[:, r])
            S[i].index_add_(0, torch.as_tensor(ix.neg[:, r]).long(),
                            torch.where(m[:, 0] > 0, vals[:, r].conj(), 0))
        s = torch.fft.ifft(S, dim=1).real * B
        for i, r in enumerate(sl.tolist()):
            n = int(g.n_phi[r])
            want[r, :n] = s[i, :n]
    assert float((a - want).abs().max()) < 1e-12 * float(want.abs().max())


# ---------------------------------------------------------------------------
# float64 plans on the new grids against the reference's jnp plans
# ---------------------------------------------------------------------------

PLAN_GRIDS = [("healpix", dict(nside=4)), ("healpix", dict(nside=2)),
              ("healpix_ring", dict(nside=4)), ("ecp", dict(l_max=10))]


@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("kind,kw", PLAN_GRIDS)
def test_float64_plan_matches_reference(kind, kw, spin):
    p = repro_torch.make_plan(kind, **kw, K=2, spin=spin, device="cpu")
    rp = repro.make_plan(kind, **kw, K=2, dtype="float64", spin=spin,
                         mode="jnp")
    assert (p.l_max, p.m_max, p.grid.n_rings) == (rp.l_max, rp.m_max,
                                                  rp.grid.n_rings)
    a = alm_np(p._alm_shape, p.l_max, p.m_max, spin, seed=spin)
    maps = p.alm2map(torch.as_tensor(a))
    want = np.asarray(rp.alm2map(jnp.asarray(a)))
    assert rel(maps, want) < F64_TOL
    for iters in (0, 1):
        got = p.map2alm(torch.as_tensor(want), iters=iters)
        assert rel(got, rp.map2alm(jnp.asarray(want), iters=iters)) < F64_TOL


def test_healpix_plan_defaults_and_memoisation():
    repro_torch.clear_plan_cache()
    p = repro_torch.make_plan("healpix", nside=4, device="cpu")
    assert (p.l_max, p.m_max, p.grid.name) == (8, 8, "healpix")
    assert repro_torch.make_plan("healpix", nside=4, device="cpu") is p
    pr = repro_torch.make_plan("healpix_ring", nside=4, device="cpu")
    assert pr is not p and pr.grid.uniform and not p.grid.uniform
    assert pr._signature_key != p._signature_key
    assert repro_torch.make_plan("healpix", nside=8, device="cpu") is not p
    with pytest.raises(ValueError, match="nside"):
        repro_torch.make_plan("healpix", device="cpu")
    with pytest.raises(ValueError, match="l_max"):
        repro_torch.make_plan("ecp", device="cpu")


def test_iterations_refine_the_healpix_analysis():
    """Jacobi passes shrink the round-trip error of HEALPix's approximate
    quadrature (float64, band-limited input)."""
    p = repro_torch.make_plan("healpix", nside=8, device="cpu")
    a = torch.as_tensor(alm_np(p._alm_shape, p.l_max, p.m_max, seed=4))
    maps = p.alm2map(a)
    errs = [float((p.map2alm(maps, iters=i) - a).abs().max())
            for i in (0, 1, 3)]
    assert errs[0] > errs[1] > errs[2]


@pytest.mark.parametrize("kind,kw", [("gl", dict(l_max=8)),
                                     ("ecp", dict(l_max=8)),
                                     ("healpix", dict(nside=4)),
                                     ("healpix_ring", dict(nside=4))])
@pytest.mark.parametrize("fold,spin", [(False, 0), (True, 0), (False, 2)])
def test_fusion_eligibility_matches_reference(kind, kw, fold, spin):
    p = repro_torch.make_plan(kind, **kw, dtype="float32", fold=fold,
                              spin=spin, device="cpu")
    rp = repro.make_plan(kind, **kw, dtype="float32", fold=fold, spin=spin,
                         mode="jnp")
    ok, reason = p._fusion_eligibility()
    assert (ok, reason) == rp._fusion_eligibility()
    assert p.layouts == {d: "fused" if ok else "plain"
                         for d in ("synth", "anal")}
    if not ok:
        with pytest.raises(ValueError, match="fused layout unavailable"):
            repro_torch.make_plan(kind, **kw, dtype="float32", fold=fold,
                                  spin=spin, layout="fused", device="cpu")


def test_describe_and_report_show_the_buckets():
    p = repro_torch.make_plan("healpix", nside=8, K=2, dtype="float32",
                              device="cpu")
    rp = repro.make_plan("healpix", nside=8, K=2, dtype="float32",
                         mode="jnp")
    d = p.describe()
    assert d["phase"] == rp.describe()["phase"]
    assert d["phase"]["kind"] == "bucket" and d["phase"]["n_buckets"] > 1
    assert d["signature"]["grid"] == "healpix"
    ph = d["phase"]
    assert (f"phase: bucket x{ph['n_buckets']} buckets "
            f"{ph['bucket_lengths']}") in p.report()
    assert "synth -> cuda_vpu[fused]" in p.report()


# ---------------------------------------------------------------------------
# the analysis partials in memory_footprint (port-only key)
# ---------------------------------------------------------------------------


class _FakeLib:
    """Stand-in for a kernel library: every entry point launches nothing
    and reports success."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.mark.parametrize("layout", ["fused", "plain", "packed",
                                    "fused+plain", "plain+packed"])
@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("kind,kw,mode", [
    ("gl", dict(l_max=20), "cuda_vpu"), ("gl", dict(l_max=20), "cuda_mxu"),
    ("healpix", dict(nside=4), "cuda_vpu"),
    ("healpix", dict(nside=4), "cuda_mxu")])
def test_partials_bytes_equal_the_allocated_buffer(kind, kw, mode, spin,
                                                   layout, monkeypatch):
    """``memory_footprint()["partials_bytes"]`` equals the bytes of the
    partials buffer the analysis of the layout allocates: the CUDA route of
    a CPU plan, rehearsed with kernel libraries that launch nothing, hands
    its buffer to ``anal_reduce``, which records it.  The reference's
    keys keep their values.  ``"synth+anal"`` layouts are a plan whose
    directions differ (``mode="auto"`` with a measured table that picks
    them): the buffer is the analysis layout's."""
    if "+" in layout:
        synth, anal = layout.split("+")

        def measured(plan):
            out = {b: {"synth": 1.0, "anal": 1.0} for b in plan.candidates}
            out[mode] = {"synth": 1e-3, "synth_layout": synth,
                         "anal": 1e-3, "anal_layout": anal}
            return out

        monkeypatch.setattr(transform.Plan, "_measure_all", measured)
        transform.clear_plan_cache()         # no plan memoised by another
        p = repro_torch.make_plan(kind, **kw, K=3, dtype="float32",
                                  mode="auto", spin=spin, cache="off",
                                  device="cpu")
        assert p.layouts == {"synth": synth, "anal": anal}
    else:
        p = repro_torch.make_plan(kind, **kw, K=3, dtype="float32",
                                  mode=mode, spin=spin, layout=layout,
                                  device="cpu")
    seen = []
    reduce = lc.anal_reduce

    def spy(partials, *args, **kwargs):
        seen.append(partials.numel() * partials.element_size())
        return reduce(partials, *args, **kwargs)

    def check(name, t, dtype, shape):          # lc._check without the device
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name
        assert t.is_contiguous(), name

    monkeypatch.setattr(lc, "_check", check)
    monkeypatch.setattr(ops, "_route", lambda device: "cuda")
    monkeypatch.setattr(lc, "_lib", lambda: _FakeLib())
    monkeypatch.setattr(fused_cuda, "_lib", lambda: _FakeLib())
    monkeypatch.setattr(lc, "_stream", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda *a: contextlib.nullcontext())
    monkeypatch.setattr(lc, "anal_reduce", spy)
    p.map2alm(torch.zeros(p._maps_shape))
    fp = p.memory_footprint()
    assert seen == [fp["partials_bytes"]] and fp["partials_bytes"] > 0
    ref_keys = ("alm_bytes", "maps_bytes", "delta_bytes", "seed_bytes")
    rp = repro.make_plan(kind, **kw, K=3, dtype="float32",
                         mode=f"pallas_{mode[5:]}", spin=spin)
    rfp = rp.memory_footprint()
    assert {k: fp[k] for k in ref_keys} == {k: rfp[k] for k in ref_keys}
    assert fp["total_bytes"] == sum(fp[k] for k in ref_keys) \
        + fp["partials_bytes"]


@pytest.mark.parametrize("kind,kw", [("healpix", dict(nside=4)),
                                     ("healpix_ring", dict(nside=2)),
                                     ("ecp", dict(l_max=6))])
def test_interop_carries_a_reference_grid_and_layout(kind, kw):
    """A reference grid and its bucket layout cross over as numpy; a plan
    on the carried grid agrees with the plan on the port's own grid."""
    rg = rgrids.make_grid(kind, **kw)
    g = interop.grid_from_reference(rg)
    for f in GRID_FIELDS:
        np.testing.assert_array_equal(getattr(g, f), getattr(rg, f))
    assert (g.uniform, g.nside) == (rg.uniform, rg.nside)
    rlo = rgrids.BucketLayout.from_buckets(rg.fft_buckets())
    lo = interop.layout_from_reference(rlo)
    assert lo.lengths == rlo.lengths
    for a, b in zip(lo.slots, rlo.slots):
        np.testing.assert_array_equal(a, b)
    l_max = kw.get("l_max", 2 * kw.get("nside", 0))
    carried = repro_torch.make_plan(g, l_max, device="cpu")
    own = repro_torch.make_plan(kind, **kw, device="cpu")
    a = torch.as_tensor(alm_np(own._alm_shape, own.l_max, own.m_max))
    assert torch.equal(carried.alm2map(a), own.alm2map(a))


def test_partials_bytes_are_zero_on_the_torch_backend():
    p = repro_torch.make_plan("healpix", nside=4, device="cpu")
    assert p.memory_footprint()["partials_bytes"] == 0
