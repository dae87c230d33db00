"""Host-side precompute of the PyTorch port against the JAX reference:
grids, Legendre seeds, phase-stage bin maps and masks must be
array-equal; plus the port's cache and interop helpers."""

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables float64 in the reference)
from repro.core import cache as rcache
from repro.core import grids as rgrids
from repro.core import legendre as rleg
from repro.core import phase as rphase
from repro.core import sht as rsht
from repro.kernels import ref as rref

from repro_torch.core import cache, grids, legendre, phase, sht
from repro_torch.interop import from_reference
from repro_torch.kernels import ref as kref

GRID_FIELDS = ("cos_theta", "sin_theta", "weights", "n_phi", "phi0")


@pytest.mark.parametrize("l_max", [1, 8, 31, 64, 257])
def test_gl_grid_array_equal(l_max):
    g, rg = grids.make_grid("gl", l_max=l_max), rgrids.make_grid("gl", l_max=l_max)
    for f in GRID_FIELDS:
        np.testing.assert_array_equal(getattr(g, f), getattr(rg, f))
    assert (g.uniform, g.n_rings, g.max_n_phi, g.equator_symmetric) == \
        (rg.uniform, rg.n_rings, rg.max_n_phi, rg.equator_symmetric)


def test_gl_grid_custom_sizes_array_equal():
    g = grids.gauss_legendre_grid(20, n_rings=30, n_phi=64)
    rg = rgrids.gauss_legendre_grid(20, n_rings=30, n_phi=64)
    for f in GRID_FIELDS:
        np.testing.assert_array_equal(getattr(g, f), getattr(rg, f))


@pytest.mark.parametrize("kind", ["ecp", "healpix", "healpix_ring"])
def test_other_grid_kinds_name_their_roadmap_item(kind):
    """The grid kinds ROADMAP item 8 named while they were refused are
    ported: each builds (its irrelevant size ignored, as in the reference)
    and is array-equal to the reference's (the test keeps its ID)."""
    g = grids.make_grid(kind, l_max=8, nside=4)
    rg = rgrids.make_grid(kind, l_max=8, nside=4)
    for f in GRID_FIELDS:
        np.testing.assert_array_equal(getattr(g, f), getattr(rg, f))
    assert (g.name, g.uniform, g.nside) == (rg.name, rg.uniform, rg.nside)


@pytest.mark.parametrize("m_max", [0, 5, 300, 4096])
def test_log_mu_array_equal(m_max):
    np.testing.assert_array_equal(legendre.log_mu(m_max), rleg.log_mu(m_max))


@pytest.mark.parametrize("l_max", [64, 512, 2048])
@pytest.mark.parametrize("fold", [False, True])
def test_prepare_seeds_array_equal(l_max, fold):
    g = rgrids.make_grid("gl", l_max=l_max)
    nh = (g.n_rings + 1) // 2
    sin = g.sin_theta[:nh] if fold else g.sin_theta
    m_vals = np.arange(l_max + 1)
    lm = rleg.log_mu(l_max)
    pmm, pms = kref.prepare_seeds(m_vals, sin, lm)
    want_pmm, want_pms = rref.prepare_seeds(m_vals, sin, lm)
    np.testing.assert_array_equal(pmm, np.asarray(want_pmm))
    np.testing.assert_array_equal(pms, np.asarray(want_pms))
    assert pmm.dtype == np.float32 and pms.dtype == np.int32


def test_prepare_seeds_padding_rows_array_equal():
    g = rgrids.make_grid("gl", l_max=40)
    m_vals = np.array([0, 7, -1, 40, -1, 3])
    lm = rleg.log_mu(40)
    pmm, pms = kref.prepare_seeds(m_vals, g.sin_theta, lm)
    want_pmm, want_pms = rref.prepare_seeds(m_vals, g.sin_theta, lm)
    np.testing.assert_array_equal(pmm, np.asarray(want_pmm))
    np.testing.assert_array_equal(pms, np.asarray(want_pms))
    assert np.all(pmm[m_vals < 0] == 0.0)


def test_pmm_scaled_matches_reference():
    g = rgrids.make_grid("gl", l_max=300)
    m = np.arange(301, dtype=np.float64)[:, None]
    lm = rleg.log_mu(300)[:, None]
    for dt, sb in ((torch.float64, 512), (torch.float32, 64)):
        mant, sc = legendre.pmm_scaled(torch.as_tensor(lm), torch.as_tensor(m),
                                       torch.as_tensor(g.sin_theta)[None, :],
                                       dtype=dt, scale_bits=sb)
        want_m, want_s = rleg.pmm_scaled(lm, m, g.sin_theta[None, :],
                                         dtype=np.float64 if sb == 512
                                         else np.float32, scale_bits=sb)
        # torch's float64 exp may differ from XLA's in the last bit; the
        # scales, and the float32 mantissas the kernels use, are exact
        if dt == torch.float64:
            np.testing.assert_allclose(mant.numpy(), np.asarray(want_m),
                                       rtol=4.5e-16, atol=0)
        else:
            np.testing.assert_array_equal(mant.numpy(), np.asarray(want_m))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(want_s))
        assert legendre.scale_bits_for(dt) == sb


@pytest.mark.parametrize("n", [16, 17, 64])
def test_uniform_bin_maps_array_equal(n):
    m_vals = np.array([0, 1, 5, 8, 9, 15, 16, 30, -1])
    for got, want in zip(phase.uniform_bin_maps(m_vals, n),
                         rphase.uniform_bin_maps(m_vals, n)):
        np.testing.assert_array_equal(got, want)


def test_fac_rows_array_equal():
    m_vals = np.array([0, 1, 2, -1, 7])
    np.testing.assert_array_equal(phase._fac_rows(m_vals, torch.float64),
                                  rphase._fac_rows(m_vals, np.float64))


def test_phase_factors_match_reference():
    m_vals = np.array([0, 3, -1, 12])
    phi0 = np.linspace(0.0, 1.3, 7)
    got = phase.phase_factors(m_vals, phi0, -1.0, torch.float64, "cpu")
    want = np.asarray(rphase.phase_factors(m_vals, phi0, -1.0, np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("spin", [0, 2])
def test_alm_mask_array_equal(spin):
    np.testing.assert_array_equal(sht.alm_mask(12, 9, spin),
                                  rsht.alm_mask(12, 9, spin))


def test_alm_rect_zeros_and_random_alm():
    z = sht.alm_rect_zeros(6, 4, K=2, device="cpu")
    assert z.shape == (5, 7, 2) and z.dtype == torch.complex128
    gen = torch.Generator().manual_seed(0)
    a = sht.random_alm(gen, 6, 6, K=3, device="cpu")
    assert torch.all(a[0].imag == 0)
    mask = torch.as_tensor(rsht.alm_mask(6, 6))[..., None].expand_as(a)
    assert torch.all(a[~mask] == 0)
    assert float(a.real.abs().max()) < 1.0


def test_signature_key_hashes_arrays_by_value():
    a = np.arange(5.0)
    k1 = cache.signature_key("x", arr=a, n=3)
    assert k1 == cache.signature_key("x", n=3, arr=a.copy())
    assert k1 != cache.signature_key("x", arr=a + 1, n=3)
    assert k1 != cache.signature_key("y", arr=a, n=3)
    assert len(k1) == len(rcache.signature_key("x", arr=a, n=3)) == 32


def test_get_or_build_memory_tier_builds_once():
    cache.clear_memory()
    cache.reset_stats()
    calls = []

    def build():
        calls.append(1)
        return {"v": np.arange(3)}

    key = cache.signature_key("test", n=1)
    p1 = cache.get_or_build(key, build)
    p2 = cache.get_or_build(key, build)
    assert p1 is p2 and len(calls) == 1
    s = cache.stats()
    assert (s.builds, s.memory_hits, s.misses) == (1, 1, 1)
    cache.clear_memory()
    assert cache.get_or_build(key, build) is not p1 and len(calls) == 2


def test_lru_evicts_like_reference():
    evicted, r_evicted = [], []
    lru = cache.LRU(2, on_evict=lambda k, v: evicted.append(k))
    ref = rcache.LRU(2, on_evict=lambda k, v: r_evicted.append(k))
    for c in (lru, ref):
        c.put("a", 1)
        c.put("b", 2)
        assert c.get("a") == 1
        c.put("c", 3)
        c.put("b", 4)
    assert evicted == r_evicted == ["b", "a"]
    assert lru.keys() == ref.keys() and lru.evictions == ref.evictions
    assert len(lru) == 2 and "c" in lru and lru.pop("c") == 3
    with pytest.raises(ValueError):
        cache.LRU(0)


def test_from_reference_layouts_and_dtypes():
    rg = rgrids.make_grid("gl", l_max=10)
    pmm, pms = rref.prepare_seeds(np.arange(11), rg.sin_theta,
                                  rleg.log_mu(10))
    rng = np.random.default_rng(0)
    alm = rng.normal(size=(11, 11, 2)) + 1j * rng.normal(size=(11, 11, 2))
    maps = rng.normal(size=(11, 22, 2))
    state = {f: getattr(rg, f) for f in GRID_FIELDS}
    state.update(pmm=np.asarray(pmm), pms=np.asarray(pms), alm=alm, maps=maps)
    out = from_reference(state, device="cpu")
    for f in GRID_FIELDS:
        np.testing.assert_array_equal(out[f].numpy(), getattr(rg, f))
    assert out["cos_theta"].dtype == torch.float64
    assert out["n_phi"].dtype == torch.int64
    assert out["pmm"].dtype == torch.float32 and out["pms"].dtype == torch.int32
    np.testing.assert_array_equal(out["pmm"].numpy(), np.asarray(pmm))
    assert out["alm"].dtype == torch.complex128
    np.testing.assert_array_equal(out["alm"].numpy(), alm)
    np.testing.assert_array_equal(out["maps"].numpy(), maps)
    with pytest.raises(KeyError):
        from_reference({"bogus": maps}, device="cpu")
    with pytest.raises(ValueError):
        from_reference({"alm": maps}, device="cpu")
    with pytest.raises(ValueError):
        from_reference({"pmm": maps}, device="cpu")


@pytest.mark.parametrize("make", [
    lambda: sht.alm_rect_zeros(4, 4),
    lambda: sht.random_alm(torch.Generator().manual_seed(0), 4, 4),
    lambda: from_reference({"cos_theta": np.zeros(3)})],
    ids=["alm_rect_zeros", "random_alm", "from_reference"])
def test_tensor_makers_default_to_cuda(monkeypatch, make):
    """Like make_plan, they run on the CPU only when asked to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
