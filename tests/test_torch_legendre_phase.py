"""The port's float64 Legendre stages and uniform phase stage against the
JAX reference on the same numpy inputs, within 1e-12 relative (the
float32 oracle within 5e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables float64 in the reference)
from repro.core import grids as rgrids
from repro.core import legendre as rleg
from repro.core import phase as rphase

from repro_torch.core import legendre, phase

TOL = 1e-12


def rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _legendre_inputs(l_max, K, m_vals, north):
    g = rgrids.make_grid("gl", l_max=l_max)
    n = (g.n_rings + 1) // 2 if north else g.n_rings
    rng = np.random.default_rng(5)
    a = rng.normal(size=(2, len(m_vals), l_max + 1, K))
    a *= (np.arange(l_max + 1)[None, :] >= m_vals[:, None])[None, ..., None]
    d = rng.normal(size=(4, len(m_vals), n, K))
    return g.cos_theta[:n], g.sin_theta[:n], g.weights[:n], a, d


@pytest.mark.parametrize("l_max", [20, 300])
def test_legendre_stages_match_reference(l_max):
    """Unfolded and folded synthesis and analysis stages, including high-m
    rows whose seeds are rescaled (scale < 0) at polar rings."""
    m_vals = np.array([0, 1, 7, l_max // 2, l_max])
    lm = rleg.log_mu(l_max)
    for north in (False, True):
        x, sin, w, a, d = _legendre_inputs(l_max, 2, m_vals, north)
        t = [torch.as_tensor(v) for v in (*a, *d)]
        if not north:
            got = legendre.delta_from_alm(t[0], t[1], m_vals, x, sin, lm,
                                          l_max=l_max)
            want = rleg.delta_from_alm(a[0], a[1], m_vals, x, sin, lm,
                                       l_max=l_max)
            got += legendre.alm_from_delta(t[2], t[3], m_vals, x, sin, w, lm,
                                           l_max=l_max)
            want += rleg.alm_from_delta(d[0], d[1], m_vals, x, sin, w, lm,
                                        l_max=l_max)
        else:
            got = legendre.delta_from_alm_folded(t[0], t[1], m_vals, x, sin,
                                                 lm, l_max=l_max)
            want = rleg.delta_from_alm_folded(a[0], a[1], m_vals, x, sin, lm,
                                              l_max=l_max)
            got += legendre.alm_from_delta_folded(*t[2:], m_vals, x, sin, lm,
                                                  l_max=l_max)
            want += rleg.alm_from_delta_folded(*d, m_vals, x, sin, lm,
                                               l_max=l_max)
        for gv, wv in zip(got, want):
            assert rel(gv, wv) < TOL


def test_float32_oracle_matches_reference_float32():
    """The oracle in float32 (64 scale bits) stays within float32 rounding
    of the reference's float32 engine."""
    l_max, K = 40, 2
    m_vals = np.arange(l_max + 1)
    x, sin, w, a, d = _legendre_inputs(l_max, K, m_vals, north=False)
    lm = rleg.log_mu(l_max)
    got = legendre.delta_from_alm(torch.as_tensor(a[0], dtype=torch.float32),
                                  torch.as_tensor(a[1], dtype=torch.float32),
                                  m_vals, x, sin, lm, l_max=l_max)
    want = rleg.delta_from_alm(a[0], a[1], m_vals, x, sin, lm, l_max=l_max,
                               dtype=jnp.float32)
    assert got[0].dtype == torch.float32
    for gv, wv in zip(got, want):
        assert rel(gv, wv) < 5e-5


@pytest.mark.parametrize("n_extra", [0, 3])
def test_uniform_phase_matches_reference(n_extra):
    """Synthesis and analysis phase stages, with aliased m rows (m > n/2,
    Nyquist) when the ring is short, and padding rows."""
    R, K = 5, 2
    n = 12 + n_extra
    m_vals = np.array([0, 1, 4, 6, 7, 9, -1])
    phi0 = np.linspace(0.0, 0.7, R)
    w = np.linspace(0.5, 1.5, R)
    rng = np.random.default_rng(1)
    delta = rng.normal(size=(len(m_vals), R, K)) \
        + 1j * rng.normal(size=(len(m_vals), R, K))
    maps = rng.normal(size=(R, n, K))
    got = phase.uniform_synth(torch.as_tensor(delta), m_vals, n, phi0)
    want = rphase.uniform_synth(delta, m_vals, n, phi0, dtype=jnp.float64)
    assert rel(got, want) < TOL
    got = phase.uniform_anal(torch.as_tensor(maps), m_vals, n, phi0, w)
    want = rphase.uniform_anal(maps, m_vals, n, phi0, w, dtype=jnp.float64)
    assert rel(got, want) < TOL
