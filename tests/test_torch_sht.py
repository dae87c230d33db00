"""The port's float64 ``torch`` oracle against the JAX reference's serial
engine: ``SHT`` and the ``torch`` plan backend, on the same numpy inputs,
within 1e-12 relative."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import grids as rgrids
from repro.core import phase as rphase
from repro.core import sht as rsht

import repro_torch
from repro_torch.core import grids, phase, sht, spectra

TOL = 1e-12


def rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def numpy_alm(l_max: int, K: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (l_max + 1, l_max + 1, K)
    alm = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    alm[0] = alm[0].real
    return alm * rsht.alm_mask(l_max, l_max)[..., None]


@functools.lru_cache(maxsize=None)
def reference_case(l_max: int, K: int, fold: bool):
    """Reference outputs of one (l_max, K, fold) case, computed once."""
    alm = numpy_alm(l_max, K, seed=l_max + K)
    ref = rsht.SHT(rgrids.make_grid("gl", l_max=l_max), l_max, l_max,
                   "float64", fold)
    maps = np.asarray(ref.alm2map(jnp.asarray(alm)))
    rng = np.random.default_rng(l_max)
    noisy = maps + 0.1 * rng.normal(size=maps.shape)  # not band-limited
    return (alm, maps, noisy, np.asarray(ref.map2alm(jnp.asarray(noisy))),
            np.asarray(ref.map2alm(jnp.asarray(noisy), iters=1)))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("l_max", [8, 31, 64])
def test_sht_matches_reference(l_max, K, fold):
    alm, maps, noisy, alm0, alm1 = reference_case(l_max, K, fold)
    eng = sht.SHT(grids.make_grid("gl", l_max=l_max), l_max, l_max,
                  "float64", fold)
    assert rel(eng.alm2map(torch.as_tensor(alm)), maps) < TOL
    noisy_t = torch.as_tensor(noisy)
    assert rel(eng.map2alm(noisy_t), alm0) < TOL
    assert rel(eng.map2alm(noisy_t, iters=1), alm1) < TOL


@pytest.mark.parametrize("fold", [False, True])
def test_torch_plan_matches_reference_plan(fold):
    l_max, K = 31, 3
    alm, maps, noisy, alm0, alm1 = reference_case(l_max, K, fold)
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float64",
                                 mode="torch", fold=fold, device="cpu")
    rplan = repro.make_plan("gl", l_max, K=K, dtype="float64", mode="jnp",
                            fold=fold)
    assert plan.backends == {"synth": "torch", "anal": "torch"}
    assert rel(plan.alm2map(alm), np.asarray(rplan.alm2map(alm))) < TOL
    assert rel(plan.map2alm(noisy), np.asarray(rplan.map2alm(noisy))) < TOL
    assert rel(plan.map2alm(noisy, iters=1),
               np.asarray(rplan.map2alm(noisy, iters=1))) < TOL
    assert spectra.d_err(alm, plan.map2alm(plan.alm2map(alm))) < TOL


def test_phase_stage_object_surface():
    g = grids.make_grid("gl", l_max=10)
    ph = phase.make_phase(g, 10)
    rph = rphase.make_phase(rgrids.make_grid("gl", l_max=10), 10, "float64")
    assert ph.kind == rph.kind == "uniform"
    assert ph.describe() == rph.describe()
    np.testing.assert_array_equal(ph.fft_lengths, rph.fft_lengths)
    with pytest.raises(ValueError, match="n_phi >= 2"):
        phase.make_phase(grids.gauss_legendre_grid(10, n_phi=8), 10)


def test_sht_validates_shapes():
    eng = sht.SHT(grids.make_grid("gl", l_max=6), 6, 6)
    with pytest.raises(ValueError):
        eng.alm2map(torch.zeros(6, 7, 1, dtype=torch.complex128))
    with pytest.raises(ValueError):
        eng.map2alm(torch.zeros(5, 14, 1, dtype=torch.float64))
    with pytest.raises(ValueError):
        sht.SHT(grids.make_grid("gl", l_max=6), 4, 6)
