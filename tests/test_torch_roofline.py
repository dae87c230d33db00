"""The port's cost model (``repro_torch.roofline.analysis``) against the
reference's (``repro.roofline.analysis``).

The operation counts and the Legendre grid accounting are integer or
exactly computed sums, so they must be equal; the predicted seconds under
the host model (the reference's own figures under the port's backend
names) must agree to 1e-12 relative.  The H100 model is the port's own:
its hardware figures are the data sheet's, and its efficiencies reproduce
the measured times they were fitted to.
"""
import numpy as np
import pytest

from repro.core import grids as rgrids
from repro.core import phase as rphase
from repro.roofline import analysis as rra
from repro_torch.core import grids, phase
from repro_torch.roofline import analysis as ra

#: the port's backend names for the reference's
NAMES = {"torch": "jnp", "cuda_vpu": "pallas_vpu", "cuda_mxu": "pallas_mxu",
         "dist": "dist"}

GRIDS = [("gl", dict(l_max=24)), ("ecp", dict(l_max=20)),
         ("healpix", dict(nside=8)), ("healpix_ring", dict(nside=4))]


def shapes(kind, kw):
    """(port grid, reference grid, l_max, fft lengths of the port's phase
    stage, of the reference's)."""
    g = grids.make_grid(kind, **kw)
    rg = rgrids.make_grid(kind, **kw)
    l_max = kw.get("l_max") or 2 * kw["nside"]
    return (g, rg, l_max, phase.make_phase(g, l_max).fft_lengths,
            rphase.make_phase(rg, l_max, "float64").fft_lengths)


@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("kind,kw", GRIDS)
def test_sht_work_equals_the_reference(kind, kw, spin):
    """sht_work, its panel accounting and legendre_panel_counts equal the
    reference's, on the uniform grids and with a ragged grid's bucket FFT
    lengths, at spin 0 and 2, for K 1 and 8."""
    g, rg, l_max, fl, rfl = shapes(kind, kw)
    assert np.array_equal(fl, rfl)
    for K in (1, 8):
        for m_max in (l_max, l_max // 2):
            args = (l_max, m_max, g.n_rings, g.max_n_phi, K)
            got = ra.sht_work(*args, fft_lengths=fl, spin=spin)
            want = rra.sht_work(*args, fft_lengths=rfl, spin=spin)
            assert got == want
            plain = ra.sht_work(*args, spin=spin)
            assert plain == rra.sht_work(*args, spin=spin)
    for lp in (32, 128):
        assert ra.legendre_panel_counts(l_max, l_max, lp_size=lp, spin=spin) \
            == rra.legendre_panel_counts(l_max, l_max, lp_size=lp, spin=spin)


@pytest.mark.parametrize("backend", sorted(NAMES))
@pytest.mark.parametrize("kind,kw", GRIDS)
def test_predict_sht_time_equals_the_reference_on_the_host(kind, kw,
                                                           backend):
    """predict_sht_time under HW_HOST against the reference's under its
    HW_HOST, for every direction, layout and pipeline, spin 0 and 2, with
    and without the bucket FFT lengths: equal to 1e-12 relative."""
    g, rg, l_max, fl, rfl = shapes(kind, kw)
    n = 0
    for spin in (0, 2):
        for K in (1, 8):
            for direction in ("synth", "anal"):
                for layout in (None, "plain", "packed"):
                    for pipeline in ("staged", "fused"):
                        for lengths, rlengths in ((fl, rfl), (None, None)):
                            kw_ = dict(l_max=l_max, m_max=l_max,
                                       n_rings=g.n_rings, n_phi=g.max_n_phi,
                                       K=K, direction=direction, spin=spin,
                                       layout=layout, pipeline=pipeline)
                            got = ra.predict_sht_time(
                                backend, hw=ra.HW_HOST, fft_lengths=lengths,
                                **kw_)
                            want = rra.predict_sht_time(
                                NAMES[backend], hw=rra.HW_HOST,
                                fft_lengths=rlengths, **kw_)
                            assert abs(got - want) <= 1e-12 * abs(want)
                            n += 1
    assert n == 96


def test_host_model_is_the_reference_model():
    """HW_HOST and the host backend efficiencies are the reference's; the
    H100 model carries the data sheet's float32, HBM and NVLink figures,
    and its dist model the cuda_mxu efficiencies (no multi-card time of
    the port to fit it to)."""
    for f in ("name", "peak_flops", "hbm_bw", "link_bw", "coll_latency"):
        assert getattr(ra.HW_HOST, f) == getattr(rra.HW_HOST, f)
    host = ra.BACKEND_MODELS["host-cpu"]
    assert set(host) == set(NAMES)
    for b, rb in NAMES.items():
        m, rm = host[b], rra.BACKEND_MODELS[rb]
        assert (m.vector_eff, m.matrix_eff, m.anal_penalty) == \
            (rm.vector_eff, rm.matrix_eff, rm.anal_penalty)
    assert (ra.HW_H100.peak_flops, ra.HW_H100.hbm_bw, ra.HW_H100.link_bw) \
        == (67e12, 3.35e12, 450e9)
    assert set(ra.BACKEND_MODELS["h100-sxm"]) == set(NAMES)
    h100 = ra.BACKEND_MODELS["h100-sxm"]
    assert (h100["dist"].vector_eff, h100["dist"].matrix_eff,
            h100["dist"].anal_penalty) == (h100["cuda_mxu"].vector_eff,
                                           h100["cuda_mxu"].matrix_eff,
                                           h100["cuda_mxu"].anal_penalty)
    with pytest.raises(ValueError, match="unknown backend"):
        ra.predict_sht_time("jnp", l_max=8, m_max=8, n_rings=9, n_phi=18,
                            K=1)


@pytest.mark.parametrize("backend,l_max,K,synth_ms,anal_ms", [
    ("cuda_vpu", 4096, 1, 31.29, 34.71), ("cuda_mxu", 2048, 8, 12.32, 14.54),
    ("torch", 2048, 8, 3280.377, 2468.730)])
def test_h100_model_reproduces_the_times_it_was_fitted_to(backend, l_max, K,
                                                          synth_ms, anal_ms):
    """The H100 efficiencies were fitted (``scripts/fit_h100_model.py``) to
    spin-0 pairs measured on one H100 80GB HBM3 at 700 W (PERF.md §5): the
    fused ones of the kernel backends, the torch corners of the smoke's
    phase 6.  The model gives those times back within 0.5%."""
    n_rings, n_phi = l_max + 1, 2 * l_max + 2
    kernel = backend != "torch"
    kw = dict(l_max=l_max, m_max=l_max, n_rings=n_rings, n_phi=n_phi, K=K,
              hw=ra.HW_H100, layout="packed" if kernel else None,
              pipeline="fused" if kernel else "staged")
    assert grids.make_grid("gl", l_max=64).max_n_phi == 2 * 64 + 2
    s = ra.predict_sht_time(backend, direction="synth", **kw) * 1e3
    a = ra.predict_sht_time(backend, direction="anal", **kw) * 1e3
    assert abs(s / synth_ms - 1) < 5e-3 and abs(a / anal_ms - 1) < 5e-3


def test_hardware_for_a_device():
    import torch
    assert ra.hardware_for(torch.device("cpu")) is ra.HW_HOST
    assert ra.hardware_for(torch.device("cuda", 0)) is ra.HW_H100
