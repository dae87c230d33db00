"""The port's plan surface: memoisation, backend choice, the device rule,
what raises until it is ported, and describe()/report()."""

import numpy as np
import pytest
import torch

import repro
from repro.core import grids as rgrids

import repro_torch
from repro_torch.core import cache, grids, sht, spectra, transform


def alm_for(plan, seed=0):
    rng = np.random.default_rng(seed)
    shape = plan._alm_shape
    alm = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    alm[0] = alm[0].real
    mask = np.arange(plan.l_max + 1)[None, :] >= np.arange(plan.m_max + 1)[:, None]
    return alm * mask[..., None]


def test_make_plan_is_memoised():
    repro_torch.clear_plan_cache()
    p1 = repro_torch.make_plan("gl", 12, K=2, device="cpu")
    assert repro_torch.make_plan("gl", 12, K=2, device="cpu") is p1
    assert repro_torch.make_plan("gl", 12, K=3, device="cpu") is not p1
    assert repro_torch.make_plan("gl", 12, K=2, fold=True,
                                 device="cpu") is not p1
    repro_torch.clear_plan_cache()
    assert repro_torch.make_plan("gl", 12, K=2, device="cpu") is not p1


def test_plans_on_one_grid_share_their_seed_tables():
    repro_torch.clear_plan_cache()
    cache.reset_stats()
    mk = lambda **kw: repro_torch.make_plan("gl", 20, device="cpu", **kw)
    base = mk(K=1, dtype="float32", mode="cuda_vpu")
    others = [mk(K=8, dtype="float32", mode="cuda_mxu"),
              mk(K=3, dtype="float64", mode="cuda_vpu")]
    folded = mk(K=1, dtype="float32", mode="cuda_vpu", fold=True)
    narrow = mk(K=1, dtype="float32", mode="cuda_vpu", m_max=10)
    seeds = [p._seeds() for p in [base, *others, folded, narrow]]
    assert cache.stats().builds == 1 + 3       # geometry, base, fold, m_max
    for s in seeds[1:3]:
        for got, want in zip(s, seeds[0]):
            assert torch.equal(got, want)
    assert seeds[3][1].shape[0] == 11 and seeds[4][2].shape[0] == 11
    assert base.describe()["cache"]["events"]["seeds"] == \
        others[0].describe()["cache"]["events"]["seeds"]
    assert folded.describe()["cache"]["events"]["seeds"] != \
        base.describe()["cache"]["events"]["seeds"]


@pytest.mark.parametrize("dtype,K,want", [
    ("float64", 1, "torch"), ("float64", 8, "torch"),
    ("float32", 1, "cuda_vpu"), ("float32", 7, "cuda_vpu"),
    ("float32", 8, "cuda_mxu")])
def test_default_mode_follows_the_static_variant_rule(dtype, K, want):
    plan = repro_torch.make_plan("gl", 8, K=K, dtype=dtype, device="cpu")
    assert plan.backends == {"synth": want, "anal": want}
    assert plan.layouts == ({"synth": None, "anal": None} if want == "torch"
                            else {"synth": "fused", "anal": "fused"})


@pytest.mark.parametrize("kwargs,item", [
    (dict(mode="auto"), "item 9"), (dict(mode="model"), "item 9"),
    (dict(mode="dist"), "item 11"), (dict(mode="auto", spin=2), "item 9"),
    (dict(mode="dist", spin=2), "item 11"),
    (dict(grid="healpix", spin=2), "item 8"),
    (dict(grid="healpix"), "item 8"), (dict(grid="ecp"), "item 8")])
def test_unported_requests_name_their_roadmap_item(kwargs, item):
    """The requests ROADMAP items 8, 9 and 11 named while they were open
    are ported (the cases keep their IDs).  Item 11, mode "dist", runs over
    an initialised process group of >= 2 ranks (tests/test_torch_dist.py);
    this process has none, so it raises with the reference's reason.
    Items 8 and 9 build plans: ECP and the HEALPix family, spin 0 and 2,
    on every kernel layout; modes auto and model, which choose a backend
    per direction (float64: the torch oracle alone) and, in float32, a
    kernel backend and layout whose transforms agree with the oracle."""
    kwargs = dict(dict(grid="gl", l_max=8, device="cpu"), **kwargs)
    if item == "item 11":
        with pytest.raises(ValueError, match=r"needs >= 2 devices "
                                             r"\(visible: 1\)"):
            repro_torch.make_plan(**kwargs)
        return
    if item == "item 9":
        plan = repro_torch.make_plan(**kwargs)
        assert plan.mode == kwargs["mode"] and plan.l_max == 8
        assert plan.backends == {"synth": "torch", "anal": "torch"}
        assert set(plan.predicted_s) == {"torch"}
        alm = torch.as_tensor(alm_for(plan))
        want = plan.alm2map(alm)
        kern = repro_torch.make_plan(**dict(kwargs, dtype="float32"))
        assert set(kern.backends.values()) <= set(transform.BACKENDS)
        got = kern.alm2map(alm.to(torch.complex64))
        assert float((got - want).abs().max()) < 1e-4 * float(
            want.abs().max())
        back = kern.map2alm(got)
        assert spectra.d_err(plan.map2alm(want), back) < 1e-4
        return
    kwargs.setdefault("nside", 4)
    plan = repro_torch.make_plan(**kwargs)
    assert plan.grid.name == kwargs["grid"] and plan.l_max == 8
    assert plan.backends == {"synth": "torch", "anal": "torch"}
    alm = torch.as_tensor(alm_for(plan))
    maps = plan.alm2map(alm)
    assert tuple(maps.shape) == plan._maps_shape
    assert bool(torch.isfinite(maps).all())
    kern = repro_torch.make_plan(**dict(kwargs, dtype="float32"))
    assert kern.layouts == {"synth": "fused", "anal": "fused"}
    got = kern.alm2map(alm.to(torch.complex64))
    assert float((got - maps).abs().max()) < 1e-4 * float(maps.abs().max())


@pytest.mark.parametrize("kwargs,layout", [
    (dict(layout="packed"), "packed"), (dict(layout="fused"), "fused"),
    (dict(), "fused")])
def test_spin2_requests_build_spin_plans(kwargs, layout):
    """make_plan(spin=2) on the kernel backends: the fused default as the
    reference planner picks it, or the layout asked for; (E, B) alm in,
    (Q, U) maps out, against the float64 torch spin plan."""
    plan = repro_torch.make_plan("gl", 8, K=2, dtype="float32", spin=2,
                                 device="cpu", **kwargs)
    assert plan.spin == 2 and plan.layouts == {"synth": layout,
                                               "anal": layout}
    ref = repro_torch.make_plan("gl", 8, K=2, dtype="float64", spin=2,
                                device="cpu")
    alm = sht.random_alm_spin(torch.Generator().manual_seed(1), 8, 8, 2,
                              device="cpu")
    maps = plan.alm2map(alm.to(torch.complex64))
    want = ref.alm2map(alm)
    assert maps.shape == want.shape == (2, 9, 18, 2)
    assert float((maps - want).abs().max() / want.abs().max()) < 1e-5
    back = plan.map2alm(maps)
    assert back.shape == alm.shape
    assert spectra.d_err(alm, back) < 1e-5


@pytest.mark.parametrize("kwargs", [
    dict(mode="jnp"), dict(mode="pallas_vpu"), dict(layout="banded"),
    dict(dtype="float16"), dict(m_max=9), dict(spin=1),
    dict(spin=2, fold=True), dict(spin=-2)])
def test_invalid_requests_raise(kwargs):
    with pytest.raises(ValueError):
        repro_torch.make_plan("gl", 8, device="cpu", **kwargs)


def test_spin2_needs_l_max_2():
    with pytest.raises(ValueError, match="l_max >= 2"):
        repro_torch.make_plan("gl", 1, spin=2, device="cpu")


def test_device_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.make_plan("gl", 8, K=1, dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.make_plan("gl", 8, device="cuda")
    plan = repro_torch.make_plan("gl", 8, device="cpu")
    assert plan.device == torch.device("cpu")
    with pytest.raises(ValueError):
        transform.resolve_device("meta")


def test_outputs_live_on_the_plan_device():
    plan = repro_torch.make_plan("gl", 10, K=2, dtype="float32",
                                 mode="cuda_vpu", device="cpu")
    alm = alm_for(plan).astype(np.complex64)
    maps = plan.alm2map(alm)
    assert isinstance(maps, torch.Tensor) and maps.device.type == "cpu"
    assert maps.dtype == torch.float32 and maps.shape == plan._maps_shape
    back = plan.map2alm(maps)
    assert back.dtype == torch.complex64 and back.shape == plan._alm_shape
    assert spectra.d_err(alm, back) < 1e-5


def test_forced_kernel_backend_under_float64_computes_in_float32():
    plan = repro_torch.make_plan("gl", 10, K=1, dtype="float64",
                                 mode="cuda_mxu", device="cpu")
    assert plan.candidates == ["torch", "cuda_mxu"]
    assert "cuda_vpu" in plan.skipped
    alm = alm_for(plan)
    back = plan.map2alm(plan.alm2map(alm))
    assert back.dtype == torch.complex128
    err = spectra.d_err(alm, back)
    assert 1e-12 < err < 1e-5


@pytest.mark.parametrize("mode", ["torch", "cuda_vpu"])
def test_map2alm_iters_on_an_exact_grid(mode):
    dtype = "float64" if mode == "torch" else "float32"
    plan = repro_torch.make_plan("gl", 16, K=2, dtype=dtype, mode=mode,
                                 fold=True, device="cpu")
    alm = alm_for(plan, seed=3)
    maps = plan.alm2map(alm)
    e0 = spectra.d_err(alm, plan.map2alm(maps))
    e1 = spectra.d_err(alm, plan.map2alm(maps, iters=1))
    assert e1 <= 2 * e0 + 1e-7
    assert e0 < (1e-12 if mode == "torch" else 1e-5)


def test_plan_on_a_prebuilt_grid():
    g = grids.gauss_legendre_grid(10, n_rings=14, n_phi=24)
    plan = repro_torch.make_plan(g, device="cpu")
    assert plan.l_max == 13 and plan.grid is g
    plan = repro_torch.make_plan(g, 10, device="cpu")
    alm = alm_for(plan)
    assert spectra.d_err(alm, plan.map2alm(plan.alm2map(alm))) < 1e-12


def test_shape_validation():
    plan = repro_torch.make_plan("gl", 8, K=2, device="cpu")
    with pytest.raises(ValueError, match="plan was built for"):
        plan.alm2map(np.zeros((9, 9, 1), np.complex128))
    with pytest.raises(ValueError, match="plan was built for"):
        plan.map2alm(np.zeros((9, 16, 2)))


def test_backend_eligibility_matches_reference_policy():
    g, rg = grids.make_grid("gl", l_max=8), rgrids.make_grid("gl", l_max=8)
    for dtype in ("float64", "float32"):
        elig = repro_torch.backend_eligibility(g, dtype)
        relig = repro.backend_eligibility(rg, dtype, n_devices=1)
        assert (elig["cuda_vpu"] is None) == (relig["pallas_vpu"] is None)
        assert (elig["cuda_mxu"] is None) == (relig["pallas_mxu"] is None)
        assert elig["torch"] is None and relig["jnp"] is None
    assert repro_torch.available_backends(g, "float64") == ["torch"]
    assert repro_torch.available_backends(g, "float32") == [
        "torch", "cuda_vpu", "cuda_mxu"]


def test_describe_and_report_well_formed():
    plan = repro_torch.make_plan("gl", 12, K=4, dtype="float32",
                                 mode="cuda_mxu", fold=True, device="cpu")
    plan.alm2map(alm_for(plan).astype(np.complex64))
    d = plan.describe()
    sig = d["signature"]
    assert (sig["grid"], sig["l_max"], sig["m_max"], sig["K"], sig["fold"],
            sig["n_rings"], sig["n_phi"]) == ("gl", 12, 12, 4, True, 13, 26)
    assert d["device"] == "cpu" and d["mode"] == "cuda_mxu"
    assert d["backends"] == {"synth": "cuda_mxu", "anal": "cuda_mxu"}
    assert d["phase"]["kind"] == "uniform"
    assert d["memory"]["total_bytes"] == sum(
        v for k, v in d["memory"].items() if k != "total_bytes")
    assert d["memory"]["seed_bytes"] > 0
    assert "seeds" in d["cache"]["events"]
    text = plan.report()
    assert "synth -> cuda_mxu[fused]" in text and "device=cpu" in text
    # only dist is skipped: this process has no group of >= 2 ranks
    assert [line for line in text.splitlines() if "skipped" in line] == [
        f"  skipped dist: {plan.skipped['dist']}"]
    assert d["comm"] == {"spec": "auto",
                         "chunks": {"synth": None, "anal": None},
                         "pipelined": {"synth": False, "anal": False}}


def test_lazy_top_level_api():
    assert repro_torch.make_plan is transform.make_plan
    assert repro_torch.Plan is transform.Plan
    with pytest.raises(AttributeError):
        repro_torch.no_such_thing
