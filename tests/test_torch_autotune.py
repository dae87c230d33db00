"""``make_plan(mode="model" | "auto")``, the characterization store, the
disk tier of the plan cache and the variant override, on the CPU at l_max
<= 32.

``mode="model"`` is held to the reference's ``make_plan(mode="model")``:
same backend (under the name mapping) and layout per direction, same
predicted seconds.  ``mode="auto"`` times the corners here on the CPU (the
plain versions), so its choice is held to its own measurements, not to the
reference's.
"""
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch.core import cache, spectra, transform
from repro_torch.kernels import ops
from repro_torch.roofline import chardb

NAMES = {"jnp": "torch", "pallas_vpu": "cuda_vpu", "pallas_mxu": "cuda_mxu"}

SIGNATURES = [
    (grid, kw, K, spin, fold)
    for grid, kw in (("gl", dict(l_max=16)), ("ecp", dict(l_max=16)),
                     ("healpix", dict(nside=4)))
    for K in (1, 8) for spin in (0, 2) for fold in (False, True)
    if not (spin and fold)]


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Every test starts with no memoised plan, no cached decision and no
    stored corner, and no override in the environment."""
    for var in ("REPRO_TORCH_CACHE_DIR", "REPRO_TORCH_CHARDB_SMOKE",
                "REPRO_TORCH_LEGENDRE_VARIANT"):
        monkeypatch.delenv(var, raising=False)
    transform.clear_plan_cache()
    chardb.clear()
    yield
    transform.clear_plan_cache()
    chardb.clear()


def alm_for(plan, seed=0):
    gen = torch.Generator().manual_seed(seed)
    draw = (repro_torch.core.sht.random_alm if plan.spin == 0
            else repro_torch.core.sht.random_alm_spin)
    return draw(gen, plan.l_max, plan.m_max, plan.K, device="cpu").to(
        torch.complex64)


@pytest.mark.parametrize("grid,kw,K,spin,fold", SIGNATURES)
def test_model_mode_chooses_as_the_reference(grid, kw, K, spin, fold):
    """The cost model's backend and layout per direction are the
    reference's, and so are its predicted seconds of every candidate."""
    plan = repro_torch.make_plan(grid, **kw, K=K, dtype="float32",
                                 mode="model", spin=spin, fold=fold,
                                 device="cpu")
    ref = repro.make_plan(grid, **kw, K=K, dtype="float32", mode="model",
                          spin=spin, fold=fold)
    assert plan.backends == {d: NAMES[b] for d, b in ref.backends.items()}
    assert plan.layouts == ref.layouts
    assert set(plan.predicted_s) == {NAMES[b] for b in ref.predicted_s}
    for rb, rows in ref.predicted_s.items():
        for k, v in rows.items():
            got = plan.predicted_s[NAMES[rb]][k]
            if isinstance(v, str):
                assert got == v
            else:
                assert abs(got - v) <= 1e-12 * abs(v)
    assert plan.measured_s == {}
    d = plan.describe()
    assert d["predicted_s"] == plan.predicted_s and d["mode"] == "model"


def test_modes_refuse_a_layout():
    for mode in ("auto", "model"):
        with pytest.raises(ValueError, match="takes no layout"):
            repro_torch.make_plan("gl", 8, dtype="float32", mode=mode,
                                  layout="plain", device="cpu")
    with pytest.raises(ValueError, match=r"needs >= 2 devices"):
        repro_torch.make_plan("gl", 8, mode="dist", device="cpu")
    with pytest.raises(ValueError, match="unknown cache"):
        repro_torch.make_plan("gl", 8, cache="tape", device="cpu")


@pytest.mark.parametrize("spin", [0, 2])
def test_auto_mode_takes_the_measured_minimum(spin):
    """Every corner is timed once (finite), the choice per direction is the
    backend whose best layout measured least, that layout is the plan's,
    and the chosen plan agrees with the float64 oracle."""
    plan = repro_torch.make_plan("gl", 12, K=2, dtype="float32", mode="auto",
                                 spin=spin, device="cpu")
    ms = plan.measured_s
    assert set(ms) == {"torch", "cuda_vpu", "cuda_mxu"}
    for d in ("synth", "anal"):
        for b in ("cuda_vpu", "cuda_mxu"):
            per = {lay: ms[b][f"{d}_{lay}"] for lay in ("packed", "plain",
                                                        "fused")}
            assert all(np.isfinite(v) for v in per.values())
            assert ms[b][d] == min(per.values())
            assert ms[b][f"{d}_layout"] == min(per, key=per.get)
        best = min(ms, key=lambda b: ms[b][d])
        assert plan.backends[d] == best and np.isfinite(ms[best][d])
        assert plan.layouts[d] == ms[best].get(f"{d}_layout")
    assert plan.cache_events["decision"] == "autotuned"
    assert chardb.stats()["measured"] == 14
    oracle = repro_torch.make_plan("gl", 12, K=2, spin=spin, device="cpu")
    alm = alm_for(plan)
    want = oracle.alm2map(alm.to(torch.complex128))
    got = plan.alm2map(alm)
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())
    assert spectra.d_err(alm, plan.map2alm(got)) < 1e-4
    report = plan.report()
    assert "measured" in report and "predicted" in report


def test_auto_decision_on_disk_measures_nothing_the_second_time(tmp_path):
    """cache="disk": the decision and the corners land in the directory; a
    second build after clear_plan_cache() (and with the in-memory stores
    dropped, as a new process would have them) reads the decision back
    ("hit") and measures no corner."""
    kw = dict(K=2, dtype="float32", mode="auto", cache="disk",
              cache_dir=str(tmp_path), device="cpu")
    first = repro_torch.make_plan("gl", 10, **kw)
    assert first.cache_events["decision"] == "autotuned"
    names = sorted(p.name for p in tmp_path.iterdir())
    assert any(n.startswith("chardb_") for n in names)
    assert sum(n.endswith(".json") for n in names) >= 2
    transform.clear_plan_cache()
    chardb.clear()
    second = repro_torch.make_plan("gl", 10, **kw)
    assert second is not first
    assert second.cache_events["decision"] == "hit"
    assert chardb.stats()["measured"] == 0
    assert second.backends == first.backends
    assert second.layouts == first.layouts
    assert second.describe()["cache"]["disk_hits"] >= 1
    # another cache kind is another plan: the kind is part of the key
    third = repro_torch.make_plan("gl", 10, **dict(kw, cache="memory",
                                                   cache_dir=None))
    assert third is not second
    assert cache.clear_disk(str(tmp_path)) == len(names)


def test_stale_schema_is_measured_again(monkeypatch):
    """Corners stored under an older SCHEMA are stale: a later build (its
    decision no longer cached) measures them again."""
    repro_torch.make_plan("gl", 8, dtype="float32", mode="auto",
                          device="cpu")
    assert chardb.stats()["measured"] == 14
    transform.clear_plan_cache()
    chardb.reset_stats()
    repro_torch.make_plan("gl", 8, dtype="float32", mode="auto",
                          device="cpu")
    st = chardb.stats()
    assert st["measured"] == 0 and st["reused"] == 14
    transform.clear_plan_cache()
    chardb.reset_stats()
    monkeypatch.setattr(chardb, "SCHEMA", chardb.SCHEMA + 1)
    repro_torch.make_plan("gl", 8, dtype="float32", mode="auto",
                          device="cpu")
    st = chardb.stats()
    assert st["stale"] == 14 and st["measured"] == 14


def test_smoke_mode_times_nothing_and_falls_back_to_the_model(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CHARDB_SMOKE", "1")
    plan = repro_torch.make_plan("gl", 8, K=8, dtype="float32", mode="auto",
                                 device="cpu")
    model = repro_torch.make_plan("gl", 8, K=8, dtype="float32",
                                  mode="model", device="cpu")
    assert chardb.stats()["measured"] == 0
    assert chardb.stats()["skipped"] == 14
    assert plan.cache_events["decision"] == "model-fallback"
    assert plan.backends == model.backends
    assert plan.layouts == model.layouts


def test_a_corner_that_raises_propagates(monkeypatch):
    """A corner whose kernel raises is not ranked last: the error reaches
    the caller, and nothing of it is stored."""
    def broken(self, fn, arg):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(transform.Plan, "_timed_us", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        repro_torch.make_plan("gl", 8, dtype="float32", mode="auto",
                              device="cpu")
    assert chardb.stats()["corners"] == 0


def mixed(plan, synth, anal, backend="cuda_mxu"):
    """A measured table that makes ``backend`` fastest in both directions,
    on layout ``synth`` for the synthesis and ``anal`` for the analysis."""
    slow = {"synth": 1.0, "anal": 1.0}
    out = {b: dict(slow) for b in plan.candidates}
    out[backend] = {"synth": 1e-3, "synth_layout": synth,
                    "anal": 1e-3, "anal_layout": anal}
    return out


@pytest.mark.parametrize("synth,anal", [("fused", "plain"),
                                        ("plain", "packed")])
def test_directions_on_different_layouts(synth, anal, monkeypatch):
    """A plan whose directions run different layouts (the measured choice
    can give one) round-trips, its map2alm(iters=1) refines, and both
    directions pass torch.autograd.gradcheck (linear maps in float32:
    central differences of step 1e-2 against the adjoint kernels, on
    random projections: ``fast_mode``)."""
    monkeypatch.setattr(transform.Plan, "_measure_all",
                        lambda self: mixed(self, synth, anal))
    plan = repro_torch.make_plan("gl", 8, K=2, dtype="float32", mode="auto",
                                 device="cpu")
    assert plan.layouts == {"synth": synth, "anal": anal}
    assert plan.backends == {"synth": "cuda_mxu", "anal": "cuda_mxu"}
    alm = alm_for(plan)
    assert spectra.d_err(alm, plan.map2alm(plan.alm2map(alm))) < 1e-5
    maps = plan.alm2map(alm)
    assert spectra.d_err(alm, plan.map2alm(maps, iters=1)) < 1e-5
    staged = repro_torch.make_plan("gl", 8, K=2, dtype="float32",
                                   mode="cuda_mxu", layout=anal,
                                   device="cpu")
    assert float((plan.map2alm(maps) - staged.map2alm(maps)).abs().max()) \
        < 1e-5
    a = alm.detach().clone().requires_grad_(True)
    check = dict(eps=1e-2, atol=1e-3, rtol=1e-2, fast_mode=True)
    assert torch.autograd.gradcheck(plan.alm2map, (a,), **check)
    m = maps.detach().clone().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda v: plan.map2alm(v, iters=1),
                                    (m,), **check)


def test_pick_variant_override(monkeypatch):
    """The explicit argument, then $REPRO_TORCH_LEGENDRE_VARIANT, then the
    static rule; an unknown name in the environment is ignored."""
    assert ops.pick_variant(2) == "vpu" and ops.pick_variant(16) == "mxu"
    monkeypatch.setenv("REPRO_TORCH_LEGENDRE_VARIANT", "mxu")
    assert ops.pick_variant(2) == "mxu"
    assert ops.pick_variant(2, "vpu") == "vpu"
    monkeypatch.setenv("REPRO_TORCH_LEGENDRE_VARIANT", "vpu")
    assert ops.pick_variant(16) == "vpu"
    monkeypatch.setenv("REPRO_TORCH_LEGENDRE_VARIANT", "tpu")
    assert ops.pick_variant(16) == "mxu"
    with pytest.raises(ValueError, match="variant"):
        ops.pick_variant(2, "tpu")


def test_the_default_plan_takes_the_variant_override(monkeypatch):
    """The override reaches the default plan (no backend named), and an
    explicit backend outranks it."""
    monkeypatch.setenv("REPRO_TORCH_LEGENDRE_VARIANT", "vpu")
    plan = repro_torch.make_plan("gl", 8, K=8, dtype="float32",
                                 device="cpu")
    assert plan.backends == {"synth": "cuda_vpu", "anal": "cuda_vpu"}
    forced = repro_torch.make_plan("gl", 8, K=8, dtype="float32",
                                   mode="cuda_mxu", device="cpu")
    assert forced.backends == {"synth": "cuda_mxu", "anal": "cuda_mxu"}


def test_pick_layout_takes_the_layout_named():
    """The staged wrappers run the layout named (no environment override),
    and refuse "fused", which dispatches at the plan level."""
    assert ops.pick_layout("plain") == "plain"
    assert ops.pick_layout("packed") == "packed"
    for bad in ("fused", "slots"):
        with pytest.raises(ValueError, match=bad):
            ops.pick_layout(bad)


def test_a_decision_holds_for_its_hardware_only(tmp_path, monkeypatch):
    """The decision on disk is keyed by the hardware fingerprint and the
    store's SCHEMA as its corners are: under another fingerprint, or after
    a SCHEMA bump, the next build measures again instead of reading the
    old choice."""
    kw = dict(dtype="float32", mode="auto", cache="disk",
              cache_dir=str(tmp_path), device="cpu")
    repro_torch.make_plan("gl", 8, **kw)
    transform.clear_plan_cache()
    again = repro_torch.make_plan("gl", 8, **kw)
    assert again.cache_events["decision"] == "hit"
    transform.clear_plan_cache()
    monkeypatch.setattr(chardb, "hardware_fingerprint",
                        lambda device=None: ("0" * 16, "another card"))
    other = repro_torch.make_plan("gl", 8, **kw)
    assert other.cache_events["decision"] == "autotuned"
    transform.clear_plan_cache()
    monkeypatch.undo()
    monkeypatch.setattr(chardb, "SCHEMA", chardb.SCHEMA + 1)
    bumped = repro_torch.make_plan("gl", 8, **kw)
    assert bumped.cache_events["decision"] == "autotuned"


def test_the_store_is_written_once_a_sweep(tmp_path, monkeypatch):
    """A disk store is written once after the sweep of 14 corners, through
    the cache's atomic write, and leaves no temporary file."""
    writes = []
    real = cache._atomic_write

    def counted(path, write_fn):
        writes.append(path)
        real(path, write_fn)

    monkeypatch.setattr(cache, "_atomic_write", counted)
    repro_torch.make_plan("gl", 8, dtype="float32", mode="auto",
                          cache="disk", cache_dir=str(tmp_path),
                          device="cpu")
    assert chardb.stats()["measured"] == 14
    assert sum("chardb_" in p for p in writes) == 1
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".tmp"]


def test_a_corner_is_the_median_of_its_timed_calls(monkeypatch):
    """A fast corner is timed 3 to 9 times after a warm-up and the median
    kept; a corner slower than the span is timed once."""
    plan = repro_torch.make_plan("gl", 8, dtype="float32", mode="cuda_vpu",
                                 device="cpu")
    spans = [1e-3, 2e-3, 5e-3, 1e-3] + [3e-3] * 20
    ticks = [v for i, d in enumerate(spans) for v in (float(i), i + d)]
    clock = iter(ticks)
    monkeypatch.setattr(transform.time, "perf_counter", lambda: next(clock))
    calls = []
    us = plan._timed_us(calls.append, "x")
    # warm-up, then 1 ms first -> ceil(50 / 1) capped at 9 timed calls:
    # 1, 2, 5, 1, 3, 3, 3, 3, 3 ms, median 3 ms
    assert len(calls) == 10
    assert us == pytest.approx(3000.0, rel=1e-6)
    clock = iter([0.0, 0.2])
    monkeypatch.setattr(transform.time, "perf_counter", lambda: next(clock))
    calls.clear()
    assert plan._timed_us(calls.append, "x") == pytest.approx(2e5)
    assert len(calls) == 2
