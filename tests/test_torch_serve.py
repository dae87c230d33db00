"""The port's serving engine (``repro_torch.serve``) on the CPU.

Three parts.  The reference's serving tests (``tests/test_serve.py`` and
the serving half of ``tests/test_fault.py``) ported onto the port's engine
at ``device="cpu"``, ``mode="torch"`` (the float64 oracle; inputs drawn
with numpy): K-coalescing, grouping, FIFO, futures, percentiles, the warm
pool, the double-buffered threads, WDRR, admission and fault containment.
The torch float64 path gives per-channel results independent of K bit for
bit, so the reference's bit-equality assertions stay bit equality.  Then
the same scripted traffic through the reference's engine and the port's,
and the admission verdicts of both.  Last, the port's own pieces:
``drop_plan``, ``Plan.warmup``, a plan run from two threads at once, the
float32 kernel backends through the engine, and the CLI.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro
import repro.serve
from repro.roofline import admission as radmission
from repro.roofline import analysis as ranalysis
import repro_torch
from repro_torch.core import cache as plancache
from repro_torch.core import spectra, transform
from repro_torch.kernels import ops
from repro_torch.launch.serve import random_alm
from repro_torch.roofline import admission
from repro_torch.roofline.analysis import HW_HOST
from repro_torch.serve import (BackpressureError, InvalidStateError, PlanPool,
                               PlanSig, ShtEngine, ShtFuture, ShtRequest,
                               ShtTimeoutError, percentile)

from _hypothesis_compat import given, settings, strategies as st

LMAX = 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_caches():
    transform.clear_plan_cache()
    plancache.reset_stats()
    yield
    transform.clear_plan_cache()
    plancache.reset_stats()


def _alm(seed, l_max=LMAX, K=None, spin=0):
    """Numpy alm from ``seed`` (the CLI's draw), with a trailing K axis when
    ``K`` is given."""
    rng = np.random.default_rng(seed)
    a = np.stack([random_alm(rng, l_max, spin) for _ in range(K or 1)], -1)
    return a if K else a[..., 0]


def _engine(**kw):
    kw.setdefault("max_k", 4)
    kw.setdefault("mode", "torch")
    kw.setdefault("device", "cpu")
    return ShtEngine(**kw)


def _plan(l_max=LMAX, K=1, **kw):
    kw.setdefault("mode", "torch")
    return repro_torch.make_plan("gl", l_max=l_max, K=K, dtype="float64",
                                 device="cpu", **kw)


def _synth(plan, alm):
    """One K=1 request's maps through ``plan`` (numpy in and out)."""
    return plan.alm2map(alm[..., None]).numpy()[..., 0]


# -- coalescing correctness ---------------------------------------------------


def test_coalesced_batch_matches_independent_plan_calls():
    """A K-stacked batch of mixed requests returns results identical to
    per-request Plan calls (synthesis bitwise on the f64 torch path;
    analysis to 1e-12)."""
    eng = _engine(max_k=4)
    plan = _plan()
    alms = [_alm(seed=i) for i in range(3)]
    maps = [_synth(plan, a) for a in alms]

    futs_s = [eng.submit(direction="alm2map", payload=a, grid="gl",
                         l_max=LMAX) for a in alms]
    futs_a = [eng.submit(direction="map2alm", payload=m, grid="gl",
                         l_max=LMAX) for m in maps]
    eng.drain()

    for f, ref in zip(futs_s, maps):
        np.testing.assert_array_equal(f.result(), ref)     # bit-identical
    for f, m in zip(futs_a, maps):
        ref = plan.map2alm(m[..., None]).numpy()[..., 0]
        assert np.max(np.abs(f.result() - ref)) < 1e-12
    # the synthesis requests actually shared one device batch
    synth_batches = [b for b in eng.batch_log
                     if b["direction"] == "alm2map"]
    assert len(synth_batches) == 1
    assert synth_batches[0]["n_requests"] == 3


def test_coalesced_multi_k_and_spin2_requests():
    """Requests carrying their own K axis, and spin-2 (E,B)->(Q,U) pairs,
    coalesce and come back allclose to independent plans (f64 <= 1e-12)."""
    eng = _engine(max_k=8)
    a2 = _alm(seed=0, K=2)                       # (M, L, 2)
    a1 = _alm(seed=1)                            # (M, L)
    s2 = _alm(seed=2, spin=2)                    # (2, M, L)
    f2 = eng.submit(direction="alm2map", payload=a2, grid="gl", l_max=LMAX)
    f1 = eng.submit(direction="alm2map", payload=a1, grid="gl", l_max=LMAX)
    fs = eng.submit(direction="alm2map", payload=s2, grid="gl", l_max=LMAX,
                    spin=2)
    eng.drain()

    p2, p1, ps = _plan(K=2), _plan(), _plan(spin=2)
    assert np.max(np.abs(f2.result() - p2.alm2map(a2).numpy())) < 1e-12
    assert np.max(np.abs(f1.result() - _synth(p1, a1))) < 1e-12
    assert np.max(np.abs(fs.result() - _synth(ps, s2))) < 1e-12
    # scalar requests coalesced (K=2 + K=1 -> one batch); spin-2 separate
    scalar = [b for b in eng.batch_log if "spin0" in b["signature"]]
    assert len(scalar) == 1 and scalar[0]["k_total"] == 3
    assert scalar[0]["k_plan"] == 4              # padded to the K bucket


def test_no_cross_signature_mixing():
    """Different (grid, l_max, spin, dtype) signatures never share a
    device batch, even when submitted interleaved."""
    eng = _engine(max_k=8)
    for i in range(3):
        eng.submit(direction="alm2map", payload=_alm(seed=i), grid="gl",
                   l_max=LMAX)
        eng.submit(direction="alm2map", payload=_alm(seed=10 + i, l_max=24),
                   grid="gl", l_max=24)
    eng.drain()
    assert len(eng.batch_log) == 2
    for b in eng.batch_log:
        assert b["n_requests"] == 3              # each group fully coalesced
    assert {b["signature"] for b in eng.batch_log} == \
        {"gl/lmax16/spin0/float64", "gl/lmax24/spin0/float64"}


def test_direction_and_iters_split_groups():
    """alm2map vs map2alm, and differing Jacobi iters, are separate
    groups -- they cannot share one device call."""
    eng = _engine(max_k=8)
    m = _synth(_plan(), _alm(seed=0))
    eng.submit(direction="alm2map", payload=_alm(seed=1), grid="gl",
               l_max=LMAX)
    eng.submit(direction="map2alm", payload=m, grid="gl", l_max=LMAX)
    eng.submit(direction="map2alm", payload=m, grid="gl", l_max=LMAX,
               iters=1)
    eng.drain()
    assert len(eng.batch_log) == 3


def test_fifo_within_signature():
    """Requests of one signature retire in submission order, across
    however many micro-batches the max_k budget forces."""
    eng = _engine(max_k=2)
    futs = [eng.submit(direction="alm2map", payload=_alm(seed=i), grid="gl",
                       l_max=LMAX) for i in range(5)]
    eng.drain()
    rids = [rid for b in eng.batch_log for rid in b["rids"]]
    assert rids == [f.rid for f in futs]         # strict FIFO
    assert [b["n_requests"] for b in eng.batch_log] == [2, 2, 1]


def test_oldest_request_picks_next_group():
    """Across signatures the batch former serves the group whose head
    waited longest (no starvation of a low-traffic signature)."""
    eng = _engine(max_k=8)
    f_old = eng.submit(direction="alm2map", payload=_alm(seed=0, l_max=24),
                       grid="gl", l_max=24)
    for i in range(3):
        eng.submit(direction="alm2map", payload=_alm(seed=1 + i), grid="gl",
                   l_max=LMAX)
    assert eng.step() > 0
    assert f_old.done()                          # oldest head went first


# -- futures ------------------------------------------------------------------


def test_futures_resolve_exactly_once():
    eng = _engine()
    fut = eng.submit(direction="alm2map", payload=_alm(seed=0), grid="gl",
                     l_max=LMAX)
    eng.drain()
    assert fut.done()
    r1 = fut.result()
    assert r1 is fut.result()                    # cached, not recomputed
    with pytest.raises(InvalidStateError):
        fut._resolve(None)
    with pytest.raises(InvalidStateError):
        fut._fail(RuntimeError("x"))
    f = ShtFuture(rid=99)
    f._resolve(1)
    with pytest.raises(InvalidStateError):
        f._resolve(2)


def test_future_timing_populated():
    eng = _engine()
    fut = eng.submit(direction="alm2map", payload=_alm(seed=0), grid="gl",
                     l_max=LMAX)
    eng.drain()
    t = fut.timing
    assert t["total_s"] >= t["compute_s"] >= 0
    assert t["queue_s"] >= 0
    assert t["k_plan"] == 1 and t["coalesced_with"] == 0


def test_submit_validation_is_eager():
    eng = _engine()
    with pytest.raises(ValueError):              # bad direction
        eng.submit(direction="sideways", payload=_alm(seed=0))
    with pytest.raises(ValueError):              # real payload for alm2map
        eng.submit(direction="alm2map", payload=np.zeros((17, 17)))
    with pytest.raises(ValueError):              # complex maps payload
        eng.submit(direction="map2alm",
                   payload=np.zeros((17, 34), complex))
    with pytest.raises(ValueError):              # ndim mismatch for spin
        eng.submit(direction="alm2map", payload=_alm(seed=0), spin=2)
    with pytest.raises(ValueError):              # K wider than the engine
        eng.submit(direction="alm2map", payload=_alm(seed=0, K=9),
                   grid="gl", l_max=LMAX)
    assert eng.pending == 0                      # nothing leaked into queue


# -- stats() ------------------------------------------------------------------


def test_percentile_pinned_against_numpy():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 10, 101):
        xs = rng.exponential(size=n).tolist()
        for q in (0.0, 25.0, 50.0, 90.0, 95.0, 99.0, 100.0):
            np.testing.assert_allclose(percentile(xs, q),
                                       np.percentile(xs, q), rtol=1e-12)
    assert np.isnan(percentile([], 50.0))


def test_stats_shape_and_counters():
    eng = _engine(max_k=4)
    for i in range(4):
        eng.submit(direction="alm2map", payload=_alm(seed=i), grid="gl",
                   l_max=LMAX)
    eng.drain()
    s = eng.stats()
    assert s["requests"]["submitted"] == 4
    assert s["requests"]["completed"] == 4
    assert s["requests"]["pending"] == 0
    assert s["coalescing"]["batches"] == 1
    assert s["coalescing"]["k_per_batch"] == 4.0
    assert s["coalescing"]["k_occupancy"] == 1.0
    lat = s["latency"]["total"]
    assert lat["count"] == 4
    assert lat["p50_s"] <= lat["p95_s"] <= lat["p99_s"] <= lat["max_s"]
    assert np.isfinite(s["throughput_rps"]) and s["throughput_rps"] > 0
    assert s["warm_failures"] == []
    r = eng.report()
    assert "p99" in r and "coalescing" in r and "pool" in r


def test_stats_percentiles_match_numpy_over_recorded_latencies():
    eng = _engine(max_k=1)                       # one batch per request
    for i in range(5):
        eng.submit(direction="alm2map", payload=_alm(seed=i), grid="gl",
                   l_max=LMAX)
    eng.drain()
    xs = eng._lat_total.samples()
    assert len(xs) == 5
    s = eng.stats()["latency"]["total"]
    np.testing.assert_allclose(s["p50_s"], np.percentile(xs, 50))
    np.testing.assert_allclose(s["p95_s"], np.percentile(xs, 95))
    np.testing.assert_allclose(s["p99_s"], np.percentile(xs, 99))


# -- warm plan pool -----------------------------------------------------------


def test_pool_hits_and_warmup():
    eng = _engine(max_k=2)
    eng.prewarm(grid="gl", l_max=LMAX, dtype="float64")
    assert eng.pool.stats()["warmups"] == 1
    for i in range(4):
        eng.submit(direction="alm2map", payload=_alm(seed=i), grid="gl",
                   l_max=LMAX)
    eng.drain()
    p = eng.pool.stats()
    # prewarm built the (sig, max_k=2) plan; both batches then hit it
    assert p["misses"] == 1 and p["hits"] == 2
    assert eng.stats()["pool"]["hit_rate"] == pytest.approx(2 / 3)
    # fused-pipeline coverage of the warm set: the gl plan is eligible; the
    # float64 static rule runs the torch oracle, which takes no layout
    f = p["fusion"]
    assert f["eligible"] == 1 and f["staged"] == 0
    assert f["active"] == 0


def test_pool_lru_eviction_releases_plans():
    pool = PlanPool(capacity=2, mode="torch", device="cpu")
    sigs = [PlanSig(grid="gl", l_max=8 * (i + 1), dtype="float64")
            for i in range(3)]
    plans = [pool.get(s, 1) for s in sigs]
    assert pool.stats()["evictions"] == 1
    assert len(pool) == 2
    # the evicted plan is also gone from make_plan's memoisation...
    key0 = plans[0]._signature_key
    assert key0 not in transform._PLANS
    # ...while the survivors are still memoised
    assert plans[2]._signature_key in transform._PLANS
    # re-requesting the evicted signature rebuilds (a miss, not a hit)
    misses = pool.stats()["misses"]
    pool.get(sigs[0], 1)
    assert pool.stats()["misses"] == misses + 1


def test_background_thread_serves():
    eng = _engine(max_k=4)
    with eng:
        futs = [eng.submit(direction="alm2map", payload=_alm(seed=i),
                           grid="gl", l_max=LMAX) for i in range(3)]
        res = [f.result(timeout=120) for f in futs]
    plan = _plan()
    for a, r in zip([_alm(seed=i) for i in range(3)], res):
        assert np.max(np.abs(r - _synth(plan, a))) < 1e-12


# -- property: random interleavings never drop/duplicate/cross-wire ----------


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 10 ** 6), n_sigs=st.integers(2, 4),
       max_k=st.integers(1, 6))
def test_random_interleavings_roundtrip(seed, n_sigs, max_k):
    """Random submit interleavings across 2-4 signatures with request K in
    1..max_k: every future resolves exactly once with *its own* payload's
    transform (seeded alm per request; any cross-wiring, drop or
    duplication shows up as a wrong result or an unresolved future)."""
    rng = np.random.default_rng(seed)
    transform.clear_plan_cache()
    eng = _engine(max_k=max_k, max_queue=256)
    lmaxes = [8, 12, 16, 20][:n_sigs]
    plans = {L: _plan(l_max=L) for L in lmaxes}
    jobs = []
    for rid in range(12):
        L = int(rng.choice(lmaxes))
        # the engine clamps max_k to a power of two; submits above the
        # effective cap are rejected, so draw against eng.max_k
        k = int(rng.integers(1, eng.max_k + 1))
        alm = _alm(seed=1000 + rid, l_max=L, K=k)
        if rng.integers(2) == 0:
            fut = eng.submit(direction="alm2map", payload=alm, grid="gl",
                             l_max=L)
            jobs.append(("alm2map", L, alm, fut))
        else:
            maps = plans[L].alm2map(alm[..., :1]).numpy()
            fut = eng.submit(direction="map2alm", payload=maps[..., 0],
                             grid="gl", l_max=L)
            jobs.append(("map2alm", L, alm[..., :1], fut))
        if rng.integers(3) == 0:                 # interleave partial drains
            eng.step()
    eng.drain()
    for direction, L, alm, fut in jobs:
        assert fut.done(), "request dropped"
        got = fut.result()
        if direction == "alm2map":
            ref = _plan(l_max=L, K=alm.shape[-1]).alm2map(alm).numpy()
            assert np.max(np.abs(got - ref)) < 1e-12
        else:
            # recovery: analysing the synthesised map returns the payload
            err = spectra.d_err(torch.as_tensor(alm[..., 0]),
                                torch.as_tensor(got))
            assert err < 1e-10, err
    s = eng.stats()["requests"]
    assert s["completed"] == len(jobs) and s["pending"] == 0


# -- request object API -------------------------------------------------------


def test_submit_request_object_and_tag():
    eng = _engine()
    req = ShtRequest(direction="alm2map", payload=_alm(seed=0), grid="gl",
                     l_max=LMAX, tag="mc-chain-7")
    fut = eng.submit(req)
    with pytest.raises(TypeError):               # object XOR keywords
        eng.submit(req, grid="gl")
    eng.drain()
    assert fut.done() and req.tag == "mc-chain-7"


# -- K buckets, in-flight accounting, double buffering ------------------------


class _StallPlan:
    """Proxy around a real plan whose synthesis blocks until released --
    makes the 'popped but not retired' in-flight window observable."""

    def __init__(self, plan, started, release):
        self._plan = plan
        self._started = started
        self._release = release

    def __getattr__(self, name):
        return getattr(self._plan, name)

    def alm2map(self, x):
        self._started.set()
        assert self._release.wait(30.0), "test forgot to release the batch"
        return self._plan.alm2map(x)


def _stall_pool(eng):
    """Wrap eng.pool.get so every served plan stalls in alm2map; returns
    the (started, release) events."""
    started, release = threading.Event(), threading.Event()
    real_get = eng.pool.get
    eng.pool.get = lambda sig, k: _StallPlan(real_get(sig, k), started,
                                             release)
    return started, release


def test_max_k_clamped_to_power_of_two_and_bucket_invariants():
    """K buckets are power-of-two by contract: the engine clamps max_k to
    a power of two and every bucket is an admissible plan width."""
    eng = _engine(max_k=6)
    assert eng.max_k == 4 and eng.requested_max_k == 6
    for req_max in (1, 2, 3, 4, 5, 6, 7, 8, 12, 16):
        e = _engine(max_k=req_max)
        assert e.max_k & (e.max_k - 1) == 0          # power of two
        assert e.max_k <= req_max < 2 * e.max_k      # largest such
        for k in range(1, e.max_k + 1):
            b = e._k_bucket(k)
            assert b & (b - 1) == 0, (req_max, k, b)
            assert k <= b <= e.max_k
    # a request wider than the *effective* cap is rejected eagerly
    with pytest.raises(ValueError, match="max_k"):
        eng.submit(direction="alm2map", payload=_alm(seed=0, K=5),
                   grid="gl", l_max=LMAX)


def test_drain_waits_for_in_flight_batch():
    """With the background threads running, drain() returns only after a
    popped micro-batch has executed, not when the queue is empty."""
    eng = _engine(max_k=2)
    started, release = _stall_pool(eng)
    with eng:
        fut = eng.submit(direction="alm2map", payload=_alm(seed=0),
                         grid="gl", l_max=LMAX)
        assert started.wait(30.0)                # popped, mid-execution
        assert eng.pending == 1                  # in-flight, not queued
        t = threading.Timer(0.05, release.set)
        t.start()
        eng.drain(timeout=30.0)
        assert fut.done(), "drain() returned with the batch in flight"
        t.join()
    assert fut.exception() is None
    assert fut.timing["compute_s"] > 0.0


def test_backpressure_counts_in_flight():
    """max_queue bounds engine *occupancy*: a request executing on the
    background threads still holds its slot, so submit() past the bound
    raises BackpressureError even though the queue proper is empty."""
    eng = _engine(max_k=1, max_queue=1)
    started, release = _stall_pool(eng)
    with eng:
        fut = eng.submit(direction="alm2map", payload=_alm(seed=0),
                         grid="gl", l_max=LMAX)
        assert started.wait(30.0)
        s = eng.stats()["requests"]
        assert s["queued"] == 0 and s["in_flight"] == 1 and s["pending"] == 1
        with pytest.raises(BackpressureError):
            eng.submit(direction="alm2map", payload=_alm(seed=1),
                       grid="gl", l_max=LMAX)
        release.set()
        eng.drain(timeout=30.0)
    assert fut.done() and fut.exception() is None
    late = eng.submit(direction="alm2map", payload=_alm(seed=2), grid="gl",
                      l_max=LMAX)                # slot freed by retirement
    eng.drain()
    assert late.exception() is None


# -- WDRR fairness ------------------------------------------------------------


def test_wdrr_minority_group_not_starved():
    """10+:1 hot:minority mix: WDRR visits groups round-robin, so the
    minority signature's batch ships within the first scheduling rounds."""
    eng = _engine(max_k=2)
    hot = [eng.submit(direction="alm2map", payload=_alm(seed=i, l_max=8),
                      grid="gl", l_max=8) for i in range(12)]
    mino = eng.submit(direction="alm2map", payload=_alm(seed=99, l_max=12),
                      grid="gl", l_max=12)
    eng.drain()
    assert mino.exception() is None
    assert all(f.exception() is None for f in hot)
    mino_batches = [i for i, b in enumerate(eng.batch_log)
                    if "lmax12" in b["signature"]]
    assert mino_batches and mino_batches[0] <= 2, eng.batch_log


def test_wdrr_weight_throttles_group():
    """A weight-1/4 group earns a quarter of the K-unit deficit per round
    and must wait out extra rounds between its batches -- so the unit-
    weight group finishes well before the throttled hot group."""
    hot_label = "gl/lmax8/spin0/float64"
    eng = _engine(max_k=2, weights={hot_label: 0.25})
    assert eng.describe()["fairness"]["weights"][hot_label] == 0.25
    hot = [eng.submit(direction="alm2map", payload=_alm(seed=i, l_max=8),
                      grid="gl", l_max=8) for i in range(4)]
    mino = [eng.submit(direction="alm2map", payload=_alm(seed=50 + i,
                                                         l_max=12),
                       grid="gl", l_max=12) for i in range(4)]
    eng.drain()
    assert all(f.exception() is None for f in hot + mino)
    log = eng.batch_log
    last_mino = max(i for i, b in enumerate(log)
                    if "lmax12" in b["signature"])
    hot_before = sum(b["n_requests"] for b in log[:last_mino]
                     if "lmax8" in b["signature"])
    # by the time the minority stream finishes, the throttled hot group
    # has shipped at most half its backlog
    assert hot_before <= 2, log
    assert eng.stats()["fairness"]["policy"] == "wdrr"


# -- roofline admission control -----------------------------------------------


def test_admission_tiny_target_caps_coalescing_at_k1():
    """An unachievable p99 target (1 ns) caps every batch at K=1 and
    flags the group infeasible -- service degrades to singles, never to
    refusal."""
    eng = _engine(max_k=4, p99_target_s=1e-9)
    futs = [eng.submit(direction="alm2map", payload=_alm(seed=i),
                       grid="gl", l_max=LMAX) for i in range(4)]
    eng.drain()
    assert all(f.exception() is None for f in futs)
    assert [b["k_plan"] for b in eng.batch_log] == [1, 1, 1, 1]
    adm = eng.stats()["admission"]
    assert adm["p99_target_s"] == 1e-9
    (group,) = adm["groups"].values()
    assert group["k_cap"] == 1 and group["feasible"] is False


def test_admission_generous_target_keeps_full_bucket_and_calibrates():
    """A 60 s p99 target admits the full max_k bucket, and every executed
    batch feeds the predicted-vs-measured calibration tracker."""
    eng = _engine(max_k=4, p99_target_s=60.0)
    futs = [eng.submit(direction="alm2map", payload=_alm(seed=i),
                       grid="gl", l_max=LMAX) for i in range(4)]
    eng.drain()
    assert all(f.exception() is None for f in futs)
    assert len(eng.batch_log) == 1 and eng.batch_log[0]["k_plan"] == 4
    adm = eng.stats()["admission"]
    (group,) = adm["groups"].values()
    assert group["k_cap"] == 4 and group["feasible"] is True
    cal = adm["calibration"]
    assert cal["count"] == 1
    assert np.isfinite(cal["ratio"]) and cal["ratio"] > 0.0
    assert "admission" in eng.report()


def test_engine_describe():
    eng = _engine(max_k=6, p99_target_s=0.5,
                  weights={"gl/lmax16/spin0/float64": 0.5})
    d = eng.describe()
    assert d["max_k"] == 4 and d["requested_max_k"] == 6
    assert d["states"] == ("queued", "in_flight", "retired")
    assert d["fairness"]["policy"] == "wdrr" and d["fairness"]["quantum_k"]
    assert d["admission"]["p99_target_s"] == 0.5
    assert d["pipeline"]["double_buffered"] is False
    assert d["pool"]["capacity"] == eng.pool.capacity
    assert d["pool"]["device"] == "cpu"
    with eng:
        d2 = eng.describe()
        assert d2["pipeline"]["double_buffered"] is True
        assert len(d2["pipeline"]["threads"]) == 2
    # admission verdicts appear per group after first sighting
    eng.submit(direction="alm2map", payload=_alm(seed=0), grid="gl",
               l_max=LMAX)
    eng.drain()
    (group,) = eng.describe()["admission"]["groups"].values()
    assert set(group) >= {"k_cap", "feasible", "predicted_s"}
    assert group["backend"] == "torch"


def test_pool_concurrent_get_builds_once():
    """Racing get() calls for one key build the plan exactly once (the
    build happens outside the pool lock behind a per-key event)."""
    pool = PlanPool(4, mode="torch", device="cpu")
    out, errs = [], []

    def worker():
        try:
            out.append(pool.get(PlanSig(grid="gl", l_max=8), 2))
        except Exception as e:                    # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
        assert not t.is_alive()
    assert not errs
    assert len(out) == 4 and len({id(p) for p in out}) == 1
    assert pool.misses == 1


# -- threaded clients, exactly-once resolution --------------------------------


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 10 ** 6))
def test_threaded_submissions_resolve_exactly_once(seed):
    """Several client threads submit mixed signatures against the live
    double-buffered engine; every future resolves exactly once with its
    own request's transform, and the in-flight accounting lands at zero."""
    transform.clear_plan_cache()
    lmaxes = [8, 12]
    refs = {L: _plan(l_max=L) for L in lmaxes}
    eng = _engine(max_k=4, max_queue=256)
    jobs, jlock = [], threading.Lock()

    def client(tid):
        rng = np.random.default_rng(seed * 17 + tid)
        for i in range(6):
            L = int(rng.choice(lmaxes))
            alm = _alm(seed=seed % 1000 + tid * 100 + i, l_max=L)
            fut = eng.submit(direction="alm2map", payload=alm, grid="gl",
                             l_max=L)
            with jlock:
                jobs.append((L, alm, fut))
            if rng.integers(2):
                time.sleep(0.001)

    with eng:
        clients = [threading.Thread(target=client, args=(t,))
                   for t in range(3)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(60.0)
            assert not t.is_alive()
        eng.drain(timeout=120.0)

    assert len(jobs) == 18
    for L, alm, fut in jobs:
        assert fut.done(), "request dropped"
        np.testing.assert_array_equal(fut.result(), _synth(refs[L], alm))
    s = eng.stats()["requests"]
    assert s["completed"] == 18 and s["pending"] == 0
    assert s["queued"] == 0 and s["in_flight"] == 0
    with pytest.raises(InvalidStateError):       # write-once enforced
        jobs[0][2]._resolve(None)


# -- fault containment (the reference's tests/test_fault.py) -----------------


def _serve_alm(seed, l_max=12):
    return _alm(seed=seed, l_max=l_max)


def test_serve_queue_overflow_backpressure():
    """A full queue refuses new work with a BackpressureError instead of
    growing without bound; draining reopens it."""
    eng = _engine(max_k=2, max_queue=3)
    futs = [eng.submit(direction="alm2map", payload=_serve_alm(i),
                       grid="gl", l_max=12) for i in range(3)]
    with pytest.raises(BackpressureError):
        eng.submit(direction="alm2map", payload=_serve_alm(9), grid="gl",
                   l_max=12)
    assert eng.stats()["requests"]["submitted"] == 3    # rejected != queued
    eng.drain()
    assert all(f.done() for f in futs)
    late = eng.submit(direction="alm2map", payload=_serve_alm(4), grid="gl",
                      l_max=12)                         # accepted again
    eng.drain()
    assert late.done() and late.exception() is None


def test_serve_invalid_signature_fails_only_its_future():
    """A request whose signature cannot build a plan (unknown grid) fails
    its own future; the engine keeps serving later requests."""
    eng = _engine(max_k=2)
    bad = eng.submit(direction="alm2map",
                     payload=np.zeros((13, 13), complex),
                     grid="klein_bottle", l_max=12)
    good = eng.submit(direction="alm2map", payload=_serve_alm(0), grid="gl",
                      l_max=12)
    eng.drain()
    assert isinstance(bad.exception(), Exception)
    with pytest.raises(Exception):
        bad.result()
    assert good.exception() is None and good.result().shape == (13, 26)
    s = eng.stats()["requests"]
    assert s["failed"] == 1 and s["completed"] == 1


def test_serve_mismatched_payload_does_not_poison_batch():
    """A payload that lies about its signature fails alone -- the
    requests coalesced with it still complete."""
    eng = _engine(max_k=4)
    liar = eng.submit(direction="alm2map",
                      payload=np.zeros((9, 9), complex),   # l_max=8 shape...
                      grid="gl", l_max=12)                 # ...claims 12
    honest = eng.submit(direction="alm2map", payload=_serve_alm(1),
                        grid="gl", l_max=12)
    eng.drain()
    assert isinstance(liar.exception(), ValueError)
    assert honest.exception() is None and honest.done()


def test_serve_timeout_evicted_later_requests_complete():
    """An expired request is evicted with ShtTimeoutError at batch
    formation; requests behind it still run."""
    eng = _engine(max_k=2)
    stale = eng.submit(direction="alm2map", payload=_serve_alm(0),
                       grid="gl", l_max=12, timeout=0.0)
    fresh = eng.submit(direction="alm2map", payload=_serve_alm(1),
                       grid="gl", l_max=12)
    time.sleep(0.01)                             # let the deadline pass
    eng.drain()
    with pytest.raises(ShtTimeoutError):
        stale.result()
    assert fresh.exception() is None and fresh.done()
    s = eng.stats()["requests"]
    assert s["timed_out"] == 1 and s["completed"] == 1
    assert stale.timing["queue_s"] >= 0.0


def test_serve_timeout_eviction_while_group_mid_batch():
    """A request that expires while an earlier batch of its *own group*
    is still executing on the background threads is evicted at the next
    formation pass -- a wedged batch never pins its group's queue."""
    eng = _engine(max_k=1, max_queue=8)
    started, release = _stall_pool(eng)
    with eng:
        slow = eng.submit(direction="alm2map", payload=_serve_alm(0),
                          grid="gl", l_max=12)
        assert started.wait(30.0)                # batch 1 wedged mid-flight
        stale = eng.submit(direction="alm2map", payload=_serve_alm(1),
                           grid="gl", l_max=12, timeout=0.0)
        fresh = eng.submit(direction="alm2map", payload=_serve_alm(2),
                           grid="gl", l_max=12)
        time.sleep(0.05)                         # stale's deadline passes
        release.set()
        eng.drain(timeout=30.0)
    assert slow.exception() is None
    with pytest.raises(ShtTimeoutError):
        stale.result()
    assert fresh.exception() is None
    s = eng.stats()["requests"]
    assert s["timed_out"] == 1 and s["completed"] == 2 and s["pending"] == 0


def test_serve_stop_and_close_with_live_threads_and_executing_batch():
    """stop() never strands a popped batch (the in-flight staged work
    executes before the threads join), and close() fails the queued
    leftovers instead of dropping them -- with background warm-up threads
    alive through the whole teardown."""
    eng = _engine(max_k=1, max_queue=8, warm_after=1)
    started, release = _stall_pool(eng)
    eng.start()
    inflight = eng.submit(direction="alm2map", payload=_serve_alm(0),
                          grid="gl", l_max=12)   # warm_after=1 fires here
    assert started.wait(30.0)                    # wedged mid-execution
    timer = threading.Timer(0.05, release.set)
    timer.start()
    eng.stop(drain=False)    # returns only after the wedged batch lands
    timer.join()
    assert inflight.done() and inflight.exception() is None
    assert eng.describe()["pipeline"]["double_buffered"] is False
    queued = eng.submit(direction="alm2map", payload=_serve_alm(1),
                        grid="gl", l_max=12)     # stopped != closed
    eng.close()                                  # now fail the leftovers
    assert isinstance(queued.exception(), RuntimeError)
    with pytest.raises(RuntimeError):
        eng.submit(direction="alm2map", payload=_serve_alm(2), grid="gl",
                   l_max=12)                     # closed = no new work
    s = eng.stats()["requests"]
    assert s["pending"] == 0 and s["completed"] == 1 and s["failed"] == 1


# -- the port against the reference -------------------------------------------


def _maps(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape)


def _scripted_traffic(eng):
    """One submission sequence for either package's engine: GL l_max 16 at
    spin 0 and 2, HEALPix nside 4, K=1 and K=2 payloads, map2alm with iters
    0 and 1, stepped part way then drained.  Returns the futures and the
    counters / WDRR deficits after each step."""
    hp_maps = (15, 16)              # HEALPix nside 4: rings, longest ring
    gl_maps = (17, 34)
    subs = [
        dict(direction="alm2map", payload=_alm(1), grid="gl", l_max=16),
        dict(direction="alm2map", payload=_alm(2, K=2), grid="gl", l_max=16),
        dict(direction="alm2map", payload=_alm(3, spin=2), grid="gl",
             l_max=16, spin=2),
        dict(direction="alm2map", payload=_alm(4, l_max=8), grid="healpix",
             nside=4),
        dict(direction="map2alm", payload=_maps(5, gl_maps), grid="gl",
             l_max=16),
        dict(direction="alm2map", payload=_alm(6), grid="gl", l_max=16),
        dict(direction="map2alm", payload=_maps(7, hp_maps), grid="healpix",
             nside=4, iters=1),
        dict(direction="map2alm", payload=_maps(8, gl_maps + (2,)),
             grid="gl", l_max=16, iters=1),
        dict(direction="alm2map", payload=_alm(9, spin=2, K=2), grid="gl",
             l_max=16, spin=2),
        dict(direction="alm2map", payload=_alm(10), grid="gl", l_max=16),
        dict(direction="alm2map", payload=_alm(11, l_max=8, K=2),
             grid="healpix", nside=4),
        dict(direction="map2alm", payload=_maps(12, gl_maps), grid="gl",
             l_max=16),
        dict(direction="alm2map", payload=_alm(13), grid="gl", l_max=16),
    ]
    futs, snaps = [], []

    def snap():
        s = eng.stats()
        snaps.append((s["requests"], s["coalescing"],
                      s["fairness"]["deficits"],
                      {g: (a["k_cap"], a["feasible"])
                       for g, a in s["admission"]["groups"].items()}))

    for i, kw in enumerate(subs):
        futs.append(eng.submit(**kw))
        if i in (4, 8):
            eng.step()
            snap()
    eng.step()
    snap()
    eng.drain()
    snap()
    return futs, snaps


def test_engine_reproduces_the_reference_on_scripted_traffic():
    """The same scripted traffic through ``repro.serve.ShtEngine(mode=
    "jnp")`` and the port's engine (``mode="torch"``, CPU), synchronous,
    with a WDRR weight map and an admission target that caps one group:
    equal batch logs (rids, sizes, K, K bucket, ok), request and
    coalescing counters, WDRR deficits and admission verdicts at every
    step; every result within 1e-12 relative of the reference's (the
    float64 oracles' agreement)."""
    # a target that admits K=2 but not K=4 for the GL spin-0 synthesis
    t = admission.k_caps_for_target(
        l_max=16, n_rings=17, n_phi=34, max_k=4, p99_target_s=1.0,
        backend="torch", hw=HW_HOST)["predicted_s_by_k"]
    target = 2.0 * t[2] * 1.01
    kw = dict(max_k=4, p99_target_s=target,
              weights={"gl/lmax16/spin2/float64": 0.5})
    ref_eng = repro.serve.ShtEngine(mode="jnp", **kw)
    eng = _engine(**kw)
    rfuts, rsnaps = _scripted_traffic(ref_eng)
    futs, snaps = _scripted_traffic(eng)

    fields = ("signature", "direction", "rids", "n_requests", "k_total",
              "k_plan", "ok")
    assert [{k: b[k] for k in fields} for b in eng.batch_log] == \
        [{k: b[k] for k in fields} for b in ref_eng.batch_log]
    assert any(b["k_plan"] == 2 and b["n_requests"] == 2
               for b in eng.batch_log)          # the admission cap bit
    assert len(snaps) == len(rsnaps)
    for (req, co, deficits, caps), (rreq, rco, rdeficits, rcaps) in zip(
            snaps, rsnaps):
        assert req == rreq
        assert co.keys() == rco.keys()
        for k in co:
            assert co[k] == pytest.approx(rco[k], rel=1e-12, nan_ok=True)
        assert deficits == rdeficits
        assert caps == rcaps
    assert snaps[-1][0]["completed"] == len(futs)
    for f, rf in zip(futs, rfuts):
        got, want = f.result(), np.asarray(rf.result())
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


CAP_SHAPES = [("gl", dict(l_max=16)), ("healpix", dict(nside=4))]


@pytest.mark.parametrize("direction,iters", [("synth", 0), ("anal", 0),
                                             ("anal", 2)])
@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("kind,kw", CAP_SHAPES)
def test_k_caps_equal_the_reference(kind, kw, spin, direction, iters):
    """``k_caps_for_target(backend="torch", hw=HW_HOST)`` against the
    reference's on its CPU model (``("jnp", HW_HOST)``): predicted seconds
    per K to 1e-12, equal k_cap and feasibility, for targets from
    infeasible to uncapped, on GL and HEALPix (ragged FFT lengths); and
    ``default_model`` names those models for the CPU."""
    g, _ = transform._resolve_grid(kind, kw.get("l_max"), kw.get("nside"))
    l_max = kw.get("l_max") or 2 * kw["nside"]
    shape = dict(l_max=l_max, n_rings=g.n_rings, n_phi=g.max_n_phi,
                 max_k=8, direction=direction, iters=iters, spin=spin,
                 fft_lengths=None if g.uniform else g.n_phi)
    probe = radmission.k_caps_for_target(p99_target_s=1.0, backend="jnp",
                                         hw=ranalysis.HW_HOST, **shape)
    t = probe["predicted_s_by_k"]
    targets = [t[1], 2 * t[1] * 1.001, 2 * t[2] * 1.001, 2 * t[4] * 1.001,
               4 * t[8]]
    caps = []
    for target in targets:
        got = admission.k_caps_for_target(p99_target_s=target,
                                          backend="torch", hw=HW_HOST,
                                          **shape)
        want = radmission.k_caps_for_target(p99_target_s=target,
                                            backend="jnp",
                                            hw=ranalysis.HW_HOST, **shape)
        assert got["k_cap"] == want["k_cap"]
        assert got["feasible"] == want["feasible"]
        assert got["predicted_s_by_k"].keys() == want["predicted_s_by_k"].keys()
        for k, v in want["predicted_s_by_k"].items():
            assert got["predicted_s_by_k"][k] == pytest.approx(v, rel=1e-12)
        assert got["predicted_s"] == pytest.approx(want["predicted_s"],
                                                   rel=1e-12)
        caps.append((got["k_cap"], got["feasible"]))
    assert caps == [(1, False), (1, True), (2, True), (4, True), (8, True)]
    assert admission.default_model("cpu") == ("torch", HW_HOST)
    assert admission.default_model(torch.device("cpu")) == ("torch", HW_HOST)
    assert admission.default_model(None)[0] == "cuda_mxu"


# -- the port's own pieces ----------------------------------------------------


def test_drop_plan_releases_one_memoised_plan():
    a, b = _plan(l_max=8), _plan(l_max=12)
    assert transform.drop_plan(a) is True
    assert a._signature_key not in transform._PLANS
    assert b._signature_key in transform._PLANS
    assert transform.drop_plan(a) is False
    assert _plan(l_max=8) is not a               # rebuilt, not resurrected


@pytest.mark.parametrize("mode,layout,spin", [
    ("torch", None, 0), ("cuda_vpu", "fused", 0), ("cuda_mxu", "plain", 2),
    ("cuda_vpu", "packed", 0)])
def test_warmup_builds_and_runs_each_direction(mode, layout, spin):
    """``Plan.warmup`` runs each chosen direction once on zeros: it returns
    the plan, leaves its callables (and a kernel layout's store) built,
    and the warm plan then gives what a cold one gives."""
    kw = dict(mode=mode, spin=spin, device="cpu")
    if layout:
        kw["layout"] = layout
    plan = repro_torch.make_plan("gl", 12, K=2, dtype="float32", **kw)
    assert plan.warmup(("synth",)) is plan
    assert {k[0] for k in plan._fns} == {"synth"}
    assert plan.warmup() is plan
    assert {k[0] for k in plan._fns} == {"synth", "anal"}
    if layout in ("fused", "packed"):
        assert "prep" in plan._fused_store
    alm = _alm(3, l_max=12, K=2, spin=spin).astype(np.complex64)
    warm = plan.alm2map(alm).numpy()
    transform.clear_plan_cache()
    cold = repro_torch.make_plan("gl", 12, K=2, dtype="float32", **kw)
    assert np.array_equal(warm, cold.alm2map(alm).numpy())


def test_a_fresh_plan_run_from_two_threads(monkeypatch):
    """A warm-up and a request on one fresh plan at once (the pool's warm
    thread beside the execute thread): every lazily built member is built
    once, both threads see the same objects, and the results equal a
    single-threaded plan's."""
    from repro_torch.kernels import ref as kref
    calls = {"seeds": 0, "fn": 0, "prep": 0}
    real_seeds, real_fn = kref.prepare_seeds, transform.Plan._build_fn
    real_maps = ops._pack_maps

    def slow(counter, fn):
        def wrapped(*a, **kw):
            calls[counter] += 1
            time.sleep(0.05)                     # widen the race window
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(kref, "prepare_seeds", slow("seeds", real_seeds))
    monkeypatch.setattr(transform.Plan, "_build_fn", slow("fn", real_fn))
    monkeypatch.setattr(ops, "_pack_maps", slow("prep", real_maps))
    plan = repro_torch.make_plan("gl", 12, K=1, dtype="float32",
                                 mode="cuda_vpu", device="cpu",
                                 cache="off")
    alm = _alm(4, l_max=12, K=1).astype(np.complex64)
    out, errs = {}, []
    barrier = threading.Barrier(2)

    def run(name, fn):
        try:
            barrier.wait(10.0)
            out[name] = fn()
        except Exception as e:                    # pragma: no cover
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=("warm",
                                                      lambda: plan.warmup())),
                   threading.Thread(target=run, args=(
                       "serve", lambda: plan.alm2map(alm).numpy()))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errs
    assert calls == {"seeds": 1, "fn": 2, "prep": 1}   # fn: synth and anal
    assert out["warm"] is plan
    monkeypatch.undo()
    transform.clear_plan_cache()
    single = repro_torch.make_plan("gl", 12, K=1, dtype="float32",
                                   mode="cuda_vpu", device="cpu")
    assert np.array_equal(out["serve"], single.alm2map(alm).numpy())


def test_kernel_backends_through_the_engine_match_k1_plans():
    """Float32 requests through the static rule (``mode=None``): K buckets
    1, 2, 4 take ``cuda_vpu`` and 8 ``cuda_mxu``, fused (the kernels'
    plain versions on the CPU).  Each result is held against a K=1 plan
    of its batch's backend and layout, as ``chip_smoke.py`` does on the
    card, and a batch replayed through its pooled plan gives the engine's
    bits."""
    eng = ShtEngine(max_k=8, device="cpu", warm_after=2)
    sig_kw = dict(grid="gl", l_max=12, dtype="float32")
    alms = [_alm(20 + i, l_max=12).astype(np.complex64) for i in range(15)]
    futs = []
    for wave in (1, 2, 4, 8):                     # one K bucket per wave
        futs += [eng.submit(direction="alm2map", payload=a, **sig_kw)
                 for a in alms[wave - 1:2 * wave - 1]]
        eng.drain()
    assert [b["k_plan"] for b in eng.batch_log] == [1, 2, 4, 8]
    assert eng.pool.stats()["warmups"] == 1
    by_rid = {f.rid: (f, a) for f, a in zip(futs, alms)}
    for b in eng.batch_log:
        plan = eng.pool.get(PlanSig(grid="gl", l_max=12, dtype="float32"),
                            b["k_plan"])
        want = "cuda_mxu" if b["k_plan"] == 8 else "cuda_vpu"
        assert plan.backends["synth"] == want
        assert plan.layouts["synth"] == "fused"
        ref = repro_torch.make_plan("gl", 12, K=1, dtype="float32",
                                    mode=want, layout="fused", device="cpu")
        stacked = []
        for rid in b["rids"]:
            f, a = by_rid[rid]
            r = ref.alm2map(a[..., None]).numpy()[..., 0]
            assert np.max(np.abs(f.result() - r)) <= 5e-5 * np.abs(r).max()
            stacked.append(a)
        pad = [np.zeros_like(alms[0])] * (b["k_plan"] - len(stacked))
        replay = plan.alm2map(np.stack(stacked + pad, -1)).numpy()
        for i, rid in enumerate(b["rids"]):
            assert np.array_equal(replay[..., i], by_rid[rid][0].result())


def test_engine_and_pool_default_to_the_card():
    """``device=None`` means the CUDA device: without one the engine and
    the pool raise instead of serving on the CPU; a CPU engine owns no
    CUDA streams."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShtEngine(max_k=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanPool(2)
    eng = _engine()
    assert eng._stage_stream is None and eng._exec_stream is None


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        capture_output=True, text=True, timeout=300)


def test_cli_serves_on_the_cpu():
    proc = _cli("--smoke", "--requests", "4", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "completed 4/4" in proc.stdout
    assert "coalescing" in proc.stdout


def test_cli_without_a_device_serves_nothing():
    """Without ``--device`` the CLI serves on the card; with none visible
    it exits non-zero with the error and serves nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    proc = _cli("--smoke", "--requests", "4")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "completed" not in proc.stdout
