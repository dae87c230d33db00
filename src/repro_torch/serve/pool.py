"""Warm Plan pool: bounded LRU of live transform plans, keyed by signature.

Counterpart of ``repro.serve.pool``.  ``make_plan`` memoises globally and
never forgets; a serving process that sees many distinct signatures over
its lifetime needs a *bounded* working set of live plans (each one owns
device seed tables, a fused store of packed seeds and index tensors, and
cuFFT plans).  ``PlanPool`` keeps the ``capacity`` most-recently-used
plans, releasing evicted ones through ``transform.drop_plan`` so they can
actually be garbage-collected, and exposes hit/miss/eviction/warm-up
counters for the engine's ``stats()``.

Plans here are always built with ``K = k_plan`` -- the engine's coalesced
channel-bucket width -- so one pooled plan serves every micro-batch of its
signature with a dense, fixed-shape device step (libsharp's "never launch
a ragged step" rule applied to the K axis).

Departures from the reference: the pool takes the ``device`` its plans
run on (``None``: the CUDA device, which must be visible), and its
default ``mode`` is ``None``, ``make_plan``'s static rule, where the
reference's is ``"auto"``: a first plan then times no corners.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from repro_torch.core import cache as plancache
from repro_torch.core import transform

__all__ = ["PlanSig", "PlanPool"]


@dataclasses.dataclass(frozen=True)
class PlanSig:
    """The serving-level plan signature: everything that decides whether
    two requests may share one coalesced device batch (direction rides on
    the group key, not here -- one plan serves both directions)."""

    grid: str
    l_max: Optional[int] = None
    nside: Optional[int] = None
    m_max: Optional[int] = None
    spin: int = 0
    dtype: str = "float64"

    def label(self) -> str:
        geo = f"nside{self.nside}" if self.nside else f"lmax{self.l_max}"
        return f"{self.grid}/{geo}/spin{self.spin}/{self.dtype}"


class PlanPool:
    """Bounded LRU of warm plans on top of ``make_plan``'s signature cache.

    Thread-safe: ``get``/``warm`` may be called from the engine's
    formation thread and from background warm-up threads concurrently.
    The pool lock only guards the LRU map; *building* a plan happens
    outside it behind a per-key build event, so a warm-up building one
    signature never blocks ``get`` for a different signature (the
    double-buffered engine's formation thread must keep staging), while
    two concurrent requests for the *same* key still build it once.  A
    plan's own lazily built members (seeds, callables, fused store) are
    built once under the plan's locks, so a warm-up may run a plan that
    the engine is running too.
    """

    def __init__(self, capacity: int = 8, *, mode: Optional[str] = None,
                 cache: str = "auto", cache_dir: Optional[str] = None,
                 device=None):
        self.mode = mode
        self.cache = cache
        self.cache_dir = cache_dir
        self.device = transform.resolve_device(device)
        self._lock = threading.RLock()
        self._lru = plancache.LRU(capacity, on_evict=self._release)
        self._building: dict = {}           # key -> threading.Event
        self.hits = 0
        self.misses = 0
        self.warmups = 0

    @staticmethod
    def _release(key, plan) -> None:
        transform.drop_plan(plan)

    @property
    def capacity(self) -> int:
        return self._lru.capacity

    @property
    def evictions(self) -> int:
        return self._lru.evictions

    def __len__(self) -> int:
        return len(self._lru)

    def _key(self, sig: PlanSig, k_plan: int):
        return (sig, int(k_plan))

    def get(self, sig: PlanSig, k_plan: int):
        """The pooled plan for ``(sig, k_plan)``, building it on a miss."""
        key = self._key(sig, k_plan)
        while True:
            with self._lock:
                plan = self._lru.get(key)
                if plan is not None:
                    self.hits += 1
                    return plan
                done = self._building.get(key)
                if done is None:
                    done = threading.Event()
                    self._building[key] = done
                    self.misses += 1
                    break
            # another thread is building this key: wait it out, then
            # re-check the LRU (after a failed build this thread builds)
            done.wait()
        try:
            plan = transform.make_plan(
                sig.grid, sig.l_max, nside=sig.nside, m_max=sig.m_max,
                K=int(k_plan), dtype=sig.dtype, spin=sig.spin,
                mode=self.mode, cache=self.cache, cache_dir=self.cache_dir,
                device=self.device)
            with self._lock:
                self._lru.put(key, plan)
            return plan
        finally:
            with self._lock:
                del self._building[key]
            done.set()

    def warm(self, sig: PlanSig, k_plan: int,
             directions=("synth", "anal")):
        """Build the plan for ``(sig, k_plan)`` and run it once
        (``Plan.warmup``) so the first real request pays no build."""
        plan = self.get(sig, k_plan)
        plan.warmup(directions)
        with self._lock:
            self.warmups += 1
        return plan

    def stats(self) -> dict:
        from repro_torch.roofline import chardb
        with self._lock:
            total = self.hits + self.misses
            fusion = {"eligible": 0, "active": 0, "staged": 0}
            for plan in list(self._lru._data.values()):
                ok, _ = plan._fusion_eligibility()
                if not ok:
                    fusion["staged"] += 1
                    continue
                fusion["eligible"] += 1
                if any(plan.layouts.get(d) == "fused"
                       for d in ("synth", "anal")):
                    fusion["active"] += 1
            return {
                "size": len(self._lru),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "warmups": self.warmups,
                "hit_rate": (self.hits / total) if total else float("nan"),
                # fused-pipeline coverage of the warm set: how many pooled
                # plans could fuse and how many actually dispatch fused
                "fusion": fusion,
                # autotune corners behind the pooled plans: a warm pool
                # should show reuse, not re-measurement
                "chardb": chardb.stats(),
            }
