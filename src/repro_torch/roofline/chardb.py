"""Persistent per-hardware store of measured autotune corners.

Counterpart of ``repro.roofline.chardb``.  ``make_plan(mode="auto")`` times
each candidate corner (backend x direction x layout); the timing is
kept under a hardware fingerprint (the card's name and count, or the CPU,
and the torch and CUDA versions), so

  * a corner is measured at most once per hardware per ``SCHEMA`` epoch:
    later plan builds, even after the decision cache is cleared, reuse the
    stored microseconds and measure nothing;
  * a corner stored under an older ``SCHEMA`` is measured again;
  * with ``REPRO_TORCH_CHARDB_SMOKE=1`` a missing corner is skipped, not
    timed, and the plan falls back to the cost model's ranking.

The store lives in process memory and, when the plan's cache is on disk
(``core.cache.cache_dir``), in a ``chardb_<fingerprint>.json`` beside the
other cached payloads.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
from typing import Callable, Optional

__all__ = ["SCHEMA", "CharDB", "hardware_fingerprint", "get_db", "stats",
           "reset_stats", "clear", "smoke_mode"]

#: bump when the timing method changes; older corners become stale
#: (2: the median of several timed calls, CUDA events on the card)
SCHEMA = 2

_SMOKE_ENV = "REPRO_TORCH_CHARDB_SMOKE"

_lock = threading.Lock()
_DBS: dict[str, "CharDB"] = {}


def smoke_mode() -> bool:
    """True when a bounded run asked never to measure, only to reuse."""
    return os.environ.get(_SMOKE_ENV, "") not in ("", "0")


def hardware_fingerprint(device=None) -> tuple:
    """(short hash, readable string) of the hardware the timings hold for:
    the CUDA device's name and the device count, or ``cpu``, with the torch
    and CUDA versions.  ``device`` is the plan's (``None``: the CUDA device
    when one is visible)."""
    import torch
    dev_type = getattr(device, "type", device)
    if dev_type is None:
        dev_type = "cuda" if torch.cuda.is_available() else "cpu"
    if dev_type == "cuda":
        index = getattr(device, "index", None) or 0
        parts = ["cuda", torch.cuda.get_device_name(index),
                 str(torch.cuda.device_count())]
    else:
        parts = ["cpu", "-", "1"]
    desc = "|".join(parts + [torch.__version__, str(torch.version.cuda)])
    return hashlib.sha1(desc.encode()).hexdigest()[:16], desc


class CharDB:
    """One characterization store for one hardware fingerprint."""

    def __init__(self, fingerprint: str, desc: str,
                 directory: Optional[str] = None):
        self.fingerprint = fingerprint
        self.desc = desc
        self.directory = directory
        self._store: dict[str, dict] = {}
        self.counters = {"measured": 0, "reused": 0, "skipped": 0,
                         "stale": 0}
        self._batch = 0
        self._dirty = False
        if directory:
            self._load()

    # -- persistence -------------------------------------------------------

    @property
    def path(self) -> Optional[str]:
        if not self.directory:
            return None
        return os.path.join(self.directory,
                            f"chardb_{self.fingerprint}.json")

    def _load(self) -> None:
        try:
            with open(self.path) as fh:
                payload = json.load(fh)
            if isinstance(payload, dict):
                self._store.update(payload.get("corners", {}))
        except (OSError, ValueError):
            pass

    def _save(self) -> None:
        """Write the store through the plan cache's atomic write (a unique
        temporary file, then a rename; an unwritable directory warns)."""
        from repro_torch.core import cache as plancache
        self._dirty = False
        if not self.path:
            return
        payload = {"fingerprint": self.fingerprint, "desc": self.desc,
                   "corners": self._store}

        def write(tmp: str) -> None:
            with open(tmp, "w") as fh:
                json.dump(payload, fh)

        plancache._atomic_write(self.path, write)

    @contextlib.contextmanager
    def batch(self):
        """Hold the writes of the corners measured inside: the store is
        written once on the way out (also when a measurement raised)."""
        self._batch += 1
        try:
            yield self
        finally:
            self._batch -= 1
            if not self._batch and self._dirty:
                with _lock:
                    self._save()

    # -- corners -----------------------------------------------------------

    @staticmethod
    def corner_key(**fields) -> str:
        """Deterministic key over the corner's workload coordinates (grid,
        l_max, K, dtype, backend, direction, layout, ...), never the
        dispatch mode, so plans built in other modes share corners."""
        blob = json.dumps(fields, sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:24]

    def lookup(self, **fields):
        """The stored record of a corner (None if missing or stale)."""
        rec = self._store.get(self.corner_key(**fields))
        if rec is None or rec.get("schema") != SCHEMA:
            return None
        return rec

    def get_or_measure(self, measure_fn: Callable[[], float], *,
                       reuse: bool = True, **fields):
        """``(us, status)`` of a corner: ``"reused"`` (a fresh record),
        ``"measured"`` (``measure_fn()`` ran and was stored; a stale record,
        or any record with ``reuse=False``, is measured again), or
        ``"skipped"`` (smoke mode and no fresh record: ``us`` is None and
        the caller ranks by the cost model).  An exception of
        ``measure_fn`` propagates and stores nothing."""
        key = self.corner_key(**fields)
        with _lock:
            rec = self._store.get(key)
            if reuse and rec is not None and rec.get("schema") == SCHEMA:
                self.counters["reused"] += 1
                return rec.get("us"), "reused"
            if rec is not None:
                self.counters["stale"] += 1
        if smoke_mode():
            with _lock:
                self.counters["skipped"] += 1
            return None, "skipped"
        us = float(measure_fn())
        with _lock:
            self.counters["measured"] += 1
            self._store[key] = {"schema": SCHEMA, "us": us, "fields": fields}
            self._dirty = True
            if not self._batch:
                self._save()
        return us, "measured"

    def characterize(self, corners, measure_fn) -> dict:
        """Sweep ``corners`` (field dicts), measuring any missing or stale
        one by ``measure_fn(fields) -> us``; ``{status: count}``."""
        out = {"measured": 0, "reused": 0, "skipped": 0}
        with self.batch():
            for fields in corners:
                _, status = self.get_or_measure(
                    lambda f=fields: measure_fn(f), **fields)
                out[status] += 1
        return out

    def stats(self) -> dict:
        return {"fingerprint": self.fingerprint, "corners": len(self._store),
                "path": self.path, **self.counters}


def get_db(directory: Optional[str] = None, device=None) -> CharDB:
    """The process-wide store for the hardware of ``device``, one per
    (fingerprint, directory).  Pass the plan's disk-cache directory to keep
    corners across processes; None keeps them in memory."""
    fp, desc = hardware_fingerprint(device)
    key = f"{fp}:{directory or ''}"
    with _lock:
        db = _DBS.get(key)
        if db is None:
            db = _DBS[key] = CharDB(fp, desc, directory)
        return db


def stats() -> dict:
    """Counters summed over every store this process opened."""
    agg = {"measured": 0, "reused": 0, "skipped": 0, "stale": 0,
           "corners": 0, "dbs": 0}
    with _lock:
        for db in _DBS.values():
            for k in ("measured", "reused", "skipped", "stale"):
                agg[k] += db.counters[k]
            agg["corners"] += len(db._store)
            agg["dbs"] += 1
    return agg


def reset_stats() -> None:
    with _lock:
        for db in _DBS.values():
            db.counters = {k: 0 for k in db.counters}


def clear() -> None:
    """Drop every in-memory store (files on disk stay)."""
    with _lock:
        _DBS.clear()
