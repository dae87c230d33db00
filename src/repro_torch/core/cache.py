"""Signature-keyed precompute cache for transform plans, in memory and on
disk.

Counterpart of ``repro.core.cache``: a plan's host-side precompute (grid
geometry, ``pmm``/``pms`` seed tables) is keyed by a content hash of the
fields it depends on (grid spec; for the seeds also ``m_max`` and
``fold``), so a second plan on the same grid builds none of it; the
measured autotune decisions of ``make_plan(mode="auto")`` are kept the
same way.

Two tiers:

* **memory**: a process-global dict keyed by signature hash, always
  consulted first;
* **disk**: ``.npz`` payloads and ``.json`` decisions under
  ``$REPRO_TORCH_CACHE_DIR`` (default ``~/.cache/repro_torch_sht``; the
  reference's directory variable is not read, so the two packages never
  share files), written atomically (a temporary file and a rename).

Payloads are flat ``dict[str, np.ndarray]``; decisions are json-able
dicts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import warnings
from typing import Callable, Optional

import numpy as np

__all__ = ["CACHE_VERSION", "CacheStats", "LRU", "signature_key",
           "get_or_build", "cache_dir", "load_decision", "save_decision",
           "clear_memory", "clear_disk", "stats", "reset_stats"]

#: Bump when a cached payload layout changes (keys embed the version).
CACHE_VERSION = 1

_MEMORY: dict[str, dict[str, np.ndarray]] = {}
_DECISIONS: dict[str, dict] = {}

_DIR_ENV = "REPRO_TORCH_CACHE_DIR"


@dataclasses.dataclass
class CacheStats:
    """Counters for cache behaviour; reset with :func:`reset_stats`."""

    builds: int = 0
    memory_hits: int = 0
    disk_hits: int = 0
    misses: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_STATS = CacheStats()


class LRU:
    """Bounded least-recently-used mapping; ``on_evict(key, value)`` runs
    after each eviction so the holder can release what the value owns."""

    def __init__(self, capacity: int, on_evict=None):
        if capacity < 1:
            raise ValueError(f"LRU capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._on_evict = on_evict
        self._data: dict = {}          # insertion-ordered; end = most recent
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def keys(self):
        return list(self._data)

    def get(self, key, default=None):
        """Fetch and mark ``key`` most-recently-used."""
        if key not in self._data:
            return default
        value = self._data.pop(key)
        self._data[key] = value
        return value

    def put(self, key, value) -> None:
        """Insert or refresh ``key``, evicting the LRU entry when full."""
        self._data.pop(key, None)
        self._data[key] = value
        while len(self._data) > self.capacity:
            old_key = next(iter(self._data))
            old_val = self._data.pop(old_key)
            self.evictions += 1
            if self._on_evict is not None:
                self._on_evict(old_key, old_val)

    def pop(self, key, default=None):
        return self._data.pop(key, default)

    def clear(self) -> None:
        self._data.clear()


def stats() -> CacheStats:
    """The process-global cache counters (live object)."""
    return _STATS


def reset_stats() -> None:
    global _STATS
    _STATS = CacheStats()


def clear_memory() -> None:
    """Drop the in-memory tier (disk entries stay)."""
    _MEMORY.clear()
    _DECISIONS.clear()


def cache_dir(override: Optional[str] = None) -> str:
    """The disk tier's directory: ``override``, else
    ``$REPRO_TORCH_CACHE_DIR``, else ``~/.cache/repro_torch_sht``."""
    if override:
        return override
    env = os.environ.get(_DIR_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch_sht")


def clear_disk(directory: Optional[str] = None) -> int:
    """Remove the disk tier under ``directory`` (resolved as
    :func:`cache_dir`).  Only names this layer writes are touched: 32 hex
    digits (signatures) or ``chardb_`` and 16 hex digits (the hardware
    characterization stores), with a ``.npz`` or ``.json`` suffix.
    Returns the count removed; a missing directory is a no-op."""
    d = cache_dir(directory)
    if not os.path.isdir(d):
        return 0
    removed = 0
    for name in os.listdir(d):
        stem, _, ext = name.rpartition(".")
        if ext not in ("npz", "json"):
            continue
        if stem.startswith("chardb_"):
            stem = stem[len("chardb_"):]
            if len(stem) != 16:
                continue
        elif len(stem) != 32:
            continue
        if not all(c in "0123456789abcdef" for c in stem):
            continue
        try:
            os.unlink(os.path.join(d, name))
            removed += 1
        except OSError:            # a concurrent clear: best effort
            pass
    return removed


def signature_key(kind: str, **fields) -> str:
    """Stable content hash of a signature field dict; numpy arrays hash by
    shape, dtype and bytes."""
    h = hashlib.sha256()
    h.update(f"v{CACHE_VERSION}:{kind}".encode())
    for name in sorted(fields):
        v = fields[name]
        h.update(name.encode())
        if isinstance(v, np.ndarray):
            h.update(str(v.shape).encode())
            h.update(str(v.dtype).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()[:32]


def _atomic_write(path: str, write_fn: Callable[[str], None]) -> None:
    """Write through a temporary file and a rename; an unwritable directory
    warns and leaves the entry in memory only."""
    tmp = None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        os.close(fd)
        write_fn(tmp)
        os.replace(tmp, path)
    except OSError as e:
        warnings.warn(f"repro_torch cache: cannot persist {path!r} ({e}); "
                      "keeping it in memory only", RuntimeWarning)
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)


def get_or_build(key: str, builder: Callable[[], dict], *,
                 cache: str = "memory",
                 directory: Optional[str] = None) -> dict:
    """The payload for ``key``, built at most once.  ``cache``: ``"off"``
    (always build), ``"memory"`` (once per process) or ``"disk"`` (memory,
    then ``<dir>/<key>.npz``, else build and write it)."""
    if cache == "off":
        _STATS.builds += 1
        return builder()
    if key in _MEMORY:
        _STATS.memory_hits += 1
        return _MEMORY[key]
    path = os.path.join(cache_dir(directory), key + ".npz")
    if cache == "disk" and os.path.exists(path):
        try:
            with np.load(path, allow_pickle=False) as z:
                payload = {k: z[k] for k in z.files}
            _STATS.disk_hits += 1
            _MEMORY[key] = payload
            return payload
        except (OSError, ValueError):
            pass                   # a torn or stale file: build again
    _STATS.misses += 1
    _STATS.builds += 1
    payload = builder()
    _MEMORY[key] = payload
    if cache == "disk":
        def write(tmp: str) -> None:
            with open(tmp, "wb") as f:     # np.savez must not add ".npz"
                np.savez(f, **payload)

        _atomic_write(path, write)
    return payload


def load_decision(key: str, *, cache: str = "memory",
                  directory: Optional[str] = None) -> Optional[dict]:
    """A cached autotune decision (json-able dict), or None."""
    if cache == "off":
        return None
    if key in _DECISIONS:
        _STATS.memory_hits += 1
        return _DECISIONS[key]
    if cache == "disk":
        path = os.path.join(cache_dir(directory), key + ".json")
        if os.path.exists(path):
            try:
                with open(path) as f:
                    d = json.load(f)
            except (OSError, ValueError):
                return None
            _STATS.disk_hits += 1
            _DECISIONS[key] = d
            return d
    return None


def save_decision(key: str, decision: dict, *, cache: str = "memory",
                  directory: Optional[str] = None) -> None:
    if cache == "off":
        return
    _DECISIONS[key] = decision
    if cache == "disk":
        path = os.path.join(cache_dir(directory), key + ".json")

        def write(tmp: str) -> None:
            with open(tmp, "w") as f:
                json.dump(decision, f, indent=1, sort_keys=True)

        _atomic_write(path, write)
