"""Signature-keyed precompute cache for transform plans (memory tier).

Counterpart of ``repro.core.cache``: a plan's host-side precompute (grid
geometry, ``pmm``/``pms`` seed tables) is keyed by a content hash of the
fields it depends on (grid spec; for the seeds also ``m_max`` and
``fold``), so a second plan on the same grid builds none of it.
Payloads are flat ``dict[str, np.ndarray]``.  The disk tier waits for
ROADMAP.md Open items section 1, item 9.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable

import numpy as np

__all__ = ["CACHE_VERSION", "CacheStats", "LRU", "signature_key",
           "get_or_build", "clear_memory", "stats", "reset_stats"]

#: Bump when a cached payload layout changes (keys embed the version).
CACHE_VERSION = 1

_MEMORY: dict[str, dict[str, np.ndarray]] = {}


@dataclasses.dataclass
class CacheStats:
    """Counters for cache behaviour; reset with :func:`reset_stats`."""

    builds: int = 0
    memory_hits: int = 0
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
    """Drop the in-memory tier."""
    _MEMORY.clear()


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


def get_or_build(key: str, builder: Callable[[], dict]) -> dict:
    """The payload for ``key``, built at most once per process."""
    if key in _MEMORY:
        _STATS.memory_hits += 1
        return _MEMORY[key]
    _STATS.misses += 1
    _STATS.builds += 1
    payload = builder()
    _MEMORY[key] = payload
    return payload
