"""Latency accounting for the SHT serving engine.

Counterpart of ``repro.serve.metrics``, pure Python and unchanged.
Per-request timing is split the way a serving dashboard wants it:

* ``queue``   -- submit() to the moment its batch starts executing;
* ``compute`` -- the device wall time of the coalesced batch it rode in
  (shared by every request of that batch);
* ``total``   -- submit() to future resolution.

``percentile`` reimplements numpy's default linear-interpolation estimator
(so `engine.stats()` has no runtime numpy dependency on hot paths) and is
pinned against ``numpy.percentile`` in tests/test_torch_serve.py.
"""

from __future__ import annotations

import math
from typing import Sequence

__all__ = ["percentile", "LatencyWindow", "Calibration"]


def percentile(xs: Sequence[float], q: float) -> float:
    """q-th percentile (0..100) with linear interpolation between closest
    ranks -- numpy.percentile's default ``method="linear"``.  Empty input
    returns NaN."""
    n = len(xs)
    if n == 0:
        return float("nan")
    assert 0.0 <= q <= 100.0, q
    xs = sorted(float(v) for v in xs)
    pos = (q / 100.0) * (n - 1)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


class LatencyWindow:
    """Bounded sample store with percentile summaries.

    Keeps the most recent ``maxlen`` samples (a sustained-load engine must
    not grow without bound) while counting every record ever seen.
    """

    def __init__(self, maxlen: int = 4096):
        assert maxlen >= 1, maxlen
        self.maxlen = int(maxlen)
        self._samples: list[float] = []
        self.count = 0

    def record(self, value_s: float) -> None:
        self.count += 1
        self._samples.append(float(value_s))
        if len(self._samples) > self.maxlen:
            del self._samples[: len(self._samples) - self.maxlen]

    def samples(self) -> list[float]:
        return list(self._samples)

    def summary(self) -> dict:
        """count / mean / max / p50 / p95 / p99 over the retained window
        (seconds).  NaNs when nothing was recorded yet."""
        xs = self._samples
        if not xs:
            nan = float("nan")
            return {"count": 0, "mean_s": nan, "max_s": nan,
                    "p50_s": nan, "p95_s": nan, "p99_s": nan}
        return {
            "count": self.count,
            "mean_s": sum(xs) / len(xs),
            "max_s": max(xs),
            "p50_s": percentile(xs, 50.0),
            "p95_s": percentile(xs, 95.0),
            "p99_s": percentile(xs, 99.0),
        }


class Calibration:
    """Predicted-vs-measured batch compute, for admission control.

    The admission controller prices micro-batches with the roofline model
    (`repro_torch.roofline.admission`); this tracker records, per executed
    batch, the model's prediction next to the measured device wall time
    so ``stats()`` can report how honest the model is on this host.
    ``ratio > 1`` means the model is optimistic (the device runs slower
    than predicted, so the admitted K is wider than the target warrants).
    """

    def __init__(self):
        self.count = 0
        self.sum_predicted_s = 0.0
        self.sum_measured_s = 0.0

    def record(self, predicted_s: float, measured_s: float) -> None:
        self.count += 1
        self.sum_predicted_s += float(predicted_s)
        self.sum_measured_s += float(measured_s)

    @property
    def ratio(self) -> float:
        if self.sum_predicted_s <= 0.0:
            return float("nan")
        return self.sum_measured_s / self.sum_predicted_s

    def summary(self) -> dict:
        return {"count": self.count,
                "predicted_s": self.sum_predicted_s,
                "measured_s": self.sum_measured_s,
                "ratio": self.ratio}
