"""SHT serving layer: coalesce concurrent transform requests into the K
channel axis over a warm pool of plans.

Counterpart of ``repro.serve``::

    from repro_torch.serve import ShtEngine
    eng = ShtEngine(max_k=8, p99_target_s=0.050)   # on the CUDA device
    fut = eng.submit(direction="alm2map", payload=alm, grid="gl",
                     l_max=2048, dtype="float32")
    eng.drain()                       # or: with eng: ... (double-buffered
    maps = fut.result()               #     formation/execute threads)
    print(eng.report())               # p50/p95/p99, coalescing, admission

Payloads and results are numpy arrays.  ``device="cpu"`` serves on the
CPU (the kernels' plain versions, or the float64 ``torch`` oracle).
"""

from repro_torch.serve.metrics import Calibration, LatencyWindow, percentile  # noqa: F401
from repro_torch.serve.pool import PlanPool, PlanSig  # noqa: F401
from repro_torch.serve.serve_loop import (  # noqa: F401
    BackpressureError, InvalidStateError, ShtEngine, ShtFuture, ShtRequest,
    ShtTimeoutError,
)

__all__ = [
    "ShtEngine", "ShtRequest", "ShtFuture", "PlanPool", "PlanSig",
    "BackpressureError", "ShtTimeoutError", "InvalidStateError",
    "LatencyWindow", "Calibration", "percentile",
]
