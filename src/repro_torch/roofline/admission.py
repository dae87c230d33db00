"""Roofline-based admission control for the SHT serving engine.

Counterpart of ``repro.roofline.admission``.  libsharp (arXiv 1303.4945)
sizes its work units from a calibrated performance model rather than
fixed caps; this module applies the same idea to the serving engine's
K-axis coalescing.  Instead of admitting micro-batches up to a fixed
``max_k``, the engine asks: *given a p99 latency target, how wide may a
coalesced batch of this signature be?*

The answer is the largest power-of-two K whose **predicted** device time
(`repro_torch.roofline.predict_sht_time`, the model behind
``make_plan(mode="model")``) still fits the target with a pipeline slack
factor:

    admit K  iff  slack * t_model(K) <= p99_target

``slack`` defaults to 2: under double-buffered serving a request can wait
behind at most one in-flight batch of its own size before its batch
starts, so the end-to-end tail is ~2 batch times in the steady state.
Analysis requests with Jacobi refinement (``iters > 0``) run
``1 + 2*iters`` transforms per call and are charged accordingly.

A target no K satisfies (even K=1 predicts over budget) is *infeasible*:
the engine still serves K=1 batches -- refusing service outright would
turn a mis-set knob into an outage -- but flags the group so
``stats()["admission"]`` surfaces the violation.  The engine also tracks
predicted-vs-measured batch compute (`repro_torch.serve.metrics.Calibration`)
so operators can see how honest the model is on their hardware.

The model a device is priced on is :func:`default_model`'s: the ``torch``
oracle on :data:`HW_HOST` for a CPU engine (the reference's ``jnp`` on the
host, so CPU verdicts equal the reference's), ``cuda_mxu`` on
:data:`HW_H100` for a CUDA one.  Two limits of the H100 model show in its
verdicts (the calibration ratio measures them):

* it has no bucket-phase term, so on HEALPix grids (hundreds of
  launch-bound per-bucket FFTs) it is optimistic and admits a wider K than
  the target warrants;
* it prices ``cuda_mxu`` for every K, while the static rule
  (``make_plan(mode=None)``) runs ``cuda_vpu`` below 2K = 16, so K <= 4
  buckets run a kernel the model does not price.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.roofline.analysis import (HW_H100, HW_HOST, Hardware,
                                           predict_sht_time)

__all__ = ["default_model", "k_caps_for_target"]


def default_model(device=None) -> tuple:
    """(backend, Hardware) the admission model prices an engine on
    ``device`` against: the ``torch`` oracle on the host model for the CPU,
    the mxu kernels on the H100 model for CUDA (``None`` means the CUDA
    device, as for plans)."""
    if getattr(device, "type", device) == "cpu":
        return "torch", HW_HOST
    return "cuda_mxu", HW_H100


def k_caps_for_target(*, l_max: int, n_rings: int, n_phi: int, max_k: int,
                      p99_target_s: float, m_max: Optional[int] = None,
                      direction: str = "synth", iters: int = 0,
                      spin: int = 0, fft_lengths=None,
                      backend: Optional[str] = None,
                      hw: Optional[Hardware] = None,
                      slack: float = 2.0) -> dict:
    """The admissible coalescing width for one serving group.

    Evaluates ``predict_sht_time`` at every power-of-two K up to
    ``max_k`` and returns::

        {"k_cap":           largest admitted K (>= 1 always),
         "feasible":        False when even K=1 predicts over budget,
         "predicted_s":     model seconds at k_cap (incl. iters factor),
         "predicted_s_by_k": {K: model seconds} for every candidate K,
         "target_s", "slack", "backend", "direction"}

    ``direction`` is "synth" | "anal"; analysis with ``iters`` Jacobi
    passes costs ``1 + 2*iters`` transforms.  ``fft_lengths`` carries a
    ragged grid's per-ring FFT lengths into the model's phase term.
    ``backend`` / ``hw`` default to :func:`default_model` of the CUDA
    device.
    """
    if direction not in ("synth", "anal"):
        raise ValueError(f"direction must be 'synth' or 'anal', got "
                         f"{direction!r}")
    if not p99_target_s > 0.0:
        raise ValueError(f"p99_target_s must be > 0, got {p99_target_s}")
    if not slack > 0.0:
        raise ValueError(f"slack must be > 0, got {slack}")
    m_max = l_max if m_max is None else m_max
    if backend is None or hw is None:
        b, h = default_model()
        backend = backend or b
        hw = hw or h
    mult = 1.0 if direction == "synth" else 1.0 + 2.0 * iters
    by_k: dict = {}
    k = 1
    while k <= max_k:
        by_k[k] = mult * predict_sht_time(
            backend, l_max=l_max, m_max=m_max, n_rings=n_rings, n_phi=n_phi,
            K=k, direction=direction, hw=hw, fft_lengths=fft_lengths,
            spin=spin)
        k *= 2
    fits = [kk for kk, t in by_k.items() if slack * t <= p99_target_s]
    k_cap = max(fits) if fits else 1
    return {
        "k_cap": int(k_cap),
        "feasible": bool(fits),
        "predicted_s": by_k[k_cap],
        "predicted_s_by_k": by_k,
        "target_s": float(p99_target_s),
        "slack": float(slack),
        "backend": backend,
        "direction": direction,
    }
