"""Harmonic-domain error metric and power spectrum (counterpart of
``repro.core.spectra``)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["d_err", "cl_from_alm"]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def d_err(a_init, a_out) -> float:
    """Relative round-trip error over all (l, m): the paper's eq. 19."""
    a_init, a_out = _host(a_init), _host(a_out)
    num = np.sum(np.abs(a_init - a_out) ** 2)
    den = np.sum(np.abs(a_init) ** 2)
    return float(np.sqrt(num / den))


def cl_from_alm(alm: torch.Tensor) -> torch.Tensor:
    """Pseudo-C_l estimator from packed (M, L, K) alm (real field, m >= 0):
    C_l = (|a_l0|^2 + 2 sum_{m >= 1} |a_lm|^2) / (2 l + 1), shape (L, K).
    Differentiable (plain torch operations)."""
    p = alm.real ** 2 + alm.imag ** 2                       # (M, L, K)
    tot = p[0] + 2.0 * p[1:].sum(dim=0)                     # (L, K)
    l = torch.arange(alm.shape[1], dtype=tot.dtype, device=tot.device)
    return tot / (2.0 * l + 1.0)[:, None]
