"""Harmonic-domain error metric (counterpart of ``repro.core.spectra``)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["d_err"]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def d_err(a_init, a_out) -> float:
    """Relative round-trip error over all (l, m): the paper's eq. 19."""
    a_init, a_out = _host(a_init), _host(a_out)
    num = np.sum(np.abs(a_init - a_out) ** 2)
    den = np.sum(np.abs(a_init) ** 2)
    return float(np.sqrt(num / den))
