"""Carry the reference's state into the port.

An SHT has no learned weights: its state is the grid geometry, the seed
tables, the alm and the maps.  :func:`from_reference` takes those as the
reference produces them (numpy arrays) and returns the port's tensors on
a device, in the same layouts, so one set of inputs can be fed to both
packages.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.transform import resolve_device

__all__ = ["from_reference"]

#: field -> (dtype, ndim) in the port; ``None`` keeps the array's own
#: (float or complex) precision
_FIELDS = {
    "cos_theta": (torch.float64, 1),
    "sin_theta": (torch.float64, 1),
    "weights": (torch.float64, 1),
    "phi0": (torch.float64, 1),
    "n_phi": (torch.int64, 1),
    "pmm": (torch.float32, 2),          # (Mp, R) seed mantissas
    "pms": (torch.int32, 2),            # (Mp, R) seed scales
    "alm": (None, 3),                   # (M, L, K) complex
    "maps": (None, 3),                  # (R, n_phi, K) real
}


def from_reference(arrays: Mapping[str, np.ndarray],
                   device=None) -> dict[str, torch.Tensor]:
    """Reference arrays -> port tensors on ``device`` (``None``: the CUDA
    device, which must be visible).

    Keys are grid fields (``cos_theta``, ``sin_theta``, ``weights``,
    ``n_phi``, ``phi0``), seeds (``pmm``, ``pms``), ``alm`` (complex) and
    ``maps`` (real).  Values are copied; layouts are unchanged.
    """
    device = resolve_device(device)
    out = {}
    for name, arr in arrays.items():
        if name not in _FIELDS:
            raise KeyError(f"unknown state field {name!r}; expected one of "
                           f"{sorted(_FIELDS)}")
        dtype, ndim = _FIELDS[name]
        a = np.array(arr, copy=True)
        if a.ndim != ndim:
            raise ValueError(f"{name} has {a.ndim} dims, expected {ndim}")
        if name == "alm" and not np.iscomplexobj(a):
            raise ValueError("alm must be complex")
        if name == "maps" and np.iscomplexobj(a):
            raise ValueError("maps must be real")
        t = torch.from_numpy(a)
        out[name] = (t if dtype is None else t.to(dtype)).to(device)
    return out
