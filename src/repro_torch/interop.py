"""Carry the reference's state into the port.

An SHT has no learned weights: its state is the grid geometry, the seed
tables, the alm and the maps, and for the fused kernels the packed
operands of a slot layout.  :func:`from_reference` takes those as the
reference produces them (numpy arrays) and returns the port's tensors on
a device, so one set of inputs can be fed to both packages.  Layouts are
unchanged, except that the reference's ring axis padded to (R1, 128)
tiles becomes the port's unpadded ring axis of ``n_rings``.  The spin-2
fields are the same names with a leading component axis of 2: (E, B) alm
and (Q, U) maps; their seeds are the ``pmm``/``pms`` fields over the 2M
spin rows.

:func:`grid_from_reference` and :func:`layout_from_reference` carry a
reference ``RingGrid`` and ``BucketLayout`` (host numpy geometry) across
as the port's own, for plans and bucket indices built on the reference's
exact geometry.

:func:`lm_state_from_reference` carries a language model's weights: the
reference's parameter tree as numpy arrays becomes the ``state_dict`` of
the port's ``models.transformer.LM``, so one set of weights runs through
both packages.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.grids import BucketLayout, RingGrid
from repro_torch.core.transform import resolve_device

__all__ = ["from_reference", "grid_from_reference", "layout_from_reference",
           "lm_state_from_reference"]

#: field -> (dtype, ndim) in the port; ``None`` keeps the array's own
#: (float or complex) precision; ``alm`` and ``maps`` also take the spin-2
#: pairs, one more leading axis of length 2
_FIELDS = {
    "cos_theta": (torch.float64, 1),
    "sin_theta": (torch.float64, 1),
    "weights": (torch.float64, 1),
    "phi0": (torch.float64, 1),
    "n_phi": (torch.int64, 1),
    "pmm": (torch.float32, 2),          # (Mp, R) seed mantissas
    "pms": (torch.int32, 2),            # (Mp, R) seed scales
    "alm": (None, 3),                   # (M, L, K) / (2, M, L, K) complex
    "maps": (None, 3),                  # (R, n_phi, K) / (2, R, n_phi, K)
    "a_pk": (torch.float32, 3),         # (n_slots, S, 2K) packed streams
    "slot_maps": (torch.int32, 2),      # (5, n_slots): m0, m1, mp0, mp1, seed
    "pmm_pk": (torch.float32, 4),       # (n_slots, 2, R1, 128) -> (.., R)
    "pms_pk": (torch.int32, 4),         # (n_slots, 2, R1, 128) -> (.., R)
    "tab_pk": (torch.float32, 6),       # (n_slots, 2, n_pl, 4, R1, 128)
}

#: fields whose last two axes are the reference's (R1, 128) ring tiles
_RING_TILED = ("pmm_pk", "pms_pk", "tab_pk")

#: fields that also come as a spin-2 pair: (E, B) alm, (Q, U) maps
_SPIN_PAIRS = ("alm", "maps")


def from_reference(arrays: Mapping[str, np.ndarray], device=None,
                   n_rings: Optional[int] = None) -> dict[str, torch.Tensor]:
    """Reference arrays -> port tensors on ``device`` (``None``: the CUDA
    device, which must be visible).

    Keys are grid fields (``cos_theta``, ``sin_theta``, ``weights``,
    ``n_phi``, ``phi0``), seeds (``pmm``, ``pms``), ``alm`` (complex, or
    the (E, B) pair (2, M, L, K)), ``maps`` (real, or the (Q, U) pair (2,
    R, n_phi, K)), and the packed operands of the fused kernels:
    ``a_pk``, ``slot_maps`` (the five per-slot maps stacked), and the
    ring-tiled ``pmm_pk``/``pms_pk``/``tab_pk``, whose (R1, 128) ring tiles
    are flattened and cut to ``n_rings`` (required for them).  Values are
    copied.
    """
    device = resolve_device(device)
    out = {}
    for name, arr in arrays.items():
        if name not in _FIELDS:
            raise KeyError(f"unknown state field {name!r}; expected one of "
                           f"{sorted(_FIELDS)}")
        dtype, ndim = _FIELDS[name]
        a = np.array(arr, copy=True)
        pair = name in _SPIN_PAIRS and a.ndim == ndim + 1
        if a.ndim != ndim and not pair:
            raise ValueError(f"{name} has {a.ndim} dims, expected {ndim}"
                             + (f" (or {ndim + 1}, a spin-2 pair)"
                                if name in _SPIN_PAIRS else ""))
        if pair and a.shape[0] != 2:
            raise ValueError(f"a spin-2 {name} pair has 2 components, got "
                             f"{a.shape[0]}")
        if name == "alm" and not np.iscomplexobj(a):
            raise ValueError("alm must be complex")
        if name == "maps" and np.iscomplexobj(a):
            raise ValueError("maps must be real")
        t = torch.from_numpy(a)
        if name in _RING_TILED:
            if n_rings is None:
                raise ValueError(f"{name} needs n_rings to cut its ring "
                                 "padding")
            t = t.flatten(-2)[..., :n_rings].contiguous()
        out[name] = (t if dtype is None else t.to(dtype)).to(device)
    return out


def grid_from_reference(grid) -> RingGrid:
    """A reference ``RingGrid`` as the port's, its arrays copied (float64
    geometry, int64 ring lengths) and validated."""
    g = RingGrid(
        name=str(grid.name),
        cos_theta=np.array(grid.cos_theta, dtype=np.float64),
        sin_theta=np.array(grid.sin_theta, dtype=np.float64),
        weights=np.array(grid.weights, dtype=np.float64),
        n_phi=np.array(grid.n_phi, dtype=np.int64),
        phi0=np.array(grid.phi0, dtype=np.float64),
        uniform=bool(grid.uniform),
        nside=None if grid.nside is None else int(grid.nside))
    g.validate()
    return g


def layout_from_reference(layout) -> BucketLayout:
    """A reference ``BucketLayout`` (bucket lengths and ring slots) as the
    port's."""
    return BucketLayout(tuple(int(b) for b in layout.lengths),
                        tuple(np.array(s, dtype=np.int64)
                              for s in layout.slots))


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor, bfloat16 (``ml_dtypes``, which numpy
    knows only by name) included; values copied."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, copy=True).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def lm_state_from_reference(cfg, params: Mapping, device=None
                            ) -> dict[str, torch.Tensor]:
    """The reference's LM parameter tree (``make_bundle(cfg).init(key)``,
    leaves as numpy arrays) -> the port ``LM``'s ``state_dict`` on
    ``device`` (``None``: the CUDA device, which must be visible).

    Keys follow the reference's paths (``embed.table``,
    ``final_norm.scale``, ``lm_head.w``, and per layer ``ln1``/``ln2``
    ``.scale``, ``attn.wq``/``wk``/``wv``/``wo`` ``.w`` and ``.b``,
    ``attn.q_norm``/``k_norm`` ``.scale``, ``mlp.gate``/``up``/``down``
    ``.w``); each group's leading stacked-layer axis is unstacked into
    ``layers.<i>`` in the port's layer order (each repeat's pattern in
    turn).  Dtypes are kept.
    """
    from repro_torch.models.transformer import build_groups
    device = resolve_device(device)
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, tree, take=None):
        if isinstance(tree, Mapping):
            for k, v in tree.items():
                walk(f"{prefix}{k}.", v, take)
            return
        a = np.asarray(tree)
        out[prefix[:-1]] = _tensor(a if take is None else a[take]).to(device)

    for k in params:
        if k != "groups":
            walk(f"{k}.", params[k])
    groups = build_groups(cfg)
    if len(params["groups"]) != len(groups):
        raise ValueError(f"{len(params['groups'])} parameter groups, the "
                         f"config has {len(groups)}")
    layer = 0
    for (pat, n_rep), stacked in zip(groups, params["groups"]):
        for r in range(n_rep):
            for j in range(len(pat)):
                walk(f"layers.{layer}.", stacked[j], take=r)
                layer += 1
    return out
