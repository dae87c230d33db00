"""The Legendre-stage seam: variant choice, CPU / CUDA dispatch, and the
packed-layout conversions.

Counterpart of the plain-layout and packing parts of ``repro.kernels.ops``.  ``synth``
and ``anal`` take the unpadded layouts (the CUDA kernels mask the ragged
ring edge themselves, so nothing is padded to the TPU's 128-lane tiles):

  synth: a (Mp, L1, 2K) f32 -> Delta (Mp, P, R, 2K) f32;
  anal:  dw (Mp, P, R, 2K) f32 -> (Mp, l_max+1, 2K) f32.

A CPU tensor runs the plain version (``kernels.ref``); a CUDA tensor
launches the hand-written kernel (``kernels.legendre_cuda``) or raises;
any other device raises.  The environment overrides and the measured
autotune of the reference's ``pick_variant`` wait for ROADMAP.md Open
items section 1, item 9.

The packing helpers (``_pack_a``, ``_pack_rows``, ``_unpack_rows``,
``_unpack_alm``, ``_pack_maps``) convert between the plain (row, ...)
world and a ``kernels.pack.PackedLayout``'s (slot, segment | stream
position) world with ``index_select`` gathers on the operand's device.
Each takes an optional ``cache`` dict (a plan's fused store) that keeps its
index tensors per (layout, device) for as long as the caller keeps it;
without one they are built per call.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref as kref

__all__ = ["synth", "anal", "pick_variant"]


def pick_variant(K2: int, variant: str | None = None) -> str:
    """vpu-vs-mxu: the explicit argument, else the static ``K2 >= 16`` rule
    (broadcast FMA for few maps, panel contraction for many)."""
    if variant in ("vpu", "mxu"):
        return variant
    if variant is not None:
        raise ValueError(f"unknown Legendre variant {variant!r}")
    return "mxu" if K2 >= 16 else "vpu"


def _operands(m_vals, x, pmm, pms, device):
    """The seed operands as contiguous tensors of the kernels' dtypes."""
    def t(v, dtype):
        return torch.as_tensor(v, device=device).to(dtype).contiguous()
    return (t(m_vals, torch.int32), t(x, torch.float32),
            t(pmm, torch.float32), t(pms, torch.int32))


def _route(device: torch.device) -> str:
    if device.type in ("cpu", "cuda"):
        return device.type
    raise ValueError(f"the Legendre kernels run on CUDA tensors and their "
                     f"plain versions on CPU tensors; got a {device.type} "
                     "tensor")


def synth(a, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False,
          variant: str | None = None) -> torch.Tensor:
    """Kernel-backed synthesis: Delta_m(r) = sum_l a_lm P_lm(x_r).

    a (Mp, L1, 2K) f32; m_vals (Mp,) int (-1 rows are padding and give
    zeros); x (R,) f32 cos(theta); pmm/pms (Mp, R) seeds from
    ``ref.prepare_seeds``.  Returns (Mp, P, R, 2K) f32, P = 2 if fold.
    """
    route = _route(a.device)
    var = pick_variant(a.shape[-1], variant)
    m_t, x_t, pmm_t, pms_t = _operands(m_vals, x, pmm, pms, a.device)
    a = a.to(torch.float32).contiguous()
    if route == "cpu":
        return kref.synth_ref(a, m_t, x_t, pmm_t, pms_t, l_max=l_max,
                              fold=fold)
    from repro_torch.kernels import legendre_cuda
    kernel = legendre_cuda.synth_vpu if var == "vpu" \
        else legendre_cuda.synth_mxu
    return kernel(a, m_t, x_t, pmm_t, pms_t, l_max=l_max, fold=fold)


def anal(dw, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False,
         variant: str | None = None) -> torch.Tensor:
    """Kernel-backed analysis: a_lm = sum_r dw_m(r) P_lm(x_r).

    dw (Mp, P, R, 2K) f32 weighted Delta (P = 2 (even, odd) if fold).
    Returns (Mp, l_max+1, 2K) f32.
    """
    route = _route(dw.device)
    var = pick_variant(dw.shape[-1], variant)
    m_t, x_t, pmm_t, pms_t = _operands(m_vals, x, pmm, pms, dw.device)
    dw = dw.to(torch.float32).contiguous()
    if route == "cpu":
        return kref.anal_ref(dw, m_t, x_t, pmm_t, pms_t, l_max=l_max,
                             fold=fold)
    from repro_torch.kernels import legendre_cuda
    kernel = legendre_cuda.anal_vpu if var == "vpu" \
        else legendre_cuda.anal_mxu
    return kernel(dw, m_t, x_t, pmm_t, pms_t, l_max=l_max, fold=fold)


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


# ---------------------------------------------------------------------------
# packed-layout conversion (kernels.pack <-> the plain (Mp, L1/R) world)
# ---------------------------------------------------------------------------


def _index(name: str, device: torch.device, build, cache):
    """The (index, mask) tensors ``build()`` gives, on ``device``; kept in
    ``cache`` under (name, device type, device index) when one is given.
    The caller's cache belongs to one layout."""
    key = ("index", name, device.type, device.index)
    if cache is not None and key in cache:
        return cache[key]
    idx, mask = build()
    out = (torch.as_tensor(idx, dtype=torch.int64, device=device),
           torch.as_tensor(mask, dtype=torch.bool, device=device))
    if cache is not None:
        cache[key] = out
    return out


def _masked_take(src, idx, mask, shape):
    """``src[idx]`` along dim 0, zero where ``mask`` is False."""
    out = src.index_select(0, idx)
    mask = mask.reshape((-1,) + (1,) * (out.ndim - 1))
    out = torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                             device=out.device))
    return out.reshape(shape)


def _pack_maps(lo, device):
    """The five per-slot maps (m0, m1, mp0, mp1, seed) as i32 tensors."""
    def t(v):
        return torch.as_tensor(np.ascontiguousarray(v), dtype=torch.int32,
                               device=device)
    return (t(lo.slot_m[:, 0]), t(lo.slot_m[:, 1]), t(lo.slot_mp[:, 0]),
            t(lo.slot_mp[:, 1]), t(lo.slot_seed))


def _pack_a(a, lo, cache=None):
    """(Mp, L1, 2K) coefficients -> (n_slots, S, 2K) packed l-streams."""
    Mp, L1, K2 = a.shape

    def build():
        valid = (lo.a_row >= 0) & (lo.a_l < L1)
        idx = np.where(valid, lo.a_row * L1 + np.maximum(lo.a_l, 0), 0)
        return idx.reshape(-1), valid.reshape(-1)

    idx, mask = _index(f"a{L1}", a.device, build, cache)
    return _masked_take(a.reshape(Mp * L1, K2), idx, mask,
                        (lo.n_slots, lo.S, K2))


def _slot_rows(lo):
    return np.maximum(lo.slot_row, 0).reshape(-1), \
        (lo.slot_row >= 0).reshape(-1)


def _pack_rows(arr, lo, cache=None):
    """(Mp, ...) per-row operand -> (n_slots, 2, ...) per-segment; empty
    segments are zero."""
    idx, mask = _index("rows", arr.device, lambda: _slot_rows(lo), cache)
    return _masked_take(arr, idx, mask,
                        (lo.n_slots, 2) + tuple(arr.shape[1:]))


def _unpack_rows(seg, lo, n_rows, cache=None):
    """(n_slots * 2, ...) per-segment results -> (n_rows, ...) plain rows
    (plan-padding rows come back as zeros)."""
    idx, mask = _index(
        "row_dst", seg.device,
        lambda: (np.maximum(lo.row_dst, 0), lo.row_dst >= 0), cache)
    return _masked_take(seg, idx, mask, (n_rows,) + tuple(seg.shape[1:]))


def _unpack_alm(packed, lo, cache=None):
    """(n_slots, S, 2K) packed l-stream rows -> (n_rows, l_max + 1, 2K)."""
    K2 = packed.shape[-1]
    idx, mask = _index(
        "alm_src", packed.device,
        lambda: (np.maximum(lo.alm_src, 0).reshape(-1),
                 (lo.alm_src >= 0).reshape(-1)), cache)
    return _masked_take(packed.reshape(lo.n_slots * lo.S, K2), idx, mask,
                        (lo.n_rows, lo.l_max + 1, K2))
