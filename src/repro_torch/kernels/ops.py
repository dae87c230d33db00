"""The Legendre-stage seam: variant and layout choice, CPU / CUDA
dispatch, the adjoint pairs, and the packed-layout conversions.

Counterpart of the staged and packing parts of ``repro.kernels.ops``.
``synth`` and ``anal`` take the unpadded layouts (the CUDA kernels mask the
ragged ring edge themselves, so nothing is padded to the TPU's 128-lane
tiles):

  synth: a (Mp, L1, 2K) f32 -> Delta (Mp, P, R, 2K) f32;
  anal:  dw (Mp, P, R, 2K) f32 -> (Mp, l_max+1, 2K) f32.

``layout="plain"`` runs the rectangular (row, l) grid, ``"packed"`` the
triangular m-pair slot grid of ``kernels.pack`` (two rows per slot, so
every slot walks a near-constant number of steps).  ``mp_vals`` (one m' per
row, e.g. the stacked rows of :func:`spin_rows`) runs the kernels' spin
branch on either layout: the Wigner-d rows of the spin-2 transforms, fold
off.  A CPU tensor runs the
plain version (``kernels.ref``); a CUDA tensor launches the hand-written
kernel (``kernels.legendre_cuda`` for plain, ``kernels.fused_cuda`` for
packed) or raises; any other device raises.  Each direction is
differentiable: its backward is the other direction with the same seeds,
variant and layout (``core.autodiff.linear_pair``).  The stage-1
adapters of the distributed transform (:func:`delta_from_alm_auto`,
:func:`alm_from_delta_auto` and their spin twins) run a rank's dealt m rows
over every plan ring slot through :func:`synth` / :func:`anal`, on the
layout and variant their caller names.

Variant choice (:func:`pick_variant`) takes the reference's override
under the port's own name, ``$REPRO_TORCH_LEGENDRE_VARIANT`` (``vpu`` |
``mxu``).  The reference's measured variant choice and layout override
are not ported: ``make_plan(mode="auto")`` measures at the plan's own
shape, and a layout is always named (see ROADMAP.md).

The packing helpers (``_pack_a``, ``_pack_rows``, ``_unpack_rows``,
``_unpack_alm``, ``_pack_maps``) convert between the plain (row, ...)
world and a ``kernels.pack.PackedLayout``'s (slot, segment | stream
position) world with ``index_select`` gathers on the operand's device.
Each takes an optional ``cache`` dict (a plan's store) that keeps its
index tensors per (layout, device) for as long as the caller keeps it;
without one they are built per call.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from repro_torch.core import legendre
from repro_torch.core.autodiff import linear_pair
from repro_torch.kernels import pack as kpack
from repro_torch.kernels import ref as kref

__all__ = ["synth", "anal", "pick_variant", "pick_layout", "spin_rows",
           "delta_from_alm_auto", "alm_from_delta_auto",
           "delta_from_alm_spin_auto", "alm_from_delta_spin_auto"]

#: the panel length of the packed and fused layouts (the reference's
#: default, ``kernels.fused.FUSED_LP_SIZE``)
PACK_LP_SIZE = 128


def pick_variant(K2: int, variant: str | None = None) -> str:
    """vpu-vs-mxu: the explicit argument, else
    ``$REPRO_TORCH_LEGENDRE_VARIANT``, else the static ``K2 >= 16`` rule
    (broadcast FMA for few maps, panel contraction for many)."""
    if variant in ("vpu", "mxu"):
        return variant
    if variant is not None:
        raise ValueError(f"unknown Legendre variant {variant!r}")
    env = os.environ.get("REPRO_TORCH_LEGENDRE_VARIANT")
    if env in ("vpu", "mxu"):
        return env
    return "mxu" if K2 >= 16 else "vpu"


def pick_layout(layout: str) -> str:
    """packed-vs-plain: the staged layout named, checked.  ``"fused"`` is
    refused: the fused Legendre+phase pipeline dispatches at the plan level
    (``make_plan(layout="fused")``), not through these staged wrappers.

    The reference's ``pick_layout`` returns ``"packed"`` when no layout is
    named and takes a debugging override from the environment; the port
    names one everywhere instead (:func:`synth` / :func:`anal` default to
    ``"plain"``, and a plan runs fused where eligible, else plain), so
    there is no unnamed staged layout here and nothing to override.
    """
    if layout in ("plain", "packed"):
        return layout
    if layout == "fused":
        raise ValueError("the staged wrappers ops.synth / ops.anal cannot "
                         "run the fused layout: it dispatches at the plan "
                         "level (make_plan(layout='fused'))")
    raise ValueError(f"unknown Legendre layout {layout!r}")


def spin_rows(m_vals):
    """The rows of the two spin-2 recurrences: (m2, mp2), each (2M,) int32
    numpy, [m' = -2 | m' = +2] (``core.legendre._spin_rows``)."""
    return legendre._spin_rows(m_vals)


def _operands(m_vals, x, pmm, pms, device, mp_vals=None):
    """The seed operands, and m' per row (None for the scalar rows), as
    contiguous tensors of the kernels' dtypes."""
    def t(v, dtype):
        return torch.as_tensor(v, device=device).to(dtype).contiguous()
    return (t(m_vals, torch.int32), t(x, torch.float32),
            t(pmm, torch.float32), t(pms, torch.int32),
            None if mp_vals is None else t(mp_vals, torch.int32))


def _route(device: torch.device) -> str:
    if device.type in ("cpu", "cuda"):
        return device.type
    raise ValueError(f"the Legendre kernels run on CUDA tensors and their "
                     f"plain versions on CPU tensors; got a {device.type} "
                     "tensor")


#: serialises the first build of each stored entry: one plan's store can be
#: filled from two threads at once (a warm-up beside a served batch)
_STORE_LOCK = threading.RLock()
_MISSING = object()


def _stored(store, key, build):
    """``build()``, kept in the caller's ``store`` dict when one is given.

    An entry is built once, under a lock, and published only when the
    device work behind its CUDA tensors is done: a thread that reads it
    may launch on another stream than the one that built it."""
    if store is None:
        return build()
    value = store.get(key, _MISSING)
    if value is _MISSING:
        with _STORE_LOCK:
            value = store.get(key, _MISSING)
            if value is _MISSING:
                value = build()
                _settle(value)
                store[key] = value
    return value


def _settle(value) -> None:
    """Wait for the work queued on the current stream behind the CUDA
    tensors of ``value`` (a tensor, or tuples of them)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.current_stream(value.device).synchronize()
    elif isinstance(value, (tuple, list)):
        for v in value:
            _settle(v)


def _host_rows(m_vals) -> np.ndarray:
    if isinstance(m_vals, torch.Tensor):
        return m_vals.detach().cpu().numpy()
    return np.asarray(m_vals)


def _resolve_layout(m_vals, layout, l_max, store=None, mp_vals=None):
    """The packed layout object of the row set (the spin slot layout with
    ``mp_vals``), or None for the plain grid; kept in ``store`` under
    ``"layout"``."""
    if pick_layout(layout) != "packed":
        return None

    def build():
        lo = kpack.build_layout(
            _host_rows(m_vals), l_max, lp_size=PACK_LP_SIZE,
            mp_vals=None if mp_vals is None else _host_rows(mp_vals))
        if lo is None:
            raise ValueError("the packed layout needs at least one live row "
                             "(m >= 0) and every row's max(m, |m'|) <= "
                             "l_max")
        return lo

    return _stored(store, "layout", build)


def _prep(lo, x, pmm, pms, store=None):
    """Per-slot packing shared by both directions of the packed and fused
    layouts: the five slot maps, x, and the per-segment seeds (n_slots, 2,
    R), on x's device; kept in ``store`` under ``"prep"``."""
    dev = x.device

    def build():
        def rows(v):
            return _pack_rows(torch.as_tensor(v, device=dev), lo,
                              cache=store).contiguous()

        return (_pack_maps(lo, dev), x.to(torch.float32).contiguous(),
                rows(pmm), rows(pms))

    return _stored(store, "prep", build)


def _synth_exec(a, m_t, x_t, pmm_t, pms_t, mp_t, *, l_max, fold, var, lo,
                store):
    """Synthesis with the layout and variant decided (``lo`` the packed
    layout, or None for plain; ``mp_t`` m' per row, or None)."""
    if lo is not None:
        return _synth_packed(a, lo, x_t, pmm_t, pms_t, l_max=l_max,
                             fold=fold, var=var, store=store)
    if _route(a.device) == "cpu":
        return kref.synth_ref(a, m_t, x_t, pmm_t, pms_t, l_max=l_max,
                              fold=fold, mp_vals=mp_t)
    from repro_torch.kernels import legendre_cuda
    kernel = getattr(legendre_cuda, f"synth_{var}")
    return kernel(a, m_t, x_t, pmm_t, pms_t, l_max=l_max, fold=fold,
                  mp_vals=mp_t)


def _anal_exec(dw, m_t, x_t, pmm_t, pms_t, mp_t, *, l_max, fold, var, lo,
               store):
    """Analysis with the layout and variant decided."""
    if lo is not None:
        return _anal_packed(dw, lo, x_t, pmm_t, pms_t, l_max=l_max,
                            fold=fold, var=var, store=store)
    if _route(dw.device) == "cpu":
        return kref.anal_ref(dw, m_t, x_t, pmm_t, pms_t, l_max=l_max,
                             fold=fold, mp_vals=mp_t)
    from repro_torch.kernels import legendre_cuda
    kernel = getattr(legendre_cuda, f"anal_{var}")
    return kernel(dw, m_t, x_t, pmm_t, pms_t, l_max=l_max, fold=fold,
                  mp_vals=mp_t)


def _synth_packed(a, lo, x, pmm, pms, *, l_max, fold, var, store):
    """Packed synthesis: pack a into slot streams, run the packed kernel
    (or its plain version), unpack the (slot, segment) planes into rows."""
    Mp, _, K2 = a.shape
    R, P = x.shape[0], (2 if fold else 1)
    maps, x, pmm_pk, pms_pk = _prep(lo, x, pmm, pms, store)
    a_pk = _pack_a(a, lo, cache=store).contiguous()
    if _route(a.device) == "cpu":
        out = kref.synth_packed_ref(a_pk, maps, x, pmm_pk, pms_pk,
                                    l_max=l_max, fold=fold, layout=var,
                                    spin=lo.spin)
    else:
        from repro_torch.kernels import fused_cuda
        kernel = getattr(fused_cuda, f"synth_packed_{var}")
        out = kernel(a_pk, maps, x, pmm_pk, pms_pk, l_max=l_max, fold=fold,
                     spin=lo.spin)
    if var == "vpu":
        out = out.movedim(2, -1)                 # (n_slots, Q, R, 2K)
    seg = out.reshape(lo.n_slots * 2, P, R, K2)
    return _unpack_rows(seg, lo, Mp, cache=store)


def _anal_packed(dw, lo, x, pmm, pms, *, l_max, fold, var, store):
    """Packed analysis: gather each slot's (segment, parity) planes, run
    the packed kernel (or its plain version), unpack the l-streams."""
    _, P, R, K2 = dw.shape
    maps, x, pmm_pk, pms_pk = _prep(lo, x, pmm, pms, store)
    dw_pk = _pack_rows(dw, lo, cache=store).reshape(lo.n_slots, 2 * P, R,
                                                     K2)
    if var == "vpu":
        dw_pk = dw_pk.movedim(-1, 2)             # (n_slots, Q, 2K, R)
    dw_pk = dw_pk.contiguous()
    if _route(dw.device) == "cpu":
        out = kref.anal_packed_ref(dw_pk, maps, x, pmm_pk, pms_pk,
                                   l_max=l_max, s_len=lo.S, layout=var,
                                   spin=lo.spin)
    else:
        from repro_torch.kernels import fused_cuda
        kernel = getattr(fused_cuda, f"anal_packed_{var}")
        out = kernel(dw_pk, maps, x, pmm_pk, pms_pk, l_max=l_max,
                     s_len=lo.S, spin=lo.spin)
    return _unpack_alm(out, lo, cache=store)


def _pair(direction, op, m_vals, x, pmm, pms, *, l_max, fold, variant,
          layout, store, mp_vals):
    """One direction of the seam as a linear pair: the backward of synth is
    anal with the same seeds, rows, variant and layout, and the reverse."""
    _route(op.device)
    rows = l_max + 1 if direction == "synth" else (2 if fold else 1)
    if op.ndim != (3 if direction == "synth" else 4) or op.shape[1] != rows:
        what = "coefficient rows" if direction == "synth" else "planes"
        raise ValueError(f"{direction}: expected {rows} {what} (l_max "
                         f"{l_max}, fold {fold}), got shape "
                         f"{tuple(op.shape)}")
    if fold and mp_vals is not None:
        raise ValueError("fold is not supported for spin transforms "
                         "(mp_vals)")
    var = pick_variant(op.shape[-1], variant)
    lo = _resolve_layout(m_vals, layout, l_max, store, mp_vals)
    m_t, x_t, pmm_t, pms_t, mp_t = _operands(m_vals, x, pmm, pms, op.device,
                                             mp_vals)
    kw = dict(l_max=l_max, fold=fold, var=var, lo=lo, store=store)
    fns = {"synth": _synth_exec, "anal": _anal_exec}
    other = "anal" if direction == "synth" else "synth"

    def fwd(_, v):
        return fns[direction](v.to(torch.float32).contiguous(), m_t, x_t,
                              pmm_t, pms_t, mp_t, **kw)

    def bwd(_, g):
        return fns[other](g.contiguous(), m_t, x_t, pmm_t, pms_t, mp_t, **kw)

    return linear_pair(fwd, bwd, {"m_vals": m_vals, "x": x, "pmm": pmm,
                                  "pms": pms, "mp_vals": mp_vals}, op)


def synth(a, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False,
          variant: str | None = None, layout: str = "plain",
          store: dict | None = None, mp_vals=None) -> torch.Tensor:
    """Kernel-backed synthesis: Delta_m(r) = sum_l a_lm P_lm(x_r).

    a (Mp, l_max+1, 2K) f32; m_vals (Mp,) int (-1 rows are padding and give
    zeros); x (R,) f32 cos(theta); pmm/pms (Mp, R) seeds from
    ``ref.prepare_seeds``.  ``mp_vals`` (Mp,) int, m' per row, runs the spin
    branch (the lambda^{(m')}_{l,m} rows, seeds from
    ``ref.prepare_seeds_spin``, fold off).  ``layout``: ``"plain"`` (the
    default) or ``"packed"``.  ``store``: a dict the caller keeps for one
    row set and device, to reuse the packed layout, seeds and gather
    indices across calls.  Returns (Mp, P, R, 2K) f32, P = 2 if fold.
    Differentiable: the backward is :func:`anal` with the same seeds, rows,
    variant and layout.
    """
    return _pair("synth", a, m_vals, x, pmm, pms, l_max=l_max, fold=fold,
                 variant=variant, layout=layout, store=store,
                 mp_vals=mp_vals)


def anal(dw, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False,
         variant: str | None = None, layout: str = "plain",
         store: dict | None = None, mp_vals=None) -> torch.Tensor:
    """Kernel-backed analysis: a_lm = sum_r dw_m(r) P_lm(x_r).

    dw (Mp, P, R, 2K) f32 weighted Delta (P = 2 (even, odd) if fold); the
    rest as :func:`synth`.  Returns (Mp, l_max+1, 2K) f32, exact zeros
    where l < m (l < max(m, |m'|) with ``mp_vals``).  Differentiable: the
    backward is :func:`synth` with the same seeds, rows, variant and
    layout.
    """
    return _pair("anal", dw, m_vals, x, pmm, pms, l_max=l_max, fold=fold,
                 variant=variant, layout=layout, store=store,
                 mp_vals=mp_vals)


# ---------------------------------------------------------------------------
# stage-1 adapters of the distributed transform (core.dist_sht)
# ---------------------------------------------------------------------------


def _adapter_seeds(m_vals, geom, *, fold, device, store, log_mu_all=None,
                   m_max=None):
    """(rows, x, pmm, pms, m' rows or None) of a rank's m rows over the plan
    ring slots ``geom`` (``SHTPlan.ring_geometry``), on ``device``: the
    scalar seeds with ``log_mu_all``, else the spin-2 rows (``spin_rows``)
    and their seeds; fold seeds the northern slot of each ring pair.  Kept
    in ``store`` under ``"adapter_seeds"``."""
    def build():
        sel = slice(None, None, 2) if fold else slice(None)
        x = np.asarray(geom["cos_theta"])[sel]
        sin = np.asarray(geom["sin_theta"])[sel]
        if log_mu_all is not None:
            rows, mp = _host_rows(m_vals), None
            pmm, pms = kref.prepare_seeds(rows, sin, log_mu_all)
        else:
            rows, mp = spin_rows(_host_rows(m_vals))
            pmm, pms = kref.prepare_seeds_spin(rows, mp, x, sin, m_max=m_max)
        return _operands(rows, x, pmm, pms, device, mp)

    return _stored(store, "adapter_seeds", build)


def delta_from_alm_auto(a_re, a_im, m_vals, geom, log_mu_all, *, l_max: int,
                        fold: bool = False, dtype=torch.float32,
                        variant: str | None = None, layout: str = "plain",
                        store: dict | None = None):
    """Stage-1 synthesis of a rank's m rows through the kernels.

    a_re / a_im (M, l_max+1, K) on one device; m_vals (M,) the rank's
    global m per row (-1: padding, zeros out); geom the plan's
    ``ring_geometry`` (numpy).  Returns (d_re, d_im), each (M, R_pad, K)
    in plan slot order and ``dtype``.  The kernels compute in float32;
    ``fold`` runs them on each ring pair's northern slot and recombines
    the even and odd parts into the pair's two slots.  ``variant`` and
    ``layout`` (``"plain"``, the default, or ``"packed"``) are the
    caller's: the variant is not picked here from this call's K.
    ``store``: a dict the caller keeps for this row set and device (seeds,
    packed layout, gather indices).  Differentiable (:func:`synth`).
    """
    M, _, K = a_re.shape
    m_t, x_t, pmm, pms, _ = _adapter_seeds(
        m_vals, geom, fold=fold, device=a_re.device, store=store,
        log_mu_all=log_mu_all)
    a = torch.cat([a_re, a_im], dim=-1).to(torch.float32)
    out = synth(a, m_t, x_t, pmm, pms, l_max=l_max, fold=fold,
                variant=variant, layout=layout, store=store)  # (M, P, R', 2K)
    if fold:
        e, o = out[:, 0], out[:, 1]
        out2 = torch.stack([e + o, e - o], dim=2).reshape(
            M, 2 * e.shape[1], 2 * K)
    else:
        out2 = out[:, 0]
    return out2[..., :K].to(dtype), out2[..., K:].to(dtype)


def alm_from_delta_auto(dw_re, dw_im, m_vals, geom, log_mu_all, *,
                        l_max: int, fold: bool = False, dtype=torch.float32,
                        variant: str | None = None, layout: str = "plain",
                        store: dict | None = None):
    """Stage-1 analysis of a rank's m rows through the kernels: weighted
    dw_re / dw_im (M, R_pad, K) in plan slot order -> (a_re, a_im), each
    (M, l_max+1, K) in ``dtype``; with ``fold`` each ring pair is summed
    into its (north + south, north - south) planes.  The rest as
    :func:`delta_from_alm_auto`.  Differentiable (:func:`anal`)."""
    K = dw_re.shape[-1]
    m_t, x_t, pmm, pms, _ = _adapter_seeds(
        m_vals, geom, fold=fold, device=dw_re.device, store=store,
        log_mu_all=log_mu_all)
    dw = torch.cat([dw_re, dw_im], dim=-1).to(torch.float32)
    if fold:
        n, s = dw[:, 0::2], dw[:, 1::2]
        dwk = torch.stack([n + s, n - s], dim=1)          # (M, 2, Rn, 2K)
    else:
        dwk = dw[:, None]
    out = anal(dwk.contiguous(), m_t, x_t, pmm, pms, l_max=l_max, fold=fold,
               variant=variant, layout=layout, store=store)
    return out[..., :K].to(dtype), out[..., K:].to(dtype)


def delta_from_alm_spin_auto(e_re, e_im, b_re, b_im, m_vals, geom, *,
                             l_max: int, m_max: int, dtype=torch.float32,
                             variant: str | None = None,
                             layout: str = "plain",
                             store: dict | None = None):
    """Spin-2 stage-1 synthesis of a rank's m rows through the kernels'
    spin branch: (E, B) parts, each (M, l_max+1, K) -> (dq_re, dq_im,
    du_re, du_im), each (M, R_pad, K) in ``dtype``.  The 2M rows
    [m' = -2 | +2] (:func:`spin_rows`); fold off.  The rest as
    :func:`delta_from_alm_auto` (``store``: one per row set, apart from
    the scalar rows')."""
    K = e_re.shape[-1]
    m2, x_t, pmm, pms, mp2 = _adapter_seeds(
        m_vals, geom, fold=False, device=e_re.device, store=store,
        m_max=m_max)
    a2_re, a2_im = legendre.spin_pack_alm(e_re, e_im, b_re, b_im)
    a = torch.cat([a2_re, a2_im], dim=-1).to(torch.float32)
    out = synth(a, m2, x_t, pmm, pms, l_max=l_max, variant=variant,
                layout=layout, store=store, mp_vals=mp2)  # (2M, 1, R, 2K)
    flat = out[:, 0]
    return legendre.spin_unpack_delta(flat[..., :K].to(dtype),
                                      flat[..., K:].to(dtype))


def alm_from_delta_spin_auto(dq_re, dq_im, du_re, du_im, m_vals, geom, *,
                             l_max: int, m_max: int, dtype=torch.float32,
                             variant: str | None = None,
                             layout: str = "plain",
                             store: dict | None = None):
    """Spin-2 stage-1 analysis of a rank's m rows: weighted (Delta_Q,
    Delta_U) parts, each (M, R_pad, K) -> (e_re, e_im, b_re, b_im), each
    (M, l_max+1, K) in ``dtype``.  The rest as
    :func:`delta_from_alm_spin_auto`."""
    K = dq_re.shape[-1]
    m2, x_t, pmm, pms, mp2 = _adapter_seeds(
        m_vals, geom, fold=False, device=dq_re.device, store=store,
        m_max=m_max)
    d2_re, d2_im = legendre.spin_pack_delta(dq_re, dq_im, du_re, du_im)
    dw = torch.cat([d2_re, d2_im], dim=-1).to(torch.float32)
    out = anal(dw[:, None].contiguous(), m2, x_t, pmm, pms, l_max=l_max,
               variant=variant, layout=layout, store=store, mp_vals=mp2)
    return legendre.spin_unpack_alm(out[..., :K].to(dtype),
                                    out[..., K:].to(dtype))


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


# ---------------------------------------------------------------------------
# packed-layout conversion (kernels.pack <-> the plain (Mp, L1/R) world)
# ---------------------------------------------------------------------------


def _index(name: str, device: torch.device, build, cache):
    """The (index, mask) tensors ``build()`` gives, on ``device``; kept in
    ``cache`` under (name, device type, device index) when one is given.
    The caller's cache belongs to one layout."""
    def tensors():
        idx, mask = build()
        return (torch.as_tensor(idx, dtype=torch.int64, device=device),
                torch.as_tensor(mask, dtype=torch.bool, device=device))

    return _stored(cache, ("index", name, device.type, device.index),
                   tensors)


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
