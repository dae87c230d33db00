"""Normalised associated Legendre functions by the scaled recurrence (torch).

Counterpart of the scalar part of ``repro.core.legendre``:

    P_{l,m}(x) = beta_{l,m} x P_{l-1,m}(x) - (beta_{l,m}/beta_{l-1,m}) P_{l-2,m}(x)
    beta_{l,m} = sqrt((4 l^2 - 1) / (l^2 - m^2))

seeded at P_mm = mu_m sin(theta)^m and P_{m+1,m} = sqrt(2m+3) x P_mm.  Every
value is carried as a (mantissa, scale) pair, P = mant * 2^(scale * bits),
renormalised with selects; values with scale < 0 are below the dtype's
resolution and contribute nothing.

This is the oracle behind the ``torch`` plan backend (float64, or float32
with 64 scale bits).  The float32 kernels' own schedule lives in
``repro_torch.kernels.ref``.  The four stages are differentiable through
their adjoints (``core.autodiff``): the backward of synthesis is analysis
with unit weights, that of analysis with weights w is w times synthesis.
Spin (Wigner-d) rows wait for ROADMAP.md Open items section 1, item 7.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.autodiff import linear_pair

__all__ = [
    "scale_bits_for", "log_mu", "pmm_scaled", "recurrence_step",
    "delta_from_alm", "alm_from_delta",
    "delta_from_alm_folded", "alm_from_delta_folded",
]

_LN2 = float(np.log(2.0))


def scale_bits_for(dtype) -> int:
    """Scale bits of the recurrence for a dtype (512 f64, 64 f32)."""
    if dtype == torch.float64:
        return 512
    if dtype == torch.float32:
        return 64
    raise ValueError(f"unsupported recurrence dtype {dtype}")


def log_mu(m_max: int) -> np.ndarray:
    """log(mu_m) for m = 0..m_max, host float64 (cumulative sum of logs)."""
    m = np.arange(1, m_max + 1, dtype=np.float64)
    inc = 0.5 * np.log((2.0 * m + 1.0) / (2.0 * m))
    out = np.empty(m_max + 1, dtype=np.float64)
    out[0] = -0.5 * np.log(4.0 * np.pi)
    out[1:] = out[0] + np.cumsum(inc)
    return out


def pmm_scaled(log_mu_m, m, sin_theta, *, dtype, scale_bits: int):
    """Scaled seed P_mm = mu_m sin(theta)^m as (mantissa, scale).

    Evaluated in float64 and cast at the end; ``scale`` is rounded (not
    floored) so any representable P gets scale 0 exactly.
    """
    log_p = log_mu_m + m * torch.log(sin_theta)
    denom = scale_bits * _LN2
    scale = torch.clamp(torch.round(log_p / denom), max=0.0)
    mant = torch.exp(log_p - scale * denom)
    return mant.to(dtype), scale.to(torch.int32)


def _beta(l, m):
    """beta_{l,m}; the caller guarantees l > m."""
    return torch.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))


def recurrence_step(l: int, m, x, mant_prev, mant_curr, scale, pmm_mant,
                    pmm_scale, *, scale_bits: int):
    """One step of the scaled recurrence at multipole ``l``.

    ``m`` is (M, 1) in the working dtype, ``x`` (1, R); carries (M, R).
    Returns (new_prev, new_curr, new_scale, value), ``value`` the descaled
    P_{l,m} (zero where scale < 0 or l < m).
    """
    fdt = mant_curr.dtype
    lf = torch.tensor(float(l), dtype=fdt, device=m.device)
    zero = torch.zeros((), dtype=fdt, device=m.device)

    def safe(v):
        return torch.where(torch.isfinite(v), v, zero)

    bl = safe(_beta(torch.maximum(lf, m + 2.0), m))
    blm1 = safe(_beta(torch.maximum(lf - 1.0, m + 1.0), m))
    ratio = torch.where(blm1 > 0,
                        bl / torch.where(blm1 > 0, blm1, torch.ones_like(blm1)),
                        zero)
    two_m_p3 = torch.sqrt(torch.clamp(2.0 * m + 3.0, min=0.0))

    p_rec = bl * x * mant_curr - ratio * mant_prev
    p_first = two_m_p3 * x * mant_curr
    is_seed = lf == m
    is_first = lf == m + 1.0
    before = lf < m

    new_curr = torch.where(before, zero,
                           torch.where(is_seed, pmm_mant,
                                       torch.where(is_first, p_first, p_rec)))
    new_prev = torch.where(before | is_seed, zero, mant_curr)
    new_scale = torch.where(is_seed, pmm_scale, scale)

    big = 2.0 ** (scale_bits // 2)
    grow = (new_curr.abs() > big) & (new_scale < 0)
    new_curr = torch.where(grow, new_curr * 2.0 ** (-scale_bits), new_curr)
    new_prev = torch.where(grow, new_prev * 2.0 ** (-scale_bits), new_prev)
    new_scale = torch.where(grow, new_scale + 1, new_scale)
    small = ((new_curr.abs() < 1.0 / big) & (new_prev.abs() < 1.0 / big)
             & (new_scale > -32000) & ~before & ~is_seed)
    new_curr = torch.where(small, new_curr * 2.0 ** scale_bits, new_curr)
    new_prev = torch.where(small, new_prev * 2.0 ** scale_bits, new_prev)
    new_scale = torch.where(small, new_scale - 1, new_scale)

    value = torch.where((new_scale == 0) & ~before, new_curr, zero)
    return new_prev, new_curr, new_scale, value


def _prep(m_vals, grid_x, grid_sin, log_mu_all, dtype, device):
    """(m (M,1) dtype, x (1,R), seeds) for the engine loops."""
    m_np = np.asarray(m_vals)
    m = torch.as_tensor(m_np, dtype=dtype, device=device)[:, None]
    x = torch.as_tensor(np.asarray(grid_x), dtype=dtype, device=device)[None, :]
    lm = torch.as_tensor(np.asarray(log_mu_all, np.float64)[np.maximum(m_np, 0)],
                         device=device)[:, None]
    sin = torch.as_tensor(np.asarray(grid_sin, np.float64), device=device)
    sb = scale_bits_for(dtype)
    pmm, pms = pmm_scaled(lm, m.to(torch.float64), sin[None, :], dtype=dtype,
                          scale_bits=sb)
    return m, x, pmm, pms, sb


def _zeros_carry(M, R, dtype, device):
    return (torch.zeros(M, R, dtype=dtype, device=device),
            torch.zeros(M, R, dtype=dtype, device=device),
            torch.zeros(M, R, dtype=torch.int32, device=device))


def _delta_impl(a_re, a_im, m_vals, grid_x, grid_sin, log_mu_all, *,
                l_max: int):
    dtype, device = a_re.dtype, a_re.device
    m, x, pmm, pms, sb = _prep(m_vals, grid_x, grid_sin, log_mu_all, dtype,
                               device)
    M, R, K = m.shape[0], x.shape[1], a_re.shape[-1]
    pp, pc, sc = _zeros_carry(M, R, dtype, device)
    d_re = torch.zeros(M, R, K, dtype=dtype, device=device)
    d_im = torch.zeros_like(d_re)
    for l in range(l_max + 1):
        pp, pc, sc, val = recurrence_step(l, m, x, pp, pc, sc, pmm, pms,
                                          scale_bits=sb)
        d_re = d_re + val[..., None] * a_re[:, l][:, None, :]
        d_im = d_im + val[..., None] * a_im[:, l][:, None, :]
    return d_re, d_im


def _alm_impl(dw_re, dw_im, m_vals, grid_x, grid_sin, log_mu_all, *,
              l_max: int):
    dtype, device = dw_re.dtype, dw_re.device
    m, x, pmm, pms, sb = _prep(m_vals, grid_x, grid_sin, log_mu_all, dtype,
                               device)
    pp, pc, sc = _zeros_carry(m.shape[0], x.shape[1], dtype, device)
    rows_re, rows_im = [], []
    for l in range(l_max + 1):
        pp, pc, sc, val = recurrence_step(l, m, x, pp, pc, sc, pmm, pms,
                                          scale_bits=sb)
        rows_re.append(torch.einsum("mr,mrk->mk", val, dw_re))
        rows_im.append(torch.einsum("mr,mrk->mk", val, dw_im))
    return torch.stack(rows_re, dim=1), torch.stack(rows_im, dim=1)


# Equator-folded variants: P_lm(-x) = (-1)^(l+m) P_lm(x), so on a grid
# symmetric about the equator the recurrence runs over the northern rings
# only; Delta(north) = E + O, Delta(mirror) = E - O with E/O the even/odd
# (l+m) partial sums.


def _parity_even(l: int, m):
    """(M, 1, 1) bool: (l + m) even."""
    return ((l + m.to(torch.int64)) % 2 == 0)[..., None]


def _delta_folded_impl(a_re, a_im, m_vals, north_x, north_sin, log_mu_all,
                       *, l_max: int):
    dtype, device = a_re.dtype, a_re.device
    m, x, pmm, pms, sb = _prep(m_vals, north_x, north_sin, log_mu_all, dtype,
                               device)
    M, R, K = m.shape[0], x.shape[1], a_re.shape[-1]
    pp, pc, sc = _zeros_carry(M, R, dtype, device)
    acc = [torch.zeros(M, R, K, dtype=dtype, device=device) for _ in range(4)]
    zero = torch.zeros((), dtype=dtype, device=device)
    for l in range(l_max + 1):
        pp, pc, sc, val = recurrence_step(l, m, x, pp, pc, sc, pmm, pms,
                                          scale_bits=sb)
        cre = val[..., None] * a_re[:, l][:, None, :]
        cim = val[..., None] * a_im[:, l][:, None, :]
        even = _parity_even(l, m)
        acc[0] = acc[0] + torch.where(even, cre, zero)
        acc[1] = acc[1] + torch.where(even, cim, zero)
        acc[2] = acc[2] + torch.where(even, zero, cre)
        acc[3] = acc[3] + torch.where(even, zero, cim)
    return tuple(acc)


def _alm_folded_impl(s_e_re, s_e_im, s_o_re, s_o_im, m_vals, north_x,
                     north_sin, log_mu_all, *, l_max: int):
    dtype, device = s_e_re.dtype, s_e_re.device
    m, x, pmm, pms, sb = _prep(m_vals, north_x, north_sin, log_mu_all, dtype,
                               device)
    pp, pc, sc = _zeros_carry(m.shape[0], x.shape[1], dtype, device)
    rows_re, rows_im = [], []
    for l in range(l_max + 1):
        pp, pc, sc, val = recurrence_step(l, m, x, pp, pc, sc, pmm, pms,
                                          scale_bits=sb)
        even = _parity_even(l, m)
        sre = torch.where(even, s_e_re, s_o_re)
        sim = torch.where(even, s_e_im, s_o_im)
        rows_re.append(torch.einsum("mr,mrk->mk", val, sre))
        rows_im.append(torch.einsum("mr,mrk->mk", val, sim))
    return torch.stack(rows_re, dim=1), torch.stack(rows_im, dim=1)


# ---------------------------------------------------------------------------
# the public stages: linear pairs whose backward is the other direction
# ---------------------------------------------------------------------------


def _weights(weights, dtype, device):
    if isinstance(weights, torch.Tensor):
        return weights.to(dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(weights), dtype=dtype, device=device)


def delta_from_alm(a_re, a_im, m_vals, grid_x, grid_sin, log_mu_all, *,
                   l_max: int):
    """Synthesis Legendre stage: Delta_m(r) = sum_l a_lm P_lm(cos theta_r).

    a_re/a_im: (M, l_max+1, K) real tensors (rows l < m zero).  Returns
    (d_re, d_im), each (M, R, K), in the dtype of ``a_re``.
    Differentiable: the backward is the analysis with unit weights.
    """
    geo = (m_vals, grid_x, grid_sin, log_mu_all)

    def fwd(_, ops):
        return _delta_impl(*ops, *geo, l_max=l_max)

    def bwd(_, cts):
        return _alm_impl(*cts, *geo, l_max=l_max)

    return linear_pair(fwd, bwd, {"grid_x": grid_x, "grid_sin": grid_sin},
                       (a_re, a_im))


def alm_from_delta(d_re, d_im, m_vals, grid_x, grid_sin, weights, log_mu_all,
                   *, l_max: int):
    """Analysis Legendre stage: a_lm = sum_r w_r Delta_m(r) P_lm(cos theta_r).

    d_re/d_im: (M, R, K).  Returns (a_re, a_im), each (M, l_max+1, K).
    Differentiable: the backward is the weights times the synthesis of the
    cotangent.
    """
    geo = (m_vals, grid_x, grid_sin, log_mu_all)
    w = _weights(weights, d_re.dtype, d_re.device)[None, :, None]

    def fwd(_, ops):
        return _alm_impl(ops[0] * w, ops[1] * w, *geo, l_max=l_max)

    def bwd(_, cts):
        g_re, g_im = _delta_impl(*cts, *geo, l_max=l_max)
        return g_re * w, g_im * w

    return linear_pair(fwd, bwd, {"grid_x": grid_x, "grid_sin": grid_sin,
                                  "weights": weights}, (d_re, d_im))


def delta_from_alm_folded(a_re, a_im, m_vals, north_x, north_sin, log_mu_all,
                          *, l_max: int):
    """Folded synthesis: (e_re, e_im, o_re, o_im), each (M, R_north, K).
    Differentiable: the backward is the folded analysis of the even/odd
    cotangents (the parity split is its own transpose)."""
    geo = (m_vals, north_x, north_sin, log_mu_all)

    def fwd(_, ops):
        return _delta_folded_impl(*ops, *geo, l_max=l_max)

    def bwd(_, cts):
        return _alm_folded_impl(*cts, *geo, l_max=l_max)

    return linear_pair(fwd, bwd, {"north_x": north_x,
                                  "north_sin": north_sin}, (a_re, a_im))


def alm_from_delta_folded(s_e_re, s_e_im, s_o_re, s_o_im, m_vals, north_x,
                          north_sin, log_mu_all, *, l_max: int):
    """Folded analysis from the pre-folded weighted ring-pair sums
    (sum_e = north + mirror, sum_o = north - mirror), each (M, R_north, K).
    Returns (a_re, a_im), each (M, l_max+1, K).  Differentiable: the
    backward is the folded synthesis of the cotangent."""
    geo = (m_vals, north_x, north_sin, log_mu_all)

    def fwd(_, ops):
        return _alm_folded_impl(*ops, *geo, l_max=l_max)

    def bwd(_, cts):
        return _delta_folded_impl(*cts, *geo, l_max=l_max)

    return linear_pair(fwd, bwd, {"north_x": north_x,
                                  "north_sin": north_sin},
                       (s_e_re, s_e_im, s_o_re, s_o_im))
