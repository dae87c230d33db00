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

The Wigner-general layer (``spin_seeds_scaled``, ``recurrence_step_general``,
the ``*_general`` stages) runs the spin-weighted lambda^{(m')} rows of the
spin-2 transforms, seeded at l0 = max(m, |m'|); the ``spin_*`` helpers mix
the (E, B) / (Q, U) components into the stacked [m' = -2 | m' = +2] rows,
and :class:`HarmonicCore` is the one surface over spin 0 and spin 2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.autodiff import linear_pair

__all__ = [
    "scale_bits_for", "log_mu", "pmm_scaled", "recurrence_step",
    "delta_from_alm", "alm_from_delta",
    "delta_from_alm_folded", "alm_from_delta_folded",
    "log_factorials", "spin_seeds_scaled", "recurrence_step_general",
    "delta_from_alm_general", "alm_from_delta_general", "spin_pack_alm",
    "spin_unpack_delta", "spin_pack_delta", "spin_unpack_alm",
    "delta_from_alm_spin", "alm_from_delta_spin", "HarmonicCore",
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


# ===========================================================================
# The Wigner-general layer: spin-weighted rows for the spin-2 transforms.
#
# Rows carry (m, m') and run the spin-weighted functions
# lam^{(m')}_{l,m}(theta) (Wigner d^l_{m,-m'} up to normalisation; m' = 0
# is the scalar P_lm) by
#
#     lam_l = (a_l x + b_l) lam_{l-1} - c_l lam_{l-2},
#     l0  = max(m, |m'|),
#     D_l = sqrt((l^2 - m^2)(l^2 - m'^2)),
#     a_l = l sqrt(4l^2 - 1) / D_l,
#     b_l = -m m' sqrt(4l^2 - 1) / ((l-1) D_l),
#     c_l = sqrt((2l+1)/(2l-3)) l D_{l-1} / ((l-1) D_l),
#
# seeded at l0; c_{l0+1} holds D_{l0} = 0, so no first-step case is needed.
# The (mantissa, scale) carry is the scalar engine's.  Spin-2 transforms
# stack the m' = -2 and m' = +2 recurrences along the row axis, [-2 | +2],
# and mix the components with the spin_* helpers: a^+- = -(E +- iB),
# Delta^+- = Delta_Q +- i Delta_U.
# ===========================================================================


def log_factorials(n_max: int) -> np.ndarray:
    """log(n!) for n = 0..n_max, host float64 (cumulative sum of logs)."""
    out = np.zeros(n_max + 1, dtype=np.float64)
    if n_max >= 1:
        out[1:] = np.cumsum(np.log(np.arange(1, n_max + 1, dtype=np.float64)))
    return out


def spin_seeds_scaled(m_vals, mprime_vals, grid_x, grid_sin, logfact, *,
                      dtype, scale_bits: int, device=None):
    """Scaled seeds lam^{(m')}_{l0,m} as (mantissa, scale), l0 = max(m,
    |m'|), each (Ms, R), evaluated in float64 and cast at the end.

    ``m_vals``/``mprime_vals``: (Ms,) int (m < 0 rows are padding and get
    zero seeds); ``grid_x``/``grid_sin``: (R,) float64; ``logfact``: from
    :func:`log_factorials`, length >= 2 max(m) + 1.  |m'| is 0 or 2: rows
    with m >= |m'| take the closed form of d^j_{j,m'}, the |m'| = 2, m < 2
    rows their own O(1) closed forms (unscaled).
    """
    f64 = dict(dtype=torch.float64, device=device)
    m = torch.as_tensor(np.asarray(m_vals), dtype=torch.int64,
                        device=device)[:, None]
    mp = torch.as_tensor(np.asarray(mprime_vals), dtype=torch.int64,
                         device=device)[:, None]
    x = torch.as_tensor(np.asarray(grid_x, np.float64), **f64)[None, :]
    sin_t = torch.as_tensor(np.asarray(grid_sin, np.float64), **f64)[None, :]
    lf = torch.as_tensor(np.asarray(logfact, np.float64), **f64)
    mf, mpf = m.to(torch.float64), mp.to(torch.float64)

    # log cos(t/2), log sin(t/2) from x = cos t (grids never hit the poles)
    log_c = 0.5 * torch.log(torch.clamp((1.0 + x) / 2.0, min=1e-300))
    log_s = 0.5 * torch.log(torch.clamp((1.0 - x) / 2.0, min=1e-300))

    # the general m >= |m'| branch, in the log domain
    msafe = torch.clamp(m, min=0)

    def fact(v):
        return lf[torch.clamp(v, 0, lf.shape[0] - 1)]

    log_norm = 0.5 * (torch.log(2.0 * torch.clamp(mf, min=0.0) + 1.0)
                      - float(np.log(4.0 * np.pi)))
    log_ratio = 0.5 * (fact(2 * msafe) - fact(msafe + mp) - fact(msafe - mp))
    log_p = log_norm + log_ratio + (mf + mpf) * log_c + (mf - mpf) * log_s
    denom = scale_bits * _LN2
    scale_g = torch.clamp(torch.round(log_p / denom), max=0.0)
    mant_g = torch.exp(log_p - scale_g * denom)

    # the |m'| = 2, m < 2 rows
    c5 = float(np.sqrt(5.0 / (4.0 * np.pi)))
    v_m0 = c5 * (np.sqrt(6.0) / 4.0) * sin_t * sin_t
    v_m1 = torch.where(mp < 0, c5 * 0.5 * sin_t * (1.0 - x),
                       -c5 * 0.5 * sin_t * (1.0 + x))
    low = (m < mp.abs()) & (m >= 0)
    zero = torch.zeros((), **f64)
    mant = torch.where(low, torch.where(m == 0, v_m0, v_m1), mant_g)
    scale = torch.where(low, zero, scale_g)
    mant = torch.where(m >= 0, mant, zero)
    scale = torch.where(m >= 0, scale, zero)
    return mant.to(dtype), scale.to(torch.int32)


def recurrence_step_general(l: int, m, mp, x, mant_prev, mant_curr, scale,
                            seed_mant, seed_scale, *, scale_bits: int):
    """One step of the Wigner-general scaled recurrence at multipole ``l``.

    As :func:`recurrence_step`, seeded at l0 = max(m, |m'|) with the
    coefficients a_l, b_l, c_l; ``m`` and ``mp`` are (Ms, 1) in the working
    dtype.  Reduces to the scalar recurrence at m' = 0.
    """
    fdt = mant_curr.dtype
    lf = torch.tensor(float(l), dtype=fdt, device=m.device)
    zero = torch.zeros((), dtype=fdt, device=m.device)
    l0 = torch.maximum(m, mp.abs())
    ls = torch.maximum(lf, l0 + 1.0)             # a safe l for the coefficients
    d2 = torch.clamp((ls * ls - m * m) * (ls * ls - mp * mp), min=1e-30)
    lm1 = ls - 1.0
    d2m1 = torch.clamp((lm1 * lm1 - m * m) * (lm1 * lm1 - mp * mp), min=0.0)
    s2l = torch.sqrt(4.0 * ls * ls - 1.0)
    inv_d = 1.0 / torch.sqrt(d2)
    inv_lm1 = 1.0 / torch.clamp(lm1, min=1.0)
    a = ls * s2l * inv_d
    b = -(m * mp) * s2l * inv_d * inv_lm1
    c = (torch.sqrt((2.0 * ls + 1.0) / torch.clamp(2.0 * ls - 3.0, min=1.0))
         * ls * torch.sqrt(d2m1) * inv_d * inv_lm1)

    p_rec = (a * x + b) * mant_curr - c * mant_prev
    is_seed = lf == l0
    before = lf < l0
    new_curr = torch.where(before, zero,
                           torch.where(is_seed, seed_mant, p_rec))
    new_prev = torch.where(before | is_seed, zero, mant_curr)
    new_scale = torch.where(is_seed, seed_scale, scale)

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


def _prep_general(m_vals, mprime_vals, grid_x, grid_sin, m_max, dtype,
                  device):
    """(m, mp (Ms,1) dtype, x (1,R), seeds, scale bits) for the general
    engine loops."""
    m_np = np.asarray(m_vals)
    if m_max is None:
        m_max = int(np.max(m_np))
    sb = scale_bits_for(dtype)
    logfact = log_factorials(2 * max(int(m_max), 2) + 1)
    seed, sscale = spin_seeds_scaled(m_np, mprime_vals, grid_x, grid_sin,
                                     logfact, dtype=dtype, scale_bits=sb,
                                     device=device)
    m = torch.as_tensor(m_np, dtype=dtype, device=device)[:, None]
    mp = torch.as_tensor(np.asarray(mprime_vals), dtype=dtype,
                         device=device)[:, None]
    x = torch.as_tensor(np.asarray(grid_x), dtype=dtype, device=device)[None, :]
    return m, mp, x, seed, sscale, sb


def _delta_general_impl(a_re, a_im, m_vals, mprime_vals, grid_x, grid_sin,
                        *, l_max: int, m_max):
    dtype, device = a_re.dtype, a_re.device
    m, mp, x, seed, sscale, sb = _prep_general(
        m_vals, mprime_vals, grid_x, grid_sin, m_max, dtype, device)
    M, R, K = m.shape[0], x.shape[1], a_re.shape[-1]
    pp, pc, sc = _zeros_carry(M, R, dtype, device)
    d_re = torch.zeros(M, R, K, dtype=dtype, device=device)
    d_im = torch.zeros_like(d_re)
    for l in range(l_max + 1):
        pp, pc, sc, val = recurrence_step_general(
            l, m, mp, x, pp, pc, sc, seed, sscale, scale_bits=sb)
        d_re = d_re + val[..., None] * a_re[:, l][:, None, :]
        d_im = d_im + val[..., None] * a_im[:, l][:, None, :]
    return d_re, d_im


def _alm_general_impl(d_re, d_im, m_vals, mprime_vals, grid_x, grid_sin, *,
                      l_max: int, m_max):
    dtype, device = d_re.dtype, d_re.device
    m, mp, x, seed, sscale, sb = _prep_general(
        m_vals, mprime_vals, grid_x, grid_sin, m_max, dtype, device)
    pp, pc, sc = _zeros_carry(m.shape[0], x.shape[1], dtype, device)
    rows_re, rows_im = [], []
    for l in range(l_max + 1):
        pp, pc, sc, val = recurrence_step_general(
            l, m, mp, x, pp, pc, sc, seed, sscale, scale_bits=sb)
        rows_re.append(torch.einsum("mr,mrk->mk", val, d_re))
        rows_im.append(torch.einsum("mr,mrk->mk", val, d_im))
    return torch.stack(rows_re, dim=1), torch.stack(rows_im, dim=1)


def delta_from_alm_general(a_re, a_im, m_vals, mprime_vals, grid_x,
                           grid_sin, *, l_max: int, m_max=None):
    """Synthesis over lam^{(m')} rows: each row carries its own (m, m').

    a_re/a_im: (Ms, l_max+1, K) real tensors -> (d_re, d_im), each
    (Ms, R, K), in the dtype of ``a_re``.  Differentiable: the backward is
    the general analysis of the cotangent (same rows, unit weights).
    """
    geo = (m_vals, mprime_vals, grid_x, grid_sin)
    kw = dict(l_max=l_max, m_max=m_max)

    def fwd(_, ops):
        return _delta_general_impl(*ops, *geo, **kw)

    def bwd(_, cts):
        return _alm_general_impl(*cts, *geo, **kw)

    return linear_pair(fwd, bwd, {"grid_x": grid_x, "grid_sin": grid_sin},
                       (a_re, a_im))


def alm_from_delta_general(d_re, d_im, m_vals, mprime_vals, grid_x,
                           grid_sin, *, l_max: int, m_max=None):
    """Analysis over lam^{(m')} rows, the transpose of
    :func:`delta_from_alm_general`: weighted d_re/d_im (Ms, R, K) ->
    (Ms, l_max+1, K); rows with l < max(m, |m'|) come out exactly zero.
    Differentiable: the backward is the general synthesis of the cotangent.
    """
    geo = (m_vals, mprime_vals, grid_x, grid_sin)
    kw = dict(l_max=l_max, m_max=m_max)

    def fwd(_, ops):
        return _alm_general_impl(*ops, *geo, **kw)

    def bwd(_, cts):
        return _delta_general_impl(*cts, *geo, **kw)

    return linear_pair(fwd, bwd, {"grid_x": grid_x, "grid_sin": grid_sin},
                       (d_re, d_im))


# spin-2 component packing, rows stacked [m' = -2 | m' = +2] (2M, ...); any
# dtype, any trailing dims.  spin_pack_alm and spin_unpack_alm are each
# other's inverse, as are spin_pack_delta and spin_unpack_delta; as linear
# maps spin_unpack_delta^T = spin_pack_delta / 2.


def spin_pack_alm(e_re, e_im, b_re, b_im):
    """(E, B) -> stacked a^+- rows: [-(E + iB) | -(E - iB)], (2M, ...)."""
    a_p_re = -(e_re - b_im)
    a_p_im = -(e_im + b_re)
    a_m_re = -(e_re + b_im)
    a_m_im = -(e_im - b_re)
    return (torch.cat([a_p_re, a_m_re], dim=0),
            torch.cat([a_p_im, a_m_im], dim=0))


def spin_unpack_delta(d_re, d_im):
    """Stacked Delta^+- rows (2M, ...) -> (dq_re, dq_im, du_re, du_im):
    Delta_Q = (Delta^+ + Delta^-)/2, Delta_U = -i (Delta^+ - Delta^-)/2."""
    M = d_re.shape[0] // 2
    dp_re, dm_re = d_re[:M], d_re[M:]
    dp_im, dm_im = d_im[:M], d_im[M:]
    return (0.5 * (dp_re + dm_re), 0.5 * (dp_im + dm_im),
            0.5 * (dp_im - dm_im), -0.5 * (dp_re - dm_re))


def spin_pack_delta(dq_re, dq_im, du_re, du_im):
    """(Delta_Q, Delta_U) -> stacked Delta^+- = Delta_Q +- i Delta_U rows."""
    dp_re = dq_re - du_im
    dp_im = dq_im + du_re
    dm_re = dq_re + du_im
    dm_im = dq_im - du_re
    return (torch.cat([dp_re, dm_re], dim=0),
            torch.cat([dp_im, dm_im], dim=0))


def spin_unpack_alm(a_re, a_im):
    """Stacked a^+- rows (2M, ...) -> (e_re, e_im, b_re, b_im):
    E = -(a^+ + a^-)/2, B = i (a^+ - a^-)/2."""
    M = a_re.shape[0] // 2
    ap_re, am_re = a_re[:M], a_re[M:]
    ap_im, am_im = a_im[:M], a_im[M:]
    return (-0.5 * (ap_re + am_re), -0.5 * (ap_im + am_im),
            -0.5 * (ap_im - am_im), 0.5 * (ap_re - am_re))


def _spin_rows(m_vals):
    """The rows of the two spin recurrences: (m2, mp2), each (2M,) int32
    numpy, m' = -2 on the first M rows and +2 on the rest."""
    m = np.asarray(m_vals, np.int32)
    M = m.shape[0]
    return (np.concatenate([m, m]),
            np.concatenate([np.full(M, -2, np.int32),
                            np.full(M, 2, np.int32)]))


def delta_from_alm_spin(e_re, e_im, b_re, b_im, m_vals, grid_x, grid_sin, *,
                        l_max: int, m_max=None):
    """Spin-2 synthesis stage: (E, B) alm parts, each (M, l_max+1, K) ->
    (dq_re, dq_im, du_re, du_im), each (M, R, K)."""
    a2_re, a2_im = spin_pack_alm(e_re, e_im, b_re, b_im)
    m2, mp2 = _spin_rows(m_vals)
    d_re, d_im = delta_from_alm_general(a2_re, a2_im, m2, mp2, grid_x,
                                        grid_sin, l_max=l_max, m_max=m_max)
    return spin_unpack_delta(d_re, d_im)


def alm_from_delta_spin(dq_re, dq_im, du_re, du_im, m_vals, grid_x,
                        grid_sin, *, l_max: int, m_max=None):
    """Spin-2 analysis stage: weighted (Delta_Q, Delta_U) parts, each
    (M, R, K) -> (e_re, e_im, b_re, b_im), each (M, l_max+1, K)."""
    d2_re, d2_im = spin_pack_delta(dq_re, dq_im, du_re, du_im)
    m2, mp2 = _spin_rows(m_vals)
    a_re, a_im = alm_from_delta_general(d2_re, d2_im, m2, mp2, grid_x,
                                        grid_sin, l_max=l_max, m_max=m_max)
    return spin_unpack_alm(a_re, a_im)


_RDTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclasses.dataclass(frozen=True, eq=False)
class HarmonicCore:
    """The recurrence layer over spin 0 (scalar P_lm rows) and spin 2 (the
    stacked lambda^{+-} rows), bound to one grid and band limit.

      ``delta_from_alm``: complex alm (M, L, K) [spin 0] or (E, B)
          (2, M, L, K) [spin 2] -> Delta (M, R, K) / (Q, U) (2, M, R, K);
      ``alm_from_delta``: its adjoint (weighted Delta in).

    Spin 2 runs two Wigner-d recurrences (m' = -2, +2), twice the scalar
    row work, and mixes the components with the spin_* helpers.
    """

    m_vals: np.ndarray
    grid_x: np.ndarray
    grid_sin: np.ndarray
    log_mu_all: np.ndarray
    l_max: int
    spin: int = 0
    dtype: str = "float64"

    def __post_init__(self):
        if self.spin not in (0, 2):
            raise ValueError(f"unsupported spin {self.spin}: expected 0 or 2")

    @property
    def n_components(self) -> int:
        return 1 if self.spin == 0 else 2

    def delta_from_alm(self, alm: torch.Tensor) -> torch.Tensor:
        rdt = _RDTYPES[self.dtype]
        if self.spin == 0:
            d_re, d_im = delta_from_alm(
                alm.real.to(rdt), alm.imag.to(rdt), self.m_vals, self.grid_x,
                self.grid_sin, self.log_mu_all, l_max=self.l_max)
            return torch.complex(d_re, d_im)
        e, b = alm[0], alm[1]
        dq_re, dq_im, du_re, du_im = delta_from_alm_spin(
            e.real.to(rdt), e.imag.to(rdt), b.real.to(rdt), b.imag.to(rdt),
            self.m_vals, self.grid_x, self.grid_sin, l_max=self.l_max)
        return torch.stack([torch.complex(dq_re, dq_im),
                            torch.complex(du_re, du_im)], dim=0)

    def alm_from_delta(self, delta_w: torch.Tensor) -> torch.Tensor:
        if self.spin == 0:
            ones = np.ones(np.asarray(self.grid_x).shape[0])
            a_re, a_im = alm_from_delta(
                delta_w.real, delta_w.imag, self.m_vals, self.grid_x,
                self.grid_sin, ones, self.log_mu_all, l_max=self.l_max)
            return torch.complex(a_re, a_im)
        dq, du = delta_w[0], delta_w[1]
        e_re, e_im, b_re, b_im = alm_from_delta_spin(
            dq.real, dq.imag, du.real, du.imag, self.m_vals, self.grid_x,
            self.grid_sin, l_max=self.l_max)
        return torch.stack([torch.complex(e_re, e_im),
                            torch.complex(b_re, b_im)], dim=0)
