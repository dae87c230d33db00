"""Plain PyTorch versions of the Legendre kernels, and their seed tables.

Counterpart of ``repro.kernels.ref``.  ``synth_ref``/``anal_ref`` run the
float32 scaled recurrence of the reference's ``_f32_step``
(``repro/kernels/legendre_pallas.py``) over all m rows at once, with the l
loop in Python; with ``mp_vals`` (one m' per row) they run the Wigner-d
step of its ``_f32_step_spin`` instead, seeded at l0 = max(m, |m'|) from
``prepare_seeds_spin``, as the spin-2 plans do on their stacked
[m' = -2 | m' = +2] rows.  They are what ``kernels.ops`` runs on CPU
tensors and what the CUDA kernels are held against on the card.
``anal_reduce_ref`` is the plain version of the analysis kernels' second
pass.

Layouts are the unpadded ones of the ``ops`` seam:
  a  (Mp, L1, 2K) f32 -> Delta (Mp, P, R, 2K) f32, P = 2 (even, odd) if fold;
  dw (Mp, P, R, 2K) f32 -> a (Mp, l_max+1, 2K) f32.

``synth_packed_ref``/``anal_packed_ref`` are the plain versions of the
packed staged kernels (``repro/kernels/legendre_pallas.py``, the
``*_packed`` kernels), and ``synth_fused_ref``/``anal_fused_ref`` those of
the fused kernels (``repro/kernels/fused.py``), both on a ``kernels.pack``
slot layout:
  packed synth: a_pk (n_slots, S, 2K) -> (n_slots, Q, R, 2K)
                (``layout="mxu"``) or (n_slots, Q, 2K, R) (``"vpu"``),
                Q = 2 segments x P (even, odd (l+m)) planes;
  packed anal:  dw_pk in those two layouts -> (n_slots, S, 2K);
  fused synth:  a_pk -> rotated rows (n_slots, 2, n_pl, R, 2K) (``"mxu"``)
                or (n_slots, 2, n_pl, 2K, R) (``"vpu"``);
  fused anal:   f_pk in those two layouts -> (n_slots, S, 2K).
P = 2 with the equator fold, else 1; the fused kernels combine the two
planes into n_pl = 2 (north, south) and rotate, the packed ones do
neither.  Stream positions past a segment's l_max, and empty segments,
give exact zeros.  With ``spin=True`` the slot plain versions run the
Wigner-d step on each segment's (m, m') from the slot maps, and a segment
starts at l0 = max(m, |m'|).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["prepare_seeds", "prepare_seeds_spin", "synth_ref", "anal_ref",
           "anal_reduce_ref", "synth_packed_ref", "anal_packed_ref",
           "synth_fused_ref", "anal_fused_ref", "fma_f32", "sqrt_f32",
           "SCALE_BITS_F32"]

SCALE_BITS_F32 = 64
_BIG = float(2.0 ** (SCALE_BITS_F32 // 2))        # 2^32
_INV_BIG2 = float(2.0 ** (-SCALE_BITS_F32))       # 2^-64
_BIG2 = float(2.0 ** SCALE_BITS_F32)              # 2^64

#: the 28 lowest float64 fraction bits: zero on every float32 rounding
#: midpoint (of a normal float32, 1 then 28 zeros below its last bit; of a
#: subnormal one, more zeros still)
_LOW28 = (1 << 28) - 1


def sqrt_f32(t):
    """The correctly rounded float32 square root of a float32 tensor, as
    CUDA's ``__fsqrt_rn``.  torch's CUDA ``sqrt`` is that already (the
    smoke's plain versions keep their bits either way), but its CPU
    ``sqrt`` is not on every build (the AVX-512 kernels miss the last bit
    of ~1% of float32 and ~13% of float64 roots), so on the CPU the float64
    root is rounded to float32 and moved one float32 ulp where the exact
    float64 squares of the neighbouring midpoints say the root lies beyond
    them.  Used on the plain versions' coefficient rows only."""
    if t.is_cuda:
        return torch.sqrt(t)
    x = t.double()
    r = torch.sqrt(x).float()
    inf = torch.full_like(r, np.inf)
    up, dn = torch.nextafter(r, inf), torch.nextafter(r, -inf)
    mid_up = (r.double() + up.double()) * 0.5       # exact, squares exact
    mid_dn = (r.double() + dn.double()) * 0.5
    live = (r > 0) & torch.isfinite(r)
    r = torch.where(live & (x > mid_up * mid_up), up, r)
    return torch.where(live & (x < mid_dn * mid_dn), dn, r)


def fma_f32(a, b, c):
    """``a b + c`` of float32 tensors (broadcast), rounded once to float32:
    CUDA's ``fmaf``, and the contraction XLA's CPU build makes of the
    reference's spin update.  torch has no fused multiply-add.

    The product is exact in float64 (24 + 24 bits).  The float64 sum s
    rounds once, and rounding s to float32 rounds correctly unless s lies
    on a float32 rounding midpoint: only from there can the second rounding
    go the wrong way, as for (1 + 2^-12)^2 + 2^-70.  A midpoint is not a
    float32 and has its 28 lowest float64 fraction bits zero, so the
    elements that pass that test (a handful) are redone by round-to-odd:
    TwoSum's error e of s, and where e is nonzero and s's last bit even, s
    moved one float64 ulp toward e before the rounding to float32.
    """
    s = a.double() * b + c
    r = s.float()
    bits = s.view(torch.int64)
    idx = (((bits & _LOW28) == 0) & (s != r)).nonzero(as_tuple=True)
    if idx[0].numel():
        shape = s.shape
        p = a.expand(shape)[idx].double() * b.expand(shape)[idx]
        cd = c.expand(shape)[idx].double()
        sr = s[idx]
        bb = sr - p
        e = (p - (sr - bb)) + (cd - bb)
        odd = (e != 0) & ((bits[idx] & 1) == 0)
        away = torch.nextafter(sr, torch.copysign(torch.full_like(sr, np.inf),
                                                  e))
        r[idx] = torch.where(odd, away, sr).float()
    return r


def prepare_seeds(m_vals, sin_theta, log_mu_all, scale_bits: int = 64):
    """Scaled P_mm seeds for the float32 kernels, computed in float64.

    m_vals (Mp,) int, -1 rows are padding with inert 0 seeds; sin_theta
    (R,) f64.  Returns numpy (pmm (Mp, R) f32, pms (Mp, R) i32).
    """
    m_vals = np.asarray(m_vals)
    msafe = np.maximum(m_vals, 0)
    lm = np.asarray(log_mu_all, np.float64)[msafe][:, None]
    st = np.asarray(sin_theta, np.float64)[None, :]
    log_p = lm + msafe.astype(np.float64)[:, None] * np.log(st)
    denom = scale_bits * np.log(2.0)
    scale = np.minimum(np.round(log_p / denom), 0.0)
    mant = np.exp(log_p - scale * denom)
    mant = np.where((m_vals >= 0)[:, None], mant, 0.0)
    return mant.astype(np.float32), scale.astype(np.int32)


def prepare_seeds_spin(m_vals, mprime_vals, cos_theta, sin_theta,
                       m_max=None, scale_bits: int = 64):
    """Scaled spin-weighted lambda^{(m')} seeds for the float32 kernels,
    computed in float64 (``core.legendre.spin_seeds_scaled``).

    m_vals/mprime_vals (Ms,) int rows (m < 0 rows are padding with inert 0
    seeds); cos_theta/sin_theta (R,) f64.  Returns numpy (pmm (Ms, R) f32,
    pms (Ms, R) i32).
    """
    from repro_torch.core import legendre
    if m_max is None:
        m_max = int(np.max(np.asarray(m_vals)))
    logfact = legendre.log_factorials(2 * max(int(m_max), 2) + 1)
    mant, scale = legendre.spin_seeds_scaled(
        m_vals, mprime_vals, cos_theta, sin_theta, logfact,
        dtype=torch.float32, scale_bits=scale_bits)
    return mant.numpy(), scale.numpy()


def _rescale(lf, l_start, p_rec, pp, pc, sc, pmm, pms):
    """The seed / carry selects and the 2^+-64 rescale of one step, rows
    seeded where ``lf == l_start``; returns (pp', pc', sc', value)."""
    zero = torch.zeros((), dtype=torch.float32, device=pc.device)
    is_seed = lf == l_start
    before = lf < l_start
    new_c = torch.where(before, zero, torch.where(is_seed, pmm, p_rec))
    new_p = torch.where(before | is_seed, zero, pc)
    new_s = torch.where(is_seed, pms, sc)

    grow = (new_c.abs() > _BIG) & (new_s < 0)
    new_c = torch.where(grow, new_c * _INV_BIG2, new_c)
    new_p = torch.where(grow, new_p * _INV_BIG2, new_p)
    new_s = torch.where(grow, new_s + 1, new_s)
    shrink = ((new_c.abs() < 1.0 / _BIG) & (new_p.abs() < 1.0 / _BIG)
              & ~before & ~is_seed)
    new_c = torch.where(shrink, new_c * _BIG2, new_c)
    new_p = torch.where(shrink, new_p * _BIG2, new_p)
    new_s = torch.where(shrink, new_s - 1, new_s)

    value = torch.where((new_s == 0) & ~before, new_c, zero)
    return new_p, new_c, new_s, value


def _as_lf(l, m_f):
    """The degree as float32: a tensor as given, an int as a 0-dim one."""
    return l if torch.is_tensor(l) else torch.tensor(
        float(l), dtype=torch.float32, device=m_f.device)


def _spin_coefs(lf, m_f, mp_f):
    """(l0, a, b, c): the row coefficients of the Wigner-d step at degree
    ``lf``, elementwise over broadcast shapes (one step's rows, or every
    step's at once: each element sees the same operations either way)."""
    l0 = torch.maximum(m_f, mp_f.abs())
    ls = torch.maximum(lf, l0 + 1.0)
    d2 = torch.clamp((ls * ls - m_f * m_f) * (ls * ls - mp_f * mp_f),
                     min=1e-30)
    lm1 = ls - 1.0
    d2m1 = torch.clamp((lm1 * lm1 - m_f * m_f) * (lm1 * lm1 - mp_f * mp_f),
                       min=0.0)
    s2l = sqrt_f32(4.0 * ls * ls - 1.0)
    inv_d = 1.0 / sqrt_f32(d2)
    inv_lm1 = 1.0 / torch.clamp(lm1, min=1.0)
    a = ls * s2l * inv_d
    b = -(m_f * mp_f) * s2l * inv_d * inv_lm1
    c = (sqrt_f32((2.0 * ls + 1.0) / torch.clamp(2.0 * ls - 3.0, min=1.0))
         * ls * sqrt_f32(d2m1) * inv_d * inv_lm1)
    return l0, a, b, c


def _scalar_coefs(lf, m_f):
    """(beta_l, beta_l / beta_{l-1}, sqrt(2m + 3), l == m + 1): the row
    coefficients of the scalar step at degree ``lf``, elementwise as
    :func:`_spin_coefs`.

    1/sqrt, not rsqrt, the root correctly rounded on every device
    (:func:`sqrt_f32`), so the CUDA kernels reproduce these bits (rsqrt is
    approximate on CUDA)."""
    lb = torch.maximum(lf, m_f + 2.0)
    bl = 1.0 / sqrt_f32((lb * lb - m_f * m_f) / (4.0 * lb * lb - 1.0))
    lb1 = torch.maximum(lf - 1.0, m_f + 1.0)
    bl1 = 1.0 / sqrt_f32((lb1 * lb1 - m_f * m_f) / (4.0 * lb1 * lb1 - 1.0))
    first = sqrt_f32(torch.clamp(2.0 * m_f + 3.0, min=0.0))
    return bl, bl / bl1, first, lf == m_f + 1.0


def _f32_step_spin(l, m_f, mp_f, x, pp, pc, sc, pmm, pms, coefs=None):
    """One Wigner-d scaled-recurrence step in float32, branch-free, as the
    reference's ``_f32_step_spin``: lam_l = (a x + b) lam_{l-1} - c lam_{l-2}
    seeded at l0 = max(m, |m'|), the coefficients recomputed from (l, m,
    m') (:func:`_spin_coefs`; ``coefs`` passes them precomputed).  Operands
    as :func:`_f32_step`, ``mp_f`` (Mp, 1) f32.

    Every operation is one correctly rounded float32 operation in the order
    written (1/sqrt as a square root and a division, not rsqrt), except the
    update, contracted into two fused multiply-adds as XLA's CPU build
    contracts the reference's: fma(fma(a, x, b), lam_{l-1}, -(c lam_{l-2}))
    (:func:`fma_f32`).  The CUDA kernels' spin step (``csrc/recurrence.cuh``
    ``rec_next_spin``, ``fmaf``) repeats it bit for bit.
    """
    lf = _as_lf(l, m_f)
    l0, a, b, c = _spin_coefs(lf, m_f, mp_f) if coefs is None else coefs
    p_rec = fma_f32(fma_f32(a, x, b), pc, -(c * pp))
    return _rescale(lf, l0, p_rec, pp, pc, sc, pmm, pms)


def _f32_step(l, m_f, x, pp, pc, sc, pmm, pms, coefs=None):
    """One scaled-recurrence step in float32, branch-free.

    l an int, or an f32 tensor (one l per row, as on the packed stream);
    m_f (Mp, 1) f32; x (1, R) f32; pp, pc, pmm (Mp, R) f32; sc, pms i32;
    ``coefs`` the row coefficients of :func:`_scalar_coefs` precomputed.
    Returns (pp', pc', sc', value), ``value`` the descaled P_{l,m}.
    """
    lf = _as_lf(l, m_f)
    bl, ratio, first, is_first = _scalar_coefs(lf, m_f) if coefs is None \
        else coefs
    p_rec = bl * x * pc - ratio * pp
    p_first = first * x * pc
    p_new = torch.where(is_first, p_first, p_rec)
    return _rescale(lf, m_f, p_new, pp, pc, sc, pmm, pms)


def _row_coefs(lf, m_f, mp_f=None):
    """Every step's row coefficients at once, ``lf`` (n, ...) the degrees
    of the n steps: the tables of :func:`_scalar_coefs` (``mp_f`` None) or
    :func:`_spin_coefs`, each broadcast to the full (n, ...) shape, so
    step i takes ``[t[i] for t in tables]`` and launches only its (row,
    ring) work."""
    tabs = _scalar_coefs(lf, m_f) if mp_f is None else \
        _spin_coefs(lf, m_f, mp_f)
    return torch.broadcast_tensors(lf, *tabs)[1:]


def _carry(m_vals, x):
    m = m_vals.to(torch.int32)[:, None]
    Mp, R = m.shape[0], x.shape[0]
    z = torch.zeros(Mp, R, dtype=torch.float32, device=x.device)
    return (m, m.to(torch.float32), x.to(torch.float32)[None, :], z, z.clone(),
            torch.zeros(Mp, R, dtype=torch.int32, device=x.device))


def _stepper(m_f, mp_vals, n_l: int):
    """The row step of degrees 0 .. n_l - 1: the scalar one, or the
    Wigner-d one on the rows' m' (``mp_vals`` (Mp,) int tensor), with the
    row coefficients of every degree computed up front (:func:`_row_coefs`)."""
    lf = torch.arange(n_l, dtype=torch.float32, device=m_f.device)
    lf = lf[:, None, None]
    if mp_vals is None:
        tabs = _row_coefs(lf, m_f)
        return lambda l, *c: _f32_step(lf[l], m_f, *c,
                                       coefs=[t[l] for t in tabs])
    mp_f = mp_vals.to(torch.float32)[:, None]
    tabs = _row_coefs(lf, m_f, mp_f)
    return lambda l, *c: _f32_step_spin(lf[l], m_f, mp_f, *c,
                                        coefs=[t[l] for t in tabs])


def synth_ref(a, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False,
              mp_vals=None):
    """Plain version of the synthesis kernels.

    a (Mp, L1, 2K) f32; m_vals (Mp,) int tensor; x (R,) f32; pmm/pms
    (Mp, R); ``mp_vals`` (Mp,) int tensor of m' per row selects the
    Wigner-d step (None: the scalar P_lm).  Returns Delta (Mp, P, R, 2K)
    f32 (P = 2 if fold).
    """
    Mp, L1, K2 = a.shape
    m, m_f, xb, pp, pc, sc = _carry(m_vals, x)
    step = _stepper(m_f, mp_vals, min(l_max + 1, L1))
    acc = torch.zeros(Mp, 2 if fold else 1, x.shape[0], K2,
                      dtype=torch.float32, device=a.device)
    for l in range(min(l_max + 1, L1)):
        pp, pc, sc, val = step(l, xb, pp, pc, sc, pmm, pms)
        contrib = val[:, :, None] * a[:, l][:, None, :]      # (Mp, R, 2K)
        if fold:
            odd = ((l + m) % 2 == 1)[..., None]               # (Mp, 1, 1)
            zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
            acc[:, 0] += torch.where(odd, zero, contrib)
            acc[:, 1] += torch.where(odd, contrib, zero)
        else:
            acc[:, 0] += contrib
    return acc


def anal_ref(dw, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False,
             mp_vals=None):
    """Plain version of the analysis kernels.

    dw (Mp, P, R, 2K) f32 weighted Delta; ``mp_vals`` as in
    :func:`synth_ref`.  Returns (Mp, l_max+1, 2K) f32, exact zeros where
    l < max(m, |m'|).
    """
    m, m_f, xb, pp, pc, sc = _carry(m_vals, x)
    step = _stepper(m_f, mp_vals, l_max + 1)
    rows = []
    for l in range(l_max + 1):
        pp, pc, sc, val = step(l, xb, pp, pc, sc, pmm, pms)
        if fold:
            d = torch.where(((l + m) % 2 == 0)[..., None], dw[:, 0], dw[:, 1])
        else:
            d = dw[:, 0]
        rows.append(torch.einsum("mr,mrk->mk", val, d))
    return torch.stack(rows, dim=1)


def anal_reduce_ref(partials, m_vals, *, l_max: int, mp_vals=None,
                    slot_maps=None):
    """Plain version of the analysis second pass: sum the per-ring-chunk
    partials over chunks.  Plain rows (Mp, n_chunks, l_max+1, 2K): rows
    with l < m (l < max(m, |m'|) with ``mp_vals``) and padding rows (m < 0)
    are zero.  Slot streams (``m_vals`` None, ``slot_maps`` = (m0, m1, mp0,
    mp1, seed), mp0/mp1 None for spin 0, band limit ``l_max``): each slot's
    positions from its live end on, past both segments, are zero."""
    if (m_vals is None) == (slot_maps is None):
        raise ValueError("anal_reduce takes m_vals (plain rows) or "
                         "slot_maps (slot streams)")
    S = partials.shape[2] if m_vals is None else l_max + 1
    total = partials[:, :, :S].sum(dim=1)
    pos = torch.arange(S, device=partials.device)[None, :]

    def first_l(m, mp):
        m = m.to(torch.int64)
        return m if mp is None else torch.maximum(m, mp.to(torch.int64).abs())

    if slot_maps is not None:
        m0, m1, mp0, mp1, seed = slot_maps
        seed = seed.to(torch.int64)
        len1 = torch.where(seed < S, l_max + 1 - first_l(m1, mp1), 0)
        end = torch.where(len1 > 0, seed + len1, l_max + 1 - first_l(m0, mp0))
        keep = pos < end[:, None]
    else:
        keep = (m_vals.to(torch.int64)[:, None] >= 0) & \
            (pos >= first_l(m_vals, mp_vals)[:, None])
    return torch.where(keep[..., None], total,
                       torch.zeros((), dtype=total.dtype,
                                   device=total.device))


# ---------------------------------------------------------------------------
# packed and fused kernels (slot layout)
# ---------------------------------------------------------------------------


def _stream(maps, x, pmm_pk, pms_pk, *, l_max: int, s_len: int,
            spin: bool = False):
    """Walk the packed l-stream of every slot at once.

    Yields ``(g, val, seg1, odd)`` per stream position g up to the last
    live one of any slot: ``val`` (n_slots, R) the descaled P_{l,m} (the
    lambda^{(m')}_{l,m} with ``spin``; zero past the segment's l_max),
    ``seg1`` and ``odd`` ((l + m) odd) as (n_slots, 1) bools.  A segment
    starts at its l0 (m, or max(m, |m'|) with ``spin``), and segment 1
    re-seeds at ``slot_seed`` because the step seeds wherever l == l0.
    """
    m0, m1, mp0, mp1, seed = (v.to(torch.int64)[:, None] for v in maps)
    l00 = torch.maximum(m0, mp0.abs()) if spin else m0
    l01 = torch.maximum(m1, mp1.abs()) if spin else m1
    # slot_seed == s_len marks an empty segment 1
    S_live = int(torch.where(seed < s_len, seed + l_max + 1 - l01,
                             l_max + 1 - l00).max()) if m0.numel() else 0
    z = torch.zeros(pmm_pk.shape[0], x.shape[0], dtype=torch.float32,
                    device=x.device)
    pp, pc = z, z.clone()
    sc = torch.zeros_like(z, dtype=torch.int32)
    xb = x.to(torch.float32)[None, :]
    # every position's (slot) selects and row coefficients at once
    g_all = torch.arange(S_live, device=x.device)[:, None, None]
    seg1_all = g_all >= seed
    m_all = torch.where(seg1_all, m1, m0)
    l_all = torch.where(seg1_all, l01 + g_all - seed, l00 + g_all)
    lf_all, mf_all = l_all.to(torch.float32), m_all.to(torch.float32)
    mpf_all = torch.where(seg1_all, mp1, mp0).to(torch.float32) if spin \
        else None
    tabs = _row_coefs(lf_all, mf_all, mpf_all)
    live_all = l_all <= l_max
    odd_all = (l_all + m_all) % 2 == 1
    zero = torch.zeros((), device=x.device)
    for g in range(S_live):
        seg1 = seg1_all[g]
        pmm = torch.where(seg1, pmm_pk[:, 1], pmm_pk[:, 0])
        pms = torch.where(seg1, pms_pk[:, 1], pms_pk[:, 0])
        coefs = [t[g] for t in tabs]
        if spin:
            pp, pc, sc, val = _f32_step_spin(lf_all[g], mf_all[g],
                                             mpf_all[g], xb, pp, pc, sc,
                                             pmm, pms, coefs=coefs)
        else:
            pp, pc, sc, val = _f32_step(lf_all[g], mf_all[g], xb, pp, pc,
                                        sc, pmm, pms, coefs=coefs)
        val = torch.where(live_all[g], val, zero)
        yield g, val, seg1, odd_all[g]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 and back (round to nearest even)."""
    return t.to(torch.bfloat16).to(torch.float32)


def synth_packed_ref(a_pk, maps, x, pmm_pk, pms_pk, *, l_max: int,
                     fold: bool = False, layout: str = "mxu",
                     spin: bool = False):
    """Plain version of the packed synthesis kernels.

    a_pk (n_slots, S, 2K) f32 packed coefficient streams; maps the five
    per-slot i32 tensors of ``ops._pack_maps`` (m0, m1, mp0, mp1, seed;
    mp0/mp1 are read with ``spin``); x (R,) f32;
    pmm_pk/pms_pk (n_slots, 2, R) per-segment seeds.  Each segment's Delta
    is summed into its (l+m) parity plane with ``fold`` and returned as
    (n_slots, Q, R, 2K), Q = 2 x P, plane q = segment x P + parity, in
    ``layout``'s order.
    """
    acc = _synth_planes(a_pk, maps, x, pmm_pk, pms_pk, l_max=l_max,
                        fold=fold, spin=spin)
    return acc.movedim(-1, 2).contiguous() if layout == "vpu" else acc


def _synth_planes(a_pk, maps, x, pmm_pk, pms_pk, *, l_max, fold, spin,
                  bf16=False):
    """The packed synthesis sums (n_slots, Q, R, 2K); with ``bf16`` the
    recurrence values and the coefficients are rounded to bfloat16 before
    their (exact) float32 products are summed."""
    n_slots, S, K2 = a_pk.shape
    R = x.shape[0]
    P = 2 if fold else 1
    if bf16:
        a_pk = _bf16(a_pk)
    acc = torch.zeros(n_slots, 2, P, R, K2, dtype=torch.float32,
                      device=a_pk.device)
    zero = torch.zeros((), dtype=torch.float32, device=a_pk.device)
    for g, val, seg1, odd in _stream(maps, x, pmm_pk, pms_pk, l_max=l_max,
                                     s_len=S, spin=spin):
        if bf16:
            val = _bf16(val)
        contrib = val[:, :, None] * a_pk[:, g][:, None, :]   # (n_slots, R, 2K)
        for seg, in_seg in ((0, ~seg1), (1, seg1)):
            for p in range(P):
                keep = in_seg & (odd if p else ~odd) if fold else in_seg
                acc[:, seg, p] += torch.where(keep[..., None], contrib, zero)
    return acc.reshape(n_slots, 2 * P, R, K2)


def anal_packed_ref(dw_pk, maps, x, pmm_pk, pms_pk, *, l_max: int,
                    s_len: int, layout: str = "mxu", spin: bool = False):
    """Plain version of the packed analysis kernels.

    dw_pk (n_slots, Q, R, 2K) (``layout="mxu"``) or (n_slots, Q, 2K, R)
    (``"vpu"``) weighted Delta per segment and (l+m) parity plane (Q = 4
    with the equator fold, else 2); the rest as :func:`synth_packed_ref`.
    Each stream position contracts the plane its segment and parity select
    against the recurrence over the rings.  Returns (n_slots, s_len, 2K).
    """
    d_all = dw_pk.movedim(2, -1) if layout == "vpu" else dw_pk
    return _anal_planes(d_all, maps, x, pmm_pk, pms_pk, l_max=l_max,
                        s_len=s_len, spin=spin)


def _anal_planes(d_all, maps, x, pmm_pk, pms_pk, *, l_max, s_len, spin,
                 bf16=False):
    """The packed analysis contraction of (n_slots, Q, R, 2K) rows; with
    ``bf16`` the recurrence values and the rows are rounded to bfloat16
    before their (exact) float32 products are summed."""
    if bf16:
        d_all = _bf16(d_all)
    n_slots, Q, R, K2 = d_all.shape
    d_all = d_all.reshape(n_slots, 2, Q // 2, R, K2)
    out = torch.zeros(n_slots, s_len, K2, dtype=torch.float32,
                      device=d_all.device)
    for g, val, seg1, odd in _stream(maps, x, pmm_pk, pms_pk, l_max=l_max,
                                     s_len=s_len, spin=spin):
        d = torch.where(seg1[:, :, None, None], d_all[:, 1], d_all[:, 0])
        d = torch.where(odd[..., None], d[:, -1], d[:, 0])        # (s, R, 2K)
        out[:, g] = torch.einsum("sr,src->sc", _bf16(val) if bf16 else val,
                                 d)
    return out


def _rotate(tab, re, im):
    """(t0 re + t1 im, t2 re + t3 im); tab (..., 4, R) against (..., R, K)."""
    t = [tab[..., q, :, None] for q in range(4)]
    return t[0] * re + t[1] * im, t[2] * re + t[3] * im


def synth_fused_ref(a_pk, maps, x, pmm_pk, pms_pk, tab_pk=None, *,
                    l_max: int, fold: bool = False, layout: str = "mxu",
                    spin: bool = False, bf16: bool = False):
    """Plain version of the fused synthesis kernels.

    Operands as :func:`synth_packed_ref`, and tab_pk (n_slots, 2, n_pl, 4,
    R) f32 rotation tables, or None for the identity.  Each segment's
    Delta (the packed planes, even/odd (l+m) combined into north = e + o,
    south = e - o with ``fold``) is rotated by its table and returned in
    ``layout``'s order.  ``bf16`` (``synth_fused_mxu``'s bfloat16 branch)
    rounds the recurrence values and the coefficients to bfloat16 before
    the float32 contraction; the combine and rotation stay float32.
    """
    n_slots, _, K2 = a_pk.shape
    R, K = x.shape[0], K2 // 2
    acc = _synth_planes(a_pk, maps, x, pmm_pk, pms_pk, l_max=l_max,
                        fold=fold, spin=spin,
                        bf16=bf16).reshape(n_slots, 2, -1, R, K2)
    if fold:
        acc = torch.stack([acc[:, :, 0] + acc[:, :, 1],
                           acc[:, :, 0] - acc[:, :, 1]], dim=2)
    if tab_pk is not None:
        re, im = _rotate(tab_pk, acc[..., :K], acc[..., K:])
        acc = torch.cat([re, im], dim=-1)
    return acc.movedim(-1, 3).contiguous() if layout == "vpu" else acc


def anal_fused_ref(f_pk, maps, x, pmm_pk, pms_pk, tab_pk=None, *,
                   l_max: int, s_len: int, layout: str = "mxu",
                   spin: bool = False, bf16: bool = False):
    """Plain version of the fused analysis kernels.

    f_pk (n_slots, 2, n_pl, R, 2K) (``layout="mxu"``) or (n_slots, 2, n_pl,
    2K, R) (``"vpu"``) gathered, unrotated FFT rows per segment and plane;
    the rest as :func:`synth_fused_ref`.  Each segment's rows are rotated
    into Delta (with two planes: even = N + S, odd = N - S), then contracted
    against the recurrence over the rings.  Returns (n_slots, s_len, 2K).
    ``bf16`` (``anal_fused_mxu``'s bfloat16 branch) rounds the rotated,
    combined rows and the recurrence values to bfloat16 before the float32
    contraction.
    """
    f = f_pk.movedim(3, -1) if layout == "vpu" else f_pk
    n_slots, _, P, R, K2 = f.shape
    K = K2 // 2
    if tab_pk is not None:
        re, im = _rotate(tab_pk, f[..., :K], f[..., K:])
        f = torch.cat([re, im], dim=-1)
    if P == 2:
        f = torch.stack([f[:, :, 0] + f[:, :, 1], f[:, :, 0] - f[:, :, 1]],
                        dim=2)
    return _anal_planes(f.reshape(n_slots, 2 * P, R, K2), maps, x, pmm_pk,
                        pms_pk, l_max=l_max, s_len=s_len, spin=spin,
                        bf16=bf16)
