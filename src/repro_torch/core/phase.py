"""FFT/phase stage of the transforms: the uniform and ring-bucket engines.

Counterpart of ``repro.core.phase``.  The Legendre
stage produces (synthesis) or consumes (analysis) per-ring Fourier
coefficients Delta_m(r); this stage turns them into ring samples with one
batched real FFT over all rings (paper eqs. 11 and 14), alias-folding
every m into the rfft half-spectrum.  Rows with m < 0 are padding and
contribute nothing.  Both directions are differentiable through their
adjoints (``core.autodiff``); the quadrature weights belong to the
analysis and multiply outside its linear pair, and ``fac_m`` (1 for m = 0,
else 2) accounts for the implicit negative-m half.

Ragged grids (true HEALPix) run the ring-bucket engine: rings are grouped
by rounded-up FFT length (``grids.ring_buckets``) and each bucket runs one
batched complex ``torch.fft`` call.  Ring r with n = n_phi(r) samples sits
in a bucket of length B with n | B: in synthesis its alias-folded length-n
spectrum lands at stride B/n in the length-B spectrum, whose inverse FFT
repeats the n samples B/n times (the first period is kept); in analysis
its n samples are zero-padded to B and the length-B FFT read at bins
(m mod n) B/n equals the length-n DFT.  Every index map is built once at
plan time (:class:`BucketIndex`).  The alias fold sums many m into one bin
on the short polar rings; it runs as fixed gathers and dense sums
(:func:`bucket_scatter`), never as an atomic scatter, so its bits are the
same on every run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cache as plancache
from repro_torch.core.autodiff import linear_pair
from repro_torch.core.grids import BucketLayout, RingGrid

__all__ = ["phase_factors", "uniform_bin_maps", "uniform_rotation_tables",
           "bucket_rotation_tables", "bucket_bin_maps", "BucketIndex",
           "bucket_index", "bucket_scatter", "bucket_gather",
           "uniform_synth", "uniform_anal", "bucket_synth", "bucket_anal",
           "PhaseStage", "UniformPhase", "BucketPhase", "make_phase"]


def _complex_dtype(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def phase_factors(m_vals, phi0, sign: float, dtype, device) -> torch.Tensor:
    """e^{sign i m phi0(r)} as (M, R) complex; rows with m < 0 are 0.

    Built in float64 on ``device``: the table has M x R entries and the
    eager engines build it on every call (the reference's jit folds it
    into a constant), so a host-side build would dominate the transform.
    """
    m = np.asarray(m_vals)
    mf = torch.as_tensor(np.maximum(m, 0), dtype=torch.float64, device=device)
    ang = (sign * mf)[:, None] * torch.as_tensor(
        np.asarray(phi0, np.float64), device=device)[None, :]
    ph = torch.polar(torch.ones_like(ang), ang)
    ph = ph * torch.as_tensor(m >= 0, device=device)[:, None]
    return ph.to(_complex_dtype(dtype))


def _fac_rows(m_vals, dtype):
    """(M, 1, 1) adjoint factors, 1 for m == 0 else 2 (numpy)."""
    m = np.asarray(m_vals)
    return np.where(m == 0, 1.0, 2.0).astype(
        np.float64 if dtype == torch.float64 else np.float32)[:, None, None]


def uniform_bin_maps(m_vals, n):
    """(bins, hi, nyq): the rfft half-spectrum bin of each m row, whether it
    wraps onto the conjugate half, and whether it sits on Nyquist."""
    m = np.asarray(m_vals)
    b = np.maximum(m, 0) % n
    hi = b > n // 2
    bins = np.where(hi, n - b, b)
    nyq = 2 * b == n
    return bins, hi, nyq


def uniform_rotation_tables(m_vals, phi0, n, direction):
    """Real 2x2 per-(row, ring) phase-rotation tables, (M, 4, R) f64 numpy.

    Encodes the uniform engine's e^{+-i m phi0(r)} rotation and the
    conjugate-wrap / Nyquist handling of :func:`uniform_bin_maps` as one
    real linear map, so the fused kernels apply the phase stage in-kernel:

        h_re = t0 * d_re + t1 * d_im
        h_im = t2 * d_re + t3 * d_im

    ``"synth"``: Delta -> half-spectrum row (sign +1; the conjugate is
    scattered for ``hi`` rows, whose imaginary row flips sign; the Nyquist
    row keeps twice its real part and no imaginary part).  ``"anal"``:
    gathered half-spectrum row -> Delta (sign -1, conjugate gathered for
    ``hi`` rows, no Nyquist term).  Rows with m < 0 are zero.
    """
    m = np.asarray(m_vals)
    _, hi, nyq = uniform_bin_maps(m, n)
    msafe = np.maximum(m, 0).astype(np.float64)
    ang = msafe[:, None] * np.asarray(phi0, np.float64)[None, :]
    c, s = np.cos(ang), np.sin(ang)
    hi_c = hi[:, None]
    if direction == "synth":
        ta, tb = c, -s
        tc = np.where(hi_c, -s, s)
        td = np.where(hi_c, -c, c)
        nyq_c = nyq[:, None]
        ta = np.where(nyq_c, 2.0 * c, ta)
        tb = np.where(nyq_c, -2.0 * s, tb)
        tc = np.where(nyq_c, 0.0, tc)
        td = np.where(nyq_c, 0.0, td)
    elif direction == "anal":
        ta = c
        tb = np.where(hi_c, -s, s)
        tc = -s
        td = np.where(hi_c, -c, c)
    else:
        raise ValueError(f"unknown direction {direction!r}")
    t = np.stack([ta, tb, tc, td], axis=1)             # (M, 4, R)
    return np.where((m >= 0)[:, None, None], t, 0.0)


def bucket_rotation_tables(m_vals, phi0, direction):
    """Real 2x2 per-(row, ring) phase tables of the bucket engine, (M, 4,
    R) f64 numpy: only e^{+-i m phi0(r)}, since the bucket engine's alias
    fold is an index map applied around the fused kernels.

        synth  h = e^{+i m phi0} d  ->  (c, -s, s, c)
        anal   d = e^{-i m phi0} f  ->  (c, s, -s, c)

    Rows with m < 0 are zero."""
    m = np.asarray(m_vals)
    msafe = np.maximum(m, 0).astype(np.float64)
    ang = msafe[:, None] * np.asarray(phi0, np.float64)[None, :]
    c, s = np.cos(ang), np.sin(ang)
    if direction == "synth":
        t = np.stack([c, -s, s, c], axis=1)
    elif direction == "anal":
        t = np.stack([c, s, -s, c], axis=1)
    else:
        raise ValueError(f"unknown direction {direction!r}")
    return np.where((m >= 0)[:, None, None], t, 0.0)


def bucket_bin_maps(m_vals, n_phi, bucket_len):
    """(pos, neg) int32 (M, R): ring r's +m term lands in bin
    (m mod n_r) B_r / n_r of its bucket's length-B_r spectrum, the
    conjugate -m term in ((-m) mod n_r) B_r / n_r."""
    m = np.maximum(np.asarray(m_vals), 0)[:, None]
    n = np.asarray(n_phi)[None, :]
    stride = np.asarray(bucket_len)[None, :] // n
    fold = m % n
    pos = fold * stride
    neg = ((n - fold) % n) * stride
    return pos.astype(np.int32), neg.astype(np.int32)


def _fold_groups(m_vals, n_phi, ring_off, stride, M):
    """The alias-fold sums of the bucket synthesis as fixed gathers.

    Target (ring r, bin f < n_r) sums the +m terms of every row with
    m = f + q n_r and the conjugate -m terms of every row with m > 0 and
    m = ((n_r - f) mod n_r) + q n_r.  Rings are grouped by the power of
    two W >= ceil((m_hi + 1) / n_r), the number of q; a group's targets
    take a (T_g, 2W) gather of source rows (row x R + r, conjugates offset
    by M R, 2 M R the zero row), summed densely over the 2W axis.
    Returns [(idx (T_g, 2W) i32, target spectrum position (T_g,) i64)],
    targets without any term dropped."""
    m = np.asarray(m_vals)
    R = n_phi.shape[0]
    live = np.nonzero(m >= 0)[0]
    m_hi = int(m[live].max()) if live.size else -1
    row_of = np.full(m_hi + 2, -1, dtype=np.int64)
    if np.unique(m[live]).size != live.size:
        raise ValueError("the bucket engine needs distinct m rows")
    row_of[m[live]] = live
    zero = 2 * M * R
    n_q = -(-(m_hi + 1) // n_phi)
    width = 1 << np.ceil(np.log2(np.maximum(n_q, 1))).astype(np.int64)
    groups = []
    for w in np.unique(width):
        rings = np.nonzero(width == w)[0]
        n = n_phi[rings]
        ring = np.repeat(rings, n)
        nn = np.repeat(n, n)
        f = np.arange(ring.size) - np.repeat(np.cumsum(n) - n, n)
        q = np.arange(w)[None, :] * nn[:, None]

        def src(mv, off, ok):
            row = row_of[np.where(ok, mv, m_hi + 1)]
            return np.where(ok & (row >= 0), off + row * R + ring[:, None],
                            zero)

        mp = f[:, None] + q
        mn = ((nn - f) % nn)[:, None] + q
        idx = np.concatenate([src(mp, 0, mp <= m_hi),
                              src(mn, M * R, (mn <= m_hi) & (mn > 0))],
                             axis=1)
        keep = (idx != zero).any(axis=1)
        groups.append((idx[keep].astype(np.int32),
                       ring_off[ring[keep]] + f[keep] * stride[ring[keep]]))
    return groups


@dataclasses.dataclass
class BucketIndex:
    """Plan-time index maps of the bucket engine for one row set, grid and
    map width.

    The bucket spectra lie back to back in one flat (T, C) buffer: bucket k
    holds its rings' length-B_k rows from ``offsets[k]``.  ``pos``/``neg``
    are :func:`bucket_bin_maps`; ``x_idx`` (T,) reads each spectrum row's
    sample from the maps (R W, C) (R W: a zero row, for the padding and
    samples past n_r); ``a_idx`` (M R,) reads each (row, ring) bin of the
    forward FFTs; ``groups`` are :func:`_fold_groups`, whose sums
    ``s_idx`` (T,) places (``n_fold`` rows; index ``n_fold`` is zero);
    ``o_idx`` (R W,) reads each output sample from the inverse FFTs (T: a
    zero row)."""

    layout: BucketLayout
    n_phi: np.ndarray
    m_vals: np.ndarray
    width: int
    pos: np.ndarray
    neg: np.ndarray
    offsets: np.ndarray
    x_idx: np.ndarray
    a_idx: np.ndarray
    groups: list
    s_idx: np.ndarray
    o_idx: np.ndarray
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def total(self) -> int:
        return int(self.x_idx.shape[0])

    def on(self, device) -> dict:
        """The index tensors on ``device`` (kept after the first call)."""
        device = torch.device(device)
        key = (device.type, device.index)
        if key not in self._dev:
            def t(v):
                return torch.as_tensor(np.ascontiguousarray(v),
                                       dtype=torch.int32, device=device)
            self._dev[key] = {
                "x": t(self.x_idx), "a": t(self.a_idx), "s": t(self.s_idx),
                "o": t(self.o_idx),
                "groups": [(t(i.reshape(-1)), i.shape) for i, _ in
                           self.groups]}
        return self._dev[key]


def _build_bucket_index(m_vals, n_phi, layout: BucketLayout,
                        width: int) -> dict:
    m = np.asarray(m_vals)
    n_phi = np.asarray(n_phi, np.int64)
    M, R = m.shape[0], n_phi.shape[0]
    blen = layout.fft_lengths
    pos, neg = bucket_bin_maps(m, n_phi, blen)
    sizes = np.asarray([B * len(sl) for B, sl in
                        zip(layout.lengths, layout.slots)], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    ring_off = np.zeros(R, np.int64)
    for B, sl, o in zip(layout.lengths, layout.slots, offsets):
        ring_off[np.asarray(sl)] = o + np.arange(len(sl)) * B
    T = int(sizes.sum())
    # spectrum row -> (ring, sample j); the sample exists for j < n_r
    ring = np.zeros(T, np.int64)
    for B, sl, o in zip(layout.lengths, layout.slots, offsets):
        ring[o:o + B * len(sl)] = np.repeat(np.asarray(sl), B)
    j = np.arange(T) - ring_off[ring]
    x_idx = np.where((j < n_phi[ring]) & (j < width), ring * width + j,
                     R * width)
    a_idx = ring_off[None, :] + pos.astype(np.int64)
    groups = _fold_groups(m, n_phi, ring_off, blen // n_phi, M)
    n_fold = sum(g[0].shape[0] for g in groups)
    s_idx = np.full(T, n_fold, np.int64)
    if groups:
        s_idx[np.concatenate([g[1] for g in groups])] = np.arange(n_fold)
    jj = np.arange(width)[None, :]
    o_idx = np.where(jj < n_phi[:, None], ring_off[:, None] + jj, T)
    payload = {"pos": pos, "neg": neg, "offsets": offsets,
               "x_idx": x_idx.astype(np.int32),
               "a_idx": a_idx.reshape(-1).astype(np.int32),
               "s_idx": s_idx.astype(np.int32),
               "o_idx": o_idx.reshape(-1).astype(np.int32),
               "n_groups": np.array(len(groups))}
    for k, (gi, gt) in enumerate(groups):
        payload[f"g_idx_{k}"], payload[f"g_tgt_{k}"] = gi, gt
    return payload


def bucket_index(m_vals, n_phi, layout: BucketLayout,
                 width: int) -> BucketIndex:
    """The :class:`BucketIndex` of a row set on a bucketed grid, through the
    signature-keyed precompute cache."""
    m = np.asarray(m_vals)
    n_phi = np.asarray(n_phi)
    key = plancache.signature_key(
        "bucket_index", m_vals=m, n_phi=n_phi, width=int(width),
        lengths=np.asarray(layout.lengths, np.int64),
        slots=np.concatenate([np.asarray(s) for s in layout.slots]))
    p = plancache.get_or_build(
        key, lambda: _build_bucket_index(m, n_phi, layout, int(width)))
    groups = [(p[f"g_idx_{k}"], p[f"g_tgt_{k}"])
              for k in range(int(p["n_groups"]))]
    return BucketIndex(layout=layout, n_phi=n_phi, m_vals=m,
                       width=int(width), pos=p["pos"], neg=p["neg"],
                       offsets=p["offsets"], x_idx=p["x_idx"],
                       a_idx=p["a_idx"], groups=groups, s_idx=p["s_idx"],
                       o_idx=p["o_idx"])


def _zero_row(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def bucket_scatter(vals: torch.Tensor, bidx: BucketIndex) -> torch.Tensor:
    """Alias-fold scatter and inverse FFTs of the bucket synthesis: rotated
    rows ``vals`` (M, R, C) complex -> ring samples (R, width, C) real,
    zero past each ring's n_phi.

    Each bin is a dense sum over a fixed gather of its +m terms and its
    conjugate -m terms (m > 0), so the result does not depend on the
    order threads run in; one ``torch.fft.ifft`` per bucket."""
    M, R, C = vals.shape
    ix = bidx.on(vals.device)
    flat = vals.reshape(M * R, C)
    src = _zero_row(torch.cat([flat, flat.conj()]))
    sums = [src.index_select(0, i).view(shape[0], shape[1], C).sum(dim=1)
            for i, shape in ix["groups"]]
    spec = _zero_row(torch.cat(sums) if sums else
                     vals.new_zeros((0, C))).index_select(0, ix["s"])
    samp = torch.empty_like(spec)
    for B, sl, o in zip(bidx.layout.lengths, bidx.layout.slots,
                        bidx.offsets.tolist()):
        n = B * len(sl)
        if n:
            samp[o:o + n] = torch.fft.ifft(
                spec[o:o + n].view(len(sl), B, C), dim=1,
                norm="forward").reshape(n, C)
    out = _zero_row(samp.real).index_select(0, ix["o"])
    return out.view(R, bidx.width, C)


def bucket_gather(maps: torch.Tensor, bidx: BucketIndex) -> torch.Tensor:
    """Forward FFTs and bin gather of the bucket analysis: ring samples
    (R, width, C) real -> unrotated spectrum rows (M, R, C) complex.
    Samples at or past each ring's n_phi are masked; one ``torch.fft.fft``
    per bucket."""
    R, W, C = maps.shape
    if W != bidx.width:
        raise ValueError(f"maps of width {W}, index built for {bidx.width}")
    ix = bidx.on(maps.device)
    cdt = torch.complex128 if maps.dtype == torch.float64 \
        else torch.complex64
    # complex input: the forward FFTs are the synthesis's complex plans of
    # the same lengths (a real input would need a plan of its own per length)
    x = _zero_row(maps.reshape(R * W, C)).index_select(0, ix["x"]).to(cdt)
    spec = torch.empty(x.shape, dtype=cdt, device=maps.device)
    for B, sl, o in zip(bidx.layout.lengths, bidx.layout.slots,
                        bidx.offsets.tolist()):
        n = B * len(sl)
        if n:
            spec[o:o + n] = torch.fft.fft(
                x[o:o + n].view(len(sl), B, C), dim=1).reshape(n, C)
    M = bidx.m_vals.shape[0]
    return spec.index_select(0, ix["a"]).view(M, R, C)


def _uniform_synth_body(d_re, d_im, m, n, phi0):
    """Weight-free synthesis body: Delta (re, im) (M, R, K) -> maps (R, n,
    K) real."""
    rdt, dev = d_re.dtype, d_re.device
    cdt = _complex_dtype(rdt)
    dp = torch.complex(d_re, d_im) * phase_factors(m, phi0, +1.0, rdt,
                                                   dev)[..., None]
    bins, hi, nyq = uniform_bin_maps(m, n)
    vals = torch.where(torch.as_tensor(hi, device=dev)[:, None, None],
                       dp.conj(), dp)
    vals = torch.where(torch.as_tensor(nyq, device=dev)[:, None, None],
                       (2.0 * vals.real).to(cdt), vals)
    H = torch.zeros((n // 2 + 1,) + tuple(dp.shape[1:]), dtype=cdt,
                    device=dev)
    H.index_add_(0, torch.as_tensor(bins, device=dev), vals)
    H = H.movedim(0, 1)                                # (R, half, K)
    return torch.fft.irfft(H, n=n, dim=1) * n


def _uniform_anal_core(maps, m, n, phi0):
    """Weight-free analysis core: maps (R, n, K) real -> (A_re, A_im), each
    (M, R, K): the e^{-i m phi} projection without the quadrature
    weights."""
    rdt, dev = maps.dtype, maps.device
    F = torch.fft.rfft(maps, dim=1)                    # (R, n//2+1, K)
    bins, hi, _ = uniform_bin_maps(m, n)
    Fm = F[:, torch.as_tensor(bins, device=dev), :]    # (R, M, K)
    Fm = torch.where(torch.as_tensor(hi, device=dev)[None, :, None],
                     Fm.conj(), Fm)
    Fm = Fm.movedim(1, 0)                              # (M, R, K)
    A = Fm * phase_factors(m, phi0, -1.0, rdt, dev)[..., None]
    return A.real, A.imag


def _row_scale(scale_rows, dtype, device):
    """``scale_rows`` (R,) as an (R, 1, 1) tensor, or None."""
    if scale_rows is None:
        return None
    return torch.as_tensor(np.asarray(scale_rows), dtype=dtype,
                           device=device)[:, None, None]


def uniform_synth(delta: torch.Tensor, m_vals, n: int, phi0,
                  scale_rows=None) -> torch.Tensor:
    """Synthesis phase stage: delta (M, R, K) complex -> maps (R, n, K) real.

    Bins past n/2 wrap to the conjugate half; the Nyquist bin doubles its
    real part; rows landing on one bin are summed (``index_add_``).
    ``scale_rows`` (R,) scales the rings on the way out (the distributed
    transform's valid-ring mask, so its dummy rings give zeros).
    Differentiable: the backward is fac_m times the weight-free analysis
    of the (scaled) map cotangent.
    """
    m = np.asarray(m_vals)
    rdt = torch.float64 if delta.dtype == torch.complex128 else torch.float32
    fac = torch.as_tensor(_fac_rows(m, rdt), device=delta.device)
    sr = _row_scale(scale_rows, rdt, delta.device)

    def fwd(_, ops):
        s = _uniform_synth_body(ops[0], ops[1], m, n, phi0)
        return s if sr is None else s * sr

    def bwd(_, t):
        a_re, a_im = _uniform_anal_core(t if sr is None else t * sr, m, n,
                                        phi0)
        return fac * a_re, fac * a_im

    return linear_pair(fwd, bwd, {"phi0": phi0, "scale_rows": scale_rows},
                       (delta.real, delta.imag))


def uniform_anal(maps: torch.Tensor, m_vals, n: int, phi0,
                 weights) -> torch.Tensor:
    """Analysis phase stage: maps (R, n, K) real -> weighted Delta (M, R, K)
    complex, rows following ``m_vals``, quadrature ``weights`` per ring.
    Differentiable: the weight-free core's backward is the synthesis of the
    cotangent / fac_m; the weights multiply outside it."""
    rdt, dev = maps.dtype, maps.device
    m = np.asarray(m_vals)
    fac = torch.as_tensor(_fac_rows(m, rdt), device=dev)

    def fwd(_, mp):
        return _uniform_anal_core(mp, m, n, phi0)

    def bwd(_, cts):
        return _uniform_synth_body(cts[0] / fac, cts[1] / fac, m, n, phi0)

    a_re, a_im = linear_pair(fwd, bwd, {"phi0": phi0}, maps)
    w = torch.as_tensor(np.asarray(weights), dtype=rdt, device=dev)
    return torch.complex(a_re, a_im) * w[None, :, None]


def _bucket_synth_body(d_re, d_im, bidx, phi0):
    """Weight-free bucket synthesis: Delta (re, im) (M, R, K) -> maps (R,
    width, K) real."""
    m = bidx.m_vals
    dp = torch.complex(d_re, d_im) * phase_factors(
        m, phi0, +1.0, d_re.dtype, d_re.device)[..., None]
    return bucket_scatter(dp, bidx)


def _bucket_anal_core(maps, bidx, phi0):
    """Weight-free bucket analysis core: maps (R, width, K) -> (A_re, A_im),
    each (M, R, K)."""
    A = bucket_gather(maps, bidx) * phase_factors(
        bidx.m_vals, phi0, -1.0, maps.dtype, maps.device)[..., None]
    return A.real, A.imag


def bucket_synth(delta: torch.Tensor, bidx: BucketIndex, phi0,
                 scale_rows=None) -> torch.Tensor:
    """Synthesis phase stage on a ragged grid: delta (M, R, K) complex ->
    maps (R, width, K) real, zero past each ring's n_phi; ``scale_rows``
    as in :func:`uniform_synth`.  Differentiable: the backward is fac_m
    times the weight-free bucket analysis of the (scaled) cotangent (exact
    under the divisor embedding)."""
    rdt = torch.float64 if delta.dtype == torch.complex128 else torch.float32
    fac = torch.as_tensor(_fac_rows(bidx.m_vals, rdt), device=delta.device)
    sr = _row_scale(scale_rows, rdt, delta.device)

    def fwd(_, ops):
        s = _bucket_synth_body(ops[0], ops[1], bidx, phi0)
        return s if sr is None else s * sr

    def bwd(_, t):
        a_re, a_im = _bucket_anal_core(t if sr is None else t * sr, bidx,
                                       phi0)
        return fac * a_re, fac * a_im

    return linear_pair(fwd, bwd, {"phi0": phi0, "scale_rows": scale_rows},
                       (delta.real, delta.imag))


def bucket_anal(maps: torch.Tensor, bidx: BucketIndex, phi0,
                weights) -> torch.Tensor:
    """Analysis phase stage on a ragged grid: maps (R, width, K) real ->
    weighted Delta (M, R, K) complex.  Samples past each ring's n_phi never
    reach the result.  Differentiable: the backward is the bucket synthesis
    of the cotangent / fac_m; the weights multiply outside the pair."""
    rdt, dev = maps.dtype, maps.device
    fac = torch.as_tensor(_fac_rows(bidx.m_vals, rdt), device=dev)

    def fwd(_, mp):
        return _bucket_anal_core(mp, bidx, phi0)

    def bwd(_, cts):
        return _bucket_synth_body(cts[0] / fac, cts[1] / fac, bidx, phi0)

    a_re, a_im = linear_pair(fwd, bwd, {"phi0": phi0}, maps)
    w = torch.as_tensor(np.asarray(weights), dtype=rdt, device=dev)
    return torch.complex(a_re, a_im) * w[None, :, None]


class PhaseStage:
    """Common surface of the grid-bound phase engines.

    ``synth``: (M, R, K) complex Delta -> (R, n_phi_max, K) real maps.
    ``anal``:  (R, n_phi_max, K) real maps -> (M, R, K) weighted Delta.
    """

    kind: str = "?"

    def synth(self, delta):
        raise NotImplementedError

    def anal(self, maps):
        raise NotImplementedError

    def describe(self) -> dict:
        raise NotImplementedError


class UniformPhase(PhaseStage):
    """Batched-rfft phase stage for uniform grids."""

    kind = "uniform"

    def __init__(self, grid: RingGrid, m_vals):
        if not grid.uniform:
            raise ValueError("UniformPhase needs a uniform grid")
        self.n = grid.max_n_phi
        self._phi0 = grid.phi0
        self._weights = grid.weights
        self._m_vals = np.asarray(m_vals)
        self._n_rings = grid.n_rings
        if self.n < 2 * int(self._m_vals.max()):
            raise ValueError("uniform FFT stage requires n_phi >= 2*m_max")

    def synth(self, delta):
        return uniform_synth(delta, self._m_vals, self.n, self._phi0)

    def anal(self, maps):
        return uniform_anal(maps, self._m_vals, self.n, self._phi0,
                            self._weights)

    @property
    def fft_lengths(self) -> np.ndarray:
        return np.full(self._n_rings, self.n, dtype=np.int64)

    def describe(self) -> dict:
        return {"kind": self.kind, "n_buckets": 1,
                "bucket_lengths": [self.n], "padded_frac": 0.0}


class BucketPhase(PhaseStage):
    """Ring-bucket phase stage for ragged grids (index maps built once, from
    the precompute cache)."""

    kind = "bucket"

    def __init__(self, grid: RingGrid, m_vals):
        self._grid = grid
        self.layout = BucketLayout.from_buckets(grid.fft_buckets())
        self.index = bucket_index(m_vals, grid.n_phi, self.layout,
                                  grid.max_n_phi)

    def synth(self, delta):
        return bucket_synth(delta, self.index, self._grid.phi0)

    def anal(self, maps):
        return bucket_anal(maps, self.index, self._grid.phi0,
                           self._grid.weights)

    @property
    def fft_lengths(self) -> np.ndarray:
        return self.layout.fft_lengths

    def describe(self) -> dict:
        return {"kind": self.kind, "n_buckets": self.layout.n_buckets,
                "bucket_lengths": list(self.layout.lengths),
                "padded_frac": self.layout.padded_frac(self._grid.n_phi)}


def make_phase(grid: RingGrid, m_max: int) -> PhaseStage:
    """The phase stage of a grid: the uniform engine for uniform grids, the
    ring-bucket engine for ragged ones."""
    m_vals = np.arange(m_max + 1)
    if grid.uniform:
        return UniformPhase(grid, m_vals)
    return BucketPhase(grid, m_vals)
