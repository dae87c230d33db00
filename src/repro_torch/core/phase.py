"""FFT/phase stage of the transforms: the uniform engine (torch.fft).

Counterpart of the uniform part of ``repro.core.phase``.  The Legendre
stage produces (synthesis) or consumes (analysis) per-ring Fourier
coefficients Delta_m(r); this stage turns them into ring samples with one
batched real FFT over all rings (paper eqs. 11 and 14), alias-folding
every m into the rfft half-spectrum.  Rows with m < 0 are padding and
contribute nothing.  Both directions are differentiable through their
adjoints (``core.autodiff``); the quadrature weights belong to the
analysis and multiply outside its linear pair, and ``fac_m`` (1 for m = 0,
else 2) accounts for the implicit negative-m half.  The ring-bucket
engine for ragged grids waits for ROADMAP.md Open items section 1, item 8.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.autodiff import linear_pair
from repro_torch.core.grids import RingGrid

__all__ = ["phase_factors", "uniform_bin_maps", "uniform_rotation_tables",
           "uniform_synth", "uniform_anal", "PhaseStage", "UniformPhase",
           "make_phase"]


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


def uniform_synth(delta: torch.Tensor, m_vals, n: int, phi0) -> torch.Tensor:
    """Synthesis phase stage: delta (M, R, K) complex -> maps (R, n, K) real.

    Bins past n/2 wrap to the conjugate half; the Nyquist bin doubles its
    real part; rows landing on one bin are summed (``index_add_``).
    Differentiable: the backward is fac_m times the weight-free analysis
    of the map cotangent.
    """
    m = np.asarray(m_vals)
    rdt = torch.float64 if delta.dtype == torch.complex128 else torch.float32
    fac = torch.as_tensor(_fac_rows(m, rdt), device=delta.device)

    def fwd(_, ops):
        return _uniform_synth_body(ops[0], ops[1], m, n, phi0)

    def bwd(_, t):
        a_re, a_im = _uniform_anal_core(t, m, n, phi0)
        return fac * a_re, fac * a_im

    return linear_pair(fwd, bwd, {"phi0": phi0}, (delta.real, delta.imag))


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


def make_phase(grid: RingGrid, m_max: int) -> PhaseStage:
    """The phase stage of a grid (uniform grids only in this port)."""
    if not grid.uniform:
        raise ValueError("ragged grids need the ring-bucket phase engine, "
                         "which waits for ROADMAP.md Open items section 1, "
                         "item 8")
    return UniformPhase(grid, np.arange(m_max + 1))
