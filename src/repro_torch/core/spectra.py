"""Harmonic-domain error metric, power spectra and the polarisation helpers
(counterpart of ``repro.core.spectra``)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sht import alm_mask

__all__ = ["d_err", "cl_from_alm", "cmb_like_cl", "cmb_like_cl_pol",
           "alm_from_cl_pol", "cl_cross_from_alm"]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def d_err(a_init, a_out) -> float:
    """Relative round-trip error over all (l, m): the paper's eq. 19."""
    a_init, a_out = _host(a_init), _host(a_out)
    num = np.sum(np.abs(a_init - a_out) ** 2)
    den = np.sum(np.abs(a_init) ** 2)
    return float(np.sqrt(num / den))


def cl_from_alm(alm: torch.Tensor) -> torch.Tensor:
    """Pseudo-C_l estimator from packed (M, L, K) alm (real field, m >= 0):
    C_l = (|a_l0|^2 + 2 sum_{m >= 1} |a_lm|^2) / (2 l + 1), shape (L, K).
    Differentiable (plain torch operations)."""
    p = alm.real ** 2 + alm.imag ** 2                       # (M, L, K)
    tot = p[0] + 2.0 * p[1:].sum(dim=0)                     # (L, K)
    l = torch.arange(alm.shape[1], dtype=tot.dtype, device=tot.device)
    return tot / (2.0 * l + 1.0)[:, None]


def cmb_like_cl(l_max: int, *, amp: float = 1.0, l_peak: float = 220.0,
                tilt: float = -2.0) -> np.ndarray:
    """A toy CMB-like TT spectrum (not a physical model): Sachs-Wolfe
    plateau, acoustic-peak oscillation and a damping tail; C_0 = 0."""
    l = np.arange(l_max + 1, dtype=np.float64)
    lsafe = np.maximum(l, 1.0)
    plateau = 1.0 / (lsafe * (lsafe + 1.0))
    osc = 1.0 + 0.6 * np.cos(np.pi * l / l_peak) ** 2 * np.exp(-l / (3 * l_peak))
    damp = np.exp(-((l / (5.0 * l_peak)) ** 2))
    cl = amp * plateau * osc * damp * (lsafe / l_peak) ** (tilt + 2.0)
    cl[0] = 0.0
    return cl


def cmb_like_cl_pol(l_max: int, *, amp: float = 1.0) -> dict:
    """Toy TT/EE/BB/TE spectra with CMB-like structure (not physical): EE a
    few percent of TT with its peaks shifted half a period, BB a small
    fraction of EE, |TE| < sqrt(TT EE) so the (T, E) covariance stays
    positive definite.  EE/BB/TE vanish at l < 2."""
    l = np.arange(l_max + 1, dtype=np.float64)
    tt = cmb_like_cl(l_max, amp=amp)
    ee = 0.04 * cmb_like_cl(l_max, amp=amp, l_peak=160.0)
    bb = 0.05 * ee * np.exp(-l / 300.0)
    te = 0.6 * np.sqrt(tt * ee) * np.cos(np.pi * l / 190.0)
    for c in (ee, bb, te):
        c[:2] = 0.0
    return {"tt": tt, "ee": ee, "bb": bb, "te": te}


def _unit_alm(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    """Unit-variance complex alm of a real field (<|a|^2> = 1; m = 0 real
    with full variance), drawn from ``generator`` on the CPU."""
    re = torch.randn(shape, generator=generator, dtype=dtype)
    im = torch.randn(shape, generator=generator, dtype=dtype)
    z = torch.complex(re, im) / float(np.sqrt(2.0))
    z[0] = re[0].to(z.dtype)
    return z


def alm_from_cl_pol(generator: torch.Generator, cls: dict,
                    m_max: int | None = None, K: int = 1,
                    dtype=torch.float64, device=None) -> torch.Tensor:
    """Correlated Gaussian (T, E, B) alm from TT/EE/BB/TE spectra, (3, M,
    L, K) complex on ``device`` (``None``: the CUDA device, which must be
    visible).  ``cls`` as from :func:`cmb_like_cl_pol`.  T and E by the
    Cholesky split a_E = (TE / sqrt(TT)) xi_T + sqrt(EE - TE^2 / TT) xi_2,
    B independent; E/B rows with l < 2 are zero."""
    from repro_torch.core.transform import resolve_device
    device = resolve_device(device)
    tt, ee, bb, te = (np.asarray(cls[k], np.float64)
                      for k in ("tt", "ee", "bb", "te"))
    l_max = len(tt) - 1
    m_max = l_max if m_max is None else m_max
    shape = (m_max + 1, l_max + 1, K)
    x1, x2, x3 = (_unit_alm(generator, shape, dtype) for _ in range(3))
    s_tt = np.sqrt(tt)
    c_et = np.divide(te, s_tt, out=np.zeros_like(te), where=s_tt > 0)
    s_ee = np.sqrt(np.maximum(ee - c_et ** 2, 0.0))

    def row(v):
        return torch.as_tensor(v, dtype=dtype)[None, :, None]

    a_t = x1 * row(s_tt)
    a_e = x1 * row(c_et) + x2 * row(s_ee)
    a_b = x3 * row(np.sqrt(bb))
    zero = torch.zeros((), dtype=a_t.dtype)
    mask0 = torch.as_tensor(alm_mask(l_max, m_max))[..., None]
    mask2 = torch.as_tensor(alm_mask(l_max, m_max, spin=2))[..., None]
    return torch.stack([torch.where(mask0, a_t, zero),
                        torch.where(mask2, a_e, zero),
                        torch.where(mask2, a_b, zero)], dim=0).to(device)


def cl_cross_from_alm(alm_x: torch.Tensor, alm_y: torch.Tensor) -> torch.Tensor:
    """Pseudo cross-spectrum from two packed (M, L, K) alm:
    C_l = (Re[a^X_l0 conj(a^Y_l0)] + 2 sum_{m >= 1} Re[a^X conj(a^Y)])
    / (2l + 1), shape (L, K).  Differentiable (plain torch operations)."""
    p = (alm_x * alm_y.conj()).real                         # (M, L, K)
    tot = p[0] + 2.0 * p[1:].sum(dim=0)                     # (L, K)
    l = torch.arange(alm_x.shape[1], dtype=tot.dtype, device=tot.device)
    return tot / (2.0 * l + 1.0)[:, None]
