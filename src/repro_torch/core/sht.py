"""Serial spherical harmonic transforms, the torch oracle engine.

Counterpart of ``repro.core.sht`` (paper Algorithms 1 and 2):

  alm2map: Delta_m(r) = sum_l a_lm P_lm(cos theta_r), then the phase stage;
  map2alm: the weighted phase stage, then a_lm = sum_r Delta_m(r) P_lm.

Conventions as in the reference: fields are real and only m >= 0 is
stored; alm is ``(m_max+1, l_max+1, K)`` complex with l < m entries zero;
maps are ``(R, n_phi, K)`` real.  The spin-2 transforms
(``alm2map_spin``/``map2alm_spin``) take (E, B) alm ``(2, M, L, K)`` and
(Q, U) maps ``(2, R, n_phi, K)``; their Legendre stage is the spin-2
``legendre.HarmonicCore``, their phase stage the spin-blind one, which Q|U
pass through as 2K channels.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import legendre
from repro_torch.core.grids import RingGrid
from repro_torch.core.phase import make_phase

__all__ = ["SHT", "alm_mask", "alm_rect_zeros", "random_alm",
           "random_alm_spin"]

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def alm_mask(l_max: int, m_max: int, spin: int = 0) -> np.ndarray:
    """(m_max+1, l_max+1) bool mask of valid (m, l): l >= m and l >= spin."""
    m = np.arange(m_max + 1)[:, None]
    l = np.arange(l_max + 1)[None, :]
    return (l >= m) & (l >= spin)


def _device(device) -> torch.device:
    from repro_torch.core.transform import resolve_device
    return resolve_device(device)


def alm_rect_zeros(l_max: int, m_max: int, K: int = 1,
                   dtype=torch.complex128, device=None) -> torch.Tensor:
    """Zero alm on ``device`` (``None``: the CUDA device, which must be
    visible)."""
    return torch.zeros((m_max + 1, l_max + 1, K), dtype=dtype,
                       device=_device(device))


def random_alm(generator: torch.Generator, l_max: int, m_max: int, K: int = 1,
               dtype=torch.float64, device=None, *,
               spin: int = 0) -> torch.Tensor:
    """Random a_lm, real and imaginary parts uniform in (-1, 1) (paper §5);
    m = 0 is real, l < m is zero, and so is l < ``spin``.  Draws from
    ``generator`` on the CPU and returns the alm on ``device`` (``None``:
    the CUDA device, which must be visible)."""
    device = _device(device)
    shape = (m_max + 1, l_max + 1, K)
    re = torch.rand(shape, generator=generator, dtype=dtype) * 2.0 - 1.0
    im = torch.rand(shape, generator=generator, dtype=dtype) * 2.0 - 1.0
    im[0] = 0.0
    mask = torch.as_tensor(alm_mask(l_max, m_max, spin))[..., None]
    alm = torch.where(mask, torch.complex(re, im), torch.zeros((), dtype=re.dtype))
    return alm.to(device)


def random_alm_spin(generator: torch.Generator, l_max: int, m_max: int,
                    K: int = 1, dtype=torch.float64,
                    device=None) -> torch.Tensor:
    """Random (E, B) alm pair for the spin-2 transforms, (2, M, L, K):
    E then B drawn from ``generator`` as :func:`random_alm`, rows l < 2
    zero (no spin-2 harmonics below the spin)."""
    e = random_alm(generator, l_max, m_max, K, dtype, device, spin=2)
    b = random_alm(generator, l_max, m_max, K, dtype, device, spin=2)
    return torch.stack([e, b], dim=0)


@dataclasses.dataclass(frozen=True)
class SHT:
    """Batched serial SHT engine on an iso-latitude grid.

    ``dtype`` is the recurrence dtype (``"float64"`` oracle or
    ``"float32"``); ``fold`` uses the equator fold (symmetric grids only).
    """

    grid: RingGrid
    l_max: int
    m_max: int
    dtype: str = "float64"
    fold: bool = False

    def __post_init__(self):
        if self.m_max > self.l_max:
            raise ValueError(f"m_max {self.m_max} > l_max {self.l_max}")
        if self.fold and not self.grid.equator_symmetric:
            raise ValueError("fold requires an equator-symmetric grid")

    @property
    def n_north(self) -> int:
        """Northern rings including the equator ring if present."""
        return (self.grid.n_rings + 1) // 2

    @property
    def has_equator(self) -> bool:
        return self.grid.n_rings % 2 == 1

    @functools.cached_property
    def _log_mu(self) -> np.ndarray:
        return legendre.log_mu(self.m_max)

    @functools.cached_property
    def _m_all(self) -> np.ndarray:
        return np.arange(self.m_max + 1)

    @functools.cached_property
    def phase(self):
        return make_phase(self.grid, self.m_max)

    @property
    def _rdt(self):
        return _DTYPES[self.dtype]

    @functools.cached_property
    def _cores(self) -> dict:
        return {}

    def _harmonic_core(self, spin: int) -> legendre.HarmonicCore:
        """The recurrence layer of ``spin`` bound to this grid and band
        limit (kept per spin)."""
        if spin not in self._cores:
            g = self.grid
            self._cores[spin] = legendre.HarmonicCore(
                m_vals=self._m_all, grid_x=g.cos_theta, grid_sin=g.sin_theta,
                log_mu_all=self._log_mu, l_max=self.l_max, spin=spin,
                dtype=self.dtype)
        return self._cores[spin]

    def _delta_from_alm(self, alm: torch.Tensor) -> torch.Tensor:
        """(M, L, K) complex alm -> (M, R, K) complex Delta."""
        g = self.grid
        if not self.fold:
            return self._harmonic_core(0).delta_from_alm(alm)
        a_re, a_im = alm.real.to(self._rdt), alm.imag.to(self._rdt)
        nh = self.n_north
        ere, eim, ore_, oim = legendre.delta_from_alm_folded(
            a_re, a_im, self._m_all, g.cos_theta[:nh], g.sin_theta[:nh],
            self._log_mu, l_max=self.l_max)
        north = torch.complex(ere + ore_, eim + oim)
        ns = nh - 1 if self.has_equator else nh
        south = torch.complex((ere - ore_)[:, :ns], (eim - oim)[:, :ns])
        return torch.cat([north, south.flip(1)], dim=1)

    def _alm_from_delta(self, delta_w: torch.Tensor) -> torch.Tensor:
        """(M, R, K) weighted Delta -> (M, L, K) complex alm."""
        g = self.grid
        if not self.fold:
            return self._harmonic_core(0).alm_from_delta(delta_w)
        nh = self.n_north
        north = delta_w[:, :nh]
        ns = nh - 1 if self.has_equator else nh
        south = delta_w[:, nh:].flip(1)                  # mirror order
        if self.has_equator:
            south = torch.cat([south, torch.zeros_like(north[:, ns:nh])],
                              dim=1)
        s_e = north + south
        s_o = north - south
        a_re, a_im = legendre.alm_from_delta_folded(
            s_e.real, s_e.imag, s_o.real, s_o.imag, self._m_all,
            g.cos_theta[:nh], g.sin_theta[:nh], self._log_mu,
            l_max=self.l_max)
        return torch.complex(a_re, a_im)

    def alm2map(self, alm: torch.Tensor) -> torch.Tensor:
        """Inverse SHT (synthesis): alm (M, L, K) -> maps (R, n_phi, K)."""
        if tuple(alm.shape[:2]) != (self.m_max + 1, self.l_max + 1):
            raise ValueError(f"alm shape {tuple(alm.shape)} does not match "
                             f"(m_max+1, l_max+1) = "
                             f"({self.m_max + 1}, {self.l_max + 1})")
        return self.phase.synth(self._delta_from_alm(alm))

    def map2alm(self, maps: torch.Tensor, iters: int = 0) -> torch.Tensor:
        """Direct SHT (analysis): maps (R, n_phi, K) -> alm (M, L, K).

        ``iters`` > 0 applies Jacobi residual refinement
        a <- a + A(m - S(a)), one synthesis and one analysis per pass.
        """
        if maps.shape[0] != self.grid.n_rings:
            raise ValueError(f"maps have {maps.shape[0]} rings, grid has "
                             f"{self.grid.n_rings}")
        alm = self._alm_from_delta(self.phase.anal(maps.to(self._rdt)))
        for _ in range(iters):
            resid = maps - self.alm2map(alm)
            alm = alm + self.map2alm(resid, iters=0)
        return alm

    # -- spin-2 transforms (polarisation: E/B <-> Q/U) ------------------------

    def _no_fold(self) -> None:
        if self.fold:
            raise ValueError("fold is not supported for spin transforms")

    def alm2map_spin(self, alm_eb: torch.Tensor) -> torch.Tensor:
        """Spin-2 synthesis: (E, B) alm (2, M, L, K) -> (Q, U) maps
        (2, R, n_phi, K)."""
        self._no_fold()
        if tuple(alm_eb.shape[:3]) != (2, self.m_max + 1, self.l_max + 1):
            raise ValueError(f"(E, B) alm shape {tuple(alm_eb.shape)} does "
                             f"not match (2, m_max+1, l_max+1) = "
                             f"(2, {self.m_max + 1}, {self.l_max + 1})")
        K = alm_eb.shape[-1]
        delta = self._harmonic_core(2).delta_from_alm(alm_eb)  # (2, M, R, K)
        s = self.phase.synth(torch.cat([delta[0], delta[1]], dim=-1))
        return torch.stack([s[..., :K], s[..., K:]], dim=0)

    def map2alm_spin(self, maps_qu: torch.Tensor,
                     iters: int = 0) -> torch.Tensor:
        """Spin-2 analysis: (Q, U) maps (2, R, n_phi, K) -> (E, B) alm
        (2, M, L, K); ``iters`` as in :meth:`map2alm`."""
        self._no_fold()
        if maps_qu.shape[0] != 2 or maps_qu.shape[1] != self.grid.n_rings:
            raise ValueError(f"(Q, U) maps shape {tuple(maps_qu.shape)}: "
                             f"expected (2, {self.grid.n_rings}, n_phi, K)")
        K = maps_qu.shape[-1]
        m2 = torch.cat([maps_qu[0], maps_qu[1]], dim=-1).to(self._rdt)
        dw = self.phase.anal(m2)                               # (M, R, 2K)
        alm = self._harmonic_core(2).alm_from_delta(
            torch.stack([dw[..., :K], dw[..., K:]], dim=0))
        for _ in range(iters):
            resid = maps_qu - self.alm2map_spin(alm)
            alm = alm + self.map2alm_spin(resid, iters=0)
        return alm
