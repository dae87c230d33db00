"""Iso-latitude ring grids for the PyTorch port (Gauss-Legendre only).

Counterpart of ``repro.core.grids``: the geometry is host-side numpy
float64, computed once at plan time and held array-equal to the
reference.  Only the ``gl`` family is ported; ECP and the HEALPix family
wait for ROADMAP.md Open items section 1, item 8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["RingGrid", "gauss_legendre_grid", "make_grid"]


@dataclasses.dataclass(frozen=True)
class RingGrid:
    """Geometry of an iso-latitude ring grid, rings north to south.

    ``weights`` is the quadrature weight per sample on a ring; ``phi0`` the
    azimuth of each ring's first sample.
    """

    name: str
    cos_theta: np.ndarray     # (R,) float64, descending
    sin_theta: np.ndarray     # (R,) float64, > 0
    weights: np.ndarray       # (R,) float64
    n_phi: np.ndarray         # (R,) int64
    phi0: np.ndarray          # (R,) float64
    uniform: bool
    nside: Optional[int] = None

    @property
    def n_rings(self) -> int:
        return int(self.cos_theta.shape[0])

    @property
    def n_pix(self) -> int:
        return int(self.n_phi.sum())

    @property
    def max_n_phi(self) -> int:
        return int(self.n_phi.max())

    @property
    def equator_symmetric(self) -> bool:
        """True if ring i and ring R-1-i are mirror images (cos -> -cos)."""
        ct = self.cos_theta
        return bool(np.allclose(ct, -ct[::-1], atol=1e-12))

    def validate(self) -> None:
        r = self.n_rings
        for arr in (self.sin_theta, self.weights, self.n_phi, self.phi0):
            if arr.shape != (r,):
                raise ValueError(f"grid field shape {arr.shape} != ({r},)")
        if not np.all(np.diff(self.cos_theta) < 0):
            raise ValueError("rings must go north -> south")
        if not np.all(self.sin_theta > 0) or not np.all(self.n_phi >= 1):
            raise ValueError("degenerate ring geometry")
        total = float(np.sum(self.weights * self.n_phi))
        if abs(total - 4.0 * np.pi) >= 1e-6 * 4.0 * np.pi:
            raise ValueError(f"weights sum to {total}, not 4 pi")


def _gauss_legendre_nodes(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Nodes (descending) and weights of n-point Gauss-Legendre quadrature.

    Newton iteration on P_n from the Chebyshev initial guess, float64, the
    same iteration as the reference so the nodes agree bit for bit.
    """
    k = np.arange(1, n + 1, dtype=np.float64)
    x = np.cos(np.pi * (k - 0.25) / (n + 0.5))
    for _ in range(100):
        p0 = np.ones_like(x)
        p1 = x.copy()
        for ell in range(2, n + 1):
            p0, p1 = p1, ((2 * ell - 1) * x * p1 - (ell - 1) * p0) / ell
        dp = n * (x * p1 - p0) / (x * x - 1.0)
        dx = p1 / dp
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    p0 = np.ones_like(x)
    p1 = x.copy()
    for ell in range(2, n + 1):
        p0, p1 = p1, ((2 * ell - 1) * x * p1 - (ell - 1) * p0) / ell
    dp = n * (x * p1 - p0) / (x * x - 1.0)
    w = 2.0 / ((1.0 - x * x) * dp * dp)
    return x, w


def gauss_legendre_grid(l_max: int, n_rings: Optional[int] = None,
                        n_phi: Optional[int] = None) -> RingGrid:
    """Gauss-Legendre grid, exact for fields band-limited at ``l_max``.

    Defaults: ``n_rings = l_max + 1``, ``n_phi = 2 * l_max + 2``.
    """
    if n_rings is None:
        n_rings = l_max + 1
    if n_phi is None:
        n_phi = 2 * l_max + 2
    x, w = _gauss_legendre_nodes(n_rings)
    return RingGrid(
        name="gl",
        cos_theta=x,
        sin_theta=np.sqrt(1.0 - x * x),
        weights=w * (2.0 * np.pi / n_phi),
        n_phi=np.full(n_rings, n_phi, dtype=np.int64),
        phi0=np.zeros(n_rings, dtype=np.float64),
        uniform=True,
    )


def make_grid(kind: str, *, l_max: Optional[int] = None,
              nside: Optional[int] = None, **kw) -> RingGrid:
    """Build and validate a grid; only ``"gl"`` is ported."""
    if kind != "gl":
        raise ValueError(
            f"grid kind {kind!r} is not ported yet: ECP and the HEALPix "
            "family wait for ROADMAP.md Open items section 1, item 8")
    if l_max is None:
        raise ValueError("gl grid needs l_max")
    g = gauss_legendre_grid(l_max, **kw)
    g.validate()
    return g
