"""Iso-latitude ring grids for the PyTorch port.

Counterpart of ``repro.core.grids``: the geometry is host-side numpy
float64, computed once at plan time and held array-equal to the
reference.  Four families:

  * ``gl``           -- Gauss-Legendre rings, uniform n_phi (exact
                        quadrature for band-limited fields);
  * ``ecp``          -- equiangular theta rings, uniform n_phi, exact
                        latitude-band area weights;
  * ``healpix_ring`` -- HEALPix ring latitudes, phases and ring areas with
                        a uniform 4 nside samples per ring;
  * ``healpix``      -- true HEALPix (n_phi = 4 i in the polar caps),
                        ragged: its phase stage groups rings into FFT
                        buckets (:func:`ring_buckets`, ``core.phase``'s
                        bucket engine).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["RingGrid", "FFTBucket", "BucketLayout", "ring_buckets",
           "gauss_legendre_grid", "ecp_grid", "healpix_ring_grid",
           "healpix_grid", "make_grid"]


@dataclasses.dataclass(frozen=True)
class FFTBucket:
    """One batched-FFT group of rings.

    Every member ring's ``n_phi`` divides ``length`` (B), which makes the
    padded transform exact: a ring's length-n spectrum embeds at stride
    B/n in the length-B spectrum (synthesis), and zero-padding its n
    samples to B leaves the bins at stride B/n untouched (analysis).
    """

    length: int
    rings: np.ndarray         # grid ring indices served by this bucket

    @property
    def n_rings(self) -> int:
        return int(self.rings.shape[0])


def ring_buckets(n_phi: np.ndarray,
                 max_stretch: Optional[float] = None) -> tuple[FFTBucket, ...]:
    """Group rings by rounded-up FFT length, as the reference does.

    Distinct ring lengths go in descending order; each length n joins the
    smallest existing bucket length B with ``B % n == 0`` (and ``B <=
    max_stretch * n`` when given), else opens its own bucket, so every
    bucket length is a real ring length.  ``max_stretch=1`` gives one
    bucket per distinct length (no padding).
    """
    n_phi = np.asarray(n_phi)
    lengths: list[int] = []
    members: list[list[int]] = []
    for n in np.unique(n_phi)[::-1].tolist():
        n = int(n)
        cands = [i for i, B in enumerate(lengths)
                 if B % n == 0
                 and (max_stretch is None or B <= max_stretch * n)]
        if cands:
            members[min(cands, key=lambda i: lengths[i])].append(n)
        else:
            lengths.append(n)
            members.append([n])
    return tuple(FFTBucket(B, np.where(np.isin(n_phi, ns))[0])
                 for B, ns in zip(lengths, members))


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static slot -> bucket structure of the bucket phase stage:
    ``slots[k]`` are the ring indices whose FFTs run in bucket k at length
    ``lengths[k]``.  Pure numpy."""

    lengths: tuple[int, ...]
    slots: tuple               # of np.ndarray index arrays

    @property
    def n_buckets(self) -> int:
        return len(self.lengths)

    @property
    def fft_lengths(self) -> np.ndarray:
        """(R,) per-ring FFT length (the ring's bucket length)."""
        n = sum(len(s) for s in self.slots)
        out = np.zeros(n, dtype=np.int64)
        for B, sl in zip(self.lengths, self.slots):
            out[np.asarray(sl)] = B
        return out

    def padded_frac(self, n_phi: np.ndarray) -> float:
        """FFT-length inflation from bucketing: sum(B)/sum(n_phi) - 1."""
        n_phi = np.asarray(n_phi)
        tot_b = sum(B * len(sl) for B, sl in zip(self.lengths, self.slots))
        tot_n = float(np.sum(n_phi))
        return float(tot_b / tot_n - 1.0) if tot_n else 0.0

    @classmethod
    def from_buckets(cls, buckets: tuple[FFTBucket, ...]) -> "BucketLayout":
        return cls(tuple(b.length for b in buckets),
                   tuple(np.asarray(b.rings) for b in buckets))


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

    def fft_buckets(self, max_stretch: Optional[float] = None
                    ) -> tuple[FFTBucket, ...]:
        """The FFT buckets of the phase stage: one for a uniform grid,
        :func:`ring_buckets` for a ragged one."""
        if self.uniform:
            return (FFTBucket(self.max_n_phi, np.arange(self.n_rings)),)
        return ring_buckets(self.n_phi, max_stretch)

    def bucket_lengths(self, max_stretch: Optional[float] = None
                       ) -> np.ndarray:
        """(R,) per-ring batched-FFT length under bucketing."""
        return BucketLayout.from_buckets(
            self.fft_buckets(max_stretch)).fft_lengths

    def bucket_permutation(self, max_stretch: Optional[float] = None
                           ) -> np.ndarray:
        """(R,) ring permutation ordering rings bucket-major (stable within
        a bucket)."""
        return np.concatenate(
            [b.rings for b in self.fft_buckets(max_stretch)])

    def validate(self) -> None:
        r = self.n_rings
        for arr in (self.sin_theta, self.weights, self.n_phi, self.phi0):
            if arr.shape != (r,):
                raise ValueError(f"grid field shape {arr.shape} != ({r},)")
        if not np.all(np.diff(self.cos_theta) < 0):
            raise ValueError("rings must go north -> south")
        if not np.all(self.sin_theta > 0) or not np.all(self.n_phi >= 1):
            raise ValueError("degenerate ring geometry")
        if self.uniform and not np.all(self.n_phi == self.n_phi[0]):
            raise ValueError("a uniform grid needs one n_phi on every ring")
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


def ecp_grid(l_max: int, n_rings: Optional[int] = None,
             n_phi: Optional[int] = None) -> RingGrid:
    """Equidistant cylindrical grid, theta_r = (r + 1/2) pi / R.

    Defaults: ``n_rings = 2 (l_max + 1)``, ``n_phi = 2 l_max + 2``.  The
    per-sample weight is the exact latitude-band area over n_phi; the
    theta quadrature is approximate (``map2alm(iters>0)`` refines it).
    """
    if n_rings is None:
        n_rings = 2 * (l_max + 1)
    if n_phi is None:
        n_phi = 2 * l_max + 2
    r = np.arange(n_rings, dtype=np.float64)
    theta = (r + 0.5) * np.pi / n_rings
    edge = np.cos(np.arange(n_rings + 1, dtype=np.float64) * np.pi / n_rings)
    band = 2.0 * np.pi * (edge[:-1] - edge[1:])
    return RingGrid(
        name="ecp",
        cos_theta=np.cos(theta),
        sin_theta=np.sin(theta),
        weights=band / n_phi,
        n_phi=np.full(n_rings, n_phi, dtype=np.int64),
        phi0=np.zeros(n_rings, dtype=np.float64),
        uniform=True,
    )


def _healpix_ring_geometry(nside: int):
    """(z, n_phi, phi0) of the HEALPix rings, north to south (Gorski et
    al. 2005): north cap i = 1..nside-1 (z = 1 - i^2 / (3 nside^2),
    n_phi = 4 i, phi0 = pi / (4 i)); equatorial belt i = nside..3 nside
    (z = 4/3 - 2 i / (3 nside), n_phi = 4 nside, phi0 = pi / (4 nside)
    when (i - nside + 1) is odd, else 0); south cap mirrored."""
    if nside < 1:
        raise ValueError(f"nside must be >= 1, got {nside}")
    zs, nphis, phi0s = [], [], []
    for i in range(1, nside):
        zs.append(1.0 - (i * i) / (3.0 * nside * nside))
        nphis.append(4 * i)
        phi0s.append(np.pi / (4.0 * i))
    for i in range(nside, 3 * nside + 1):
        zs.append(4.0 / 3.0 - 2.0 * i / (3.0 * nside))
        nphis.append(4 * nside)
        s = (i - nside + 1) % 2
        phi0s.append((np.pi / (4.0 * nside)) * s)
    for i in range(nside - 1, 0, -1):
        zs.append(-(1.0 - (i * i) / (3.0 * nside * nside)))
        nphis.append(4 * i)
        phi0s.append(np.pi / (4.0 * i))
    return (np.asarray(zs, dtype=np.float64),
            np.asarray(nphis, dtype=np.int64),
            np.asarray(phi0s, dtype=np.float64))


def healpix_grid(nside: int) -> RingGrid:
    """True HEALPix ring grid (ragged n_phi), equal-area sample weights."""
    z, n_phi, phi0 = _healpix_ring_geometry(nside)
    w_pix = 4.0 * np.pi / (12 * nside * nside)
    return RingGrid(
        name="healpix",
        cos_theta=z,
        sin_theta=np.sqrt(1.0 - z * z),
        weights=np.full(z.shape[0], w_pix, dtype=np.float64),
        n_phi=n_phi,
        phi0=phi0,
        uniform=False,
        nside=nside,
    )


def healpix_ring_grid(nside: int) -> RingGrid:
    """Ring-uniform HEALPix: the HEALPix latitudes, phases and ring areas
    with ``n_phi = 4 nside`` samples on every ring (one batched FFT)."""
    z, n_phi_true, phi0 = _healpix_ring_geometry(nside)
    ring_area = (4.0 * np.pi / (12 * nside * nside)) * n_phi_true
    n_phi_u = 4 * nside
    return RingGrid(
        name="healpix_ring",
        cos_theta=z,
        sin_theta=np.sqrt(1.0 - z * z),
        weights=(ring_area / n_phi_u).astype(np.float64),
        n_phi=np.full(z.shape[0], n_phi_u, dtype=np.int64),
        phi0=phi0,
        uniform=True,
        nside=nside,
    )


def make_grid(kind: str, *, l_max: Optional[int] = None,
              nside: Optional[int] = None, **kw) -> RingGrid:
    """Build and validate a grid: ``gl``/``ecp`` take ``l_max`` (and the
    optional ``n_rings``/``n_phi``), ``healpix``/``healpix_ring``
    take ``nside``."""
    if kind in ("gl", "ecp"):
        if l_max is None:
            raise ValueError(f"{kind} grid needs l_max")
        g = (gauss_legendre_grid if kind == "gl" else ecp_grid)(l_max, **kw)
    elif kind in ("healpix", "healpix_ring"):
        if nside is None:
            raise ValueError(f"{kind} grid needs nside")
        g = (healpix_grid if kind == "healpix" else healpix_ring_grid)(nside)
    else:
        raise ValueError(f"unknown grid kind: {kind!r}")
    g.validate()
    return g
