"""SHTPlan: the data-distribution plan of the distributed transform.

Counterpart of ``repro.core.plan``.  Encodes the paper's §4.1.1 layout
decisions as static host-side numpy arrays that ``core.dist_sht`` consumes:

* **m distribution with min-max pairing** (paper Fig. 5): the global m list
  is reordered as [0, m_max, 1, m_max-1, ...] and pairs are dealt
  round-robin to shards, so every shard's total recurrence length is the
  paper's invariant, the sum over its pairs of (2 l_max - m_max + 2).
  Padding slots (m = -1) give every shard the same slot count, so one
  fixed-size all-to-all stands in for ``MPI_Alltoallv``.
* **ring distribution**: rings are dealt as blocks of mirror pairs (north,
  south mirror), so each shard can fold about the equator; dummy rings
  (weight 0) pad the ring count to a multiple of the shard count.
* **bucket-aware dealing (ragged grids)**: on a grid with variable n_phi
  the mirror pairs are dealt per FFT bucket (``grids.ring_buckets``), each
  bucket's pair list padded to a multiple of the shard count, so every
  shard owns as many rings of every bucket (balanced Legendre and FFT
  work, paper §4.1) and the same local slot -> bucket structure
  (:attr:`SHTPlan.local_fft_layout`).

The plan is pure geometry: numpy and float64 on the host.  Its pack and
scatter helpers take numpy arrays (and return numpy) or tensors on any
device (and index on that device).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.grids import BucketLayout, RingGrid

__all__ = ["SHTPlan", "minmax_m_order", "Plan", "make_plan", "drop_plan"]


def __getattr__(name):
    """``Plan`` / ``make_plan`` / ``drop_plan`` live in
    ``repro_torch.core.transform``; resolved lazily, so this module stays
    host-side geometry."""
    if name in ("Plan", "make_plan", "drop_plan"):
        from repro_torch.core import transform
        return getattr(transform, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def minmax_m_order(m_max: int) -> np.ndarray:
    """[0, m_max, 1, m_max-1, ...]: the min-max pair ordering."""
    out = np.empty(m_max + 1, dtype=np.int64)
    out[0::2] = np.arange((m_max + 2) // 2)
    out[1::2] = m_max - np.arange((m_max + 1) // 2)
    return out


def _rows(index: np.ndarray, like):
    """``index`` as an index into ``like``'s first axis: numpy for numpy,
    an int64 tensor on the tensor's device."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(index, dtype=torch.int64, device=like.device)
    return index


def _masked_rows(arr, index: np.ndarray):
    """``arr[index]`` along the first axis, zero where ``index`` is -1."""
    out = arr[_rows(np.maximum(index, 0), arr)]
    mask = (index >= 0).reshape((-1,) + (1,) * (arr.ndim - 1))
    if isinstance(arr, torch.Tensor):
        return torch.where(torch.as_tensor(mask, device=arr.device), out,
                           torch.zeros((), dtype=out.dtype,
                                       device=out.device))
    return np.where(mask, out, np.zeros_like(out))


def _slot_of(index: np.ndarray, n: int) -> np.ndarray:
    """(n,) the slot of each of 0..n-1 in ``index`` (a slot -> value map
    that holds each value once, -1 for the padding slots)."""
    out = np.full(n, -1, dtype=np.int64)
    slots = np.nonzero(index >= 0)[0]
    out[index[slots]] = slots
    if (out < 0).any():
        raise ValueError("the slot map misses a value")
    return out


@dataclasses.dataclass(frozen=True)
class SHTPlan:
    """Distribution plan of a (grid, l_max, m_max, n_shards) problem.

    ``comm_chunks`` is the default chunk count of the chunked exchange
    (``DistSHT`` overrides it per engine): the Delta block is split into C
    chunks so each chunk's all-to-all overlaps the adjacent chunk's
    Legendre or FFT work.  :meth:`chunk_schedule` says which axis the split
    rides on for a given K.
    """

    grid: RingGrid
    l_max: int
    m_max: int
    n_shards: int
    comm_chunks: int = 1

    # ---- m axis ------------------------------------------------------------

    @functools.cached_property
    def m_assignment(self) -> np.ndarray:
        """(n_shards, m_local) global m of each slot; -1 = padding.

        The pairs of :func:`minmax_m_order` are dealt round-robin, pair p
        to shard p % n_shards, which keeps the paper's balance invariant.
        """
        order = minmax_m_order(self.m_max)
        # pairs [(0, m_max), (1, m_max-1), ...]; an odd count leaves a
        # lone middle element as a singleton pair
        pairs = [order[i:i + 2] for i in range(0, len(order), 2)]
        per_shard: list[list[int]] = [[] for _ in range(self.n_shards)]
        for p, pair in enumerate(pairs):
            per_shard[p % self.n_shards].extend(int(v) for v in pair)
        m_local = max(len(s) for s in per_shard)
        out = np.full((self.n_shards, m_local), -1, dtype=np.int64)
        for i, s in enumerate(per_shard):
            out[i, : len(s)] = s
        return out

    @property
    def m_local(self) -> int:
        return self.m_assignment.shape[1]

    @functools.cached_property
    def m_flat(self) -> np.ndarray:
        """(n_shards * m_local,) global m of each global slot, shard-major."""
        return self.m_assignment.reshape(-1)

    @functools.cached_property
    def recurrence_steps_per_shard(self) -> np.ndarray:
        """Work balance: the l-recurrence steps of each shard."""
        a = self.m_assignment
        steps = np.where(a >= 0, self.l_max + 1 - np.maximum(a, 0), 0)
        return steps.sum(axis=1)

    def pack_alm(self, alm):
        """(M, L, ...) dense alm -> (n_shards * m_local, L, ...) in plan
        slot order; padding slots are zero.  numpy in, numpy out; a tensor
        is gathered on its own device."""
        M, L = alm.shape[:2]
        if M != self.m_max + 1 or L != self.l_max + 1:
            raise ValueError(f"alm shape {tuple(alm.shape)}: the plan is for "
                             f"({self.m_max + 1}, {self.l_max + 1}, ...)")
        return _masked_rows(alm, self.m_flat)

    def unpack_alm(self, packed):
        """Inverse of :meth:`pack_alm`: (Mp, L, ...) -> (M, L, ...), the
        padding rows dropped."""
        return packed[_rows(_slot_of(self.m_flat, self.m_max + 1), packed)]

    # ---- chunked-exchange dealing -------------------------------------------

    def chunk_schedule(self, K: int, ncomp: int = 1,
                       chunks: int | None = None) -> tuple[str, tuple]:
        """The split of a C-chunk exchange pipeline.

        Returns ``(axis, bounds)``: ``axis`` is ``"none"`` (C = 1, one
        exchange), ``"k"`` (split the K map axis; the ``ncomp`` spin
        components and the re | im pair ride inside each chunk, so no
        boundary cuts a coupled channel group) or ``"m"`` (K too small:
        split the local m rows), and ``bounds`` the half-open ``(start,
        stop)`` pairs along it.  C is clamped to what the axis can carry.
        """
        C = int(self.comm_chunks if chunks is None else chunks)
        if C <= 1:
            return "none", ()
        if K >= C:
            axis, n = "k", int(K)
        else:
            axis, n = "m", int(self.m_local)
            C = min(C, n)
            if C <= 1:
                return "none", ()
        edges = np.linspace(0, n, C + 1).astype(np.int64)
        bounds = tuple((int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]))
        assert all(b > a for a, b in bounds), bounds
        return axis, bounds

    # ---- ring axis -----------------------------------------------------------

    @functools.cached_property
    def _pairs(self) -> np.ndarray:
        """(n_pairs, 2) mirror pairs (north, south); an equator's south is
        -1."""
        R = self.grid.n_rings
        out = [(i, R - 1 - i) for i in range(R // 2)]
        if R % 2 == 1:
            out.append((R // 2, -1))
        return np.asarray(out, dtype=np.int64)

    @functools.cached_property
    def _bucket_deal(self):
        """Bucket-aware pair dealing of a ragged grid: ``(bucket_lengths,
        counts, ring_order)``.  Pairs are grouped by their FFT bucket (their
        north ring's; mirrors share n_phi on a symmetric grid, checked),
        each bucket's pairs dealt round-robin and padded to ``counts[k]``
        pairs a shard, and the slot order is shard-major with the buckets
        contiguous inside each shard."""
        buckets = self.grid.fft_buckets()
        R = self.grid.n_rings
        ring2b = np.empty(R, dtype=np.int64)
        for k, b in enumerate(buckets):
            ring2b[b.rings] = k
        pairs = self._pairs
        pb = ring2b[pairs[:, 0]]
        south = pairs[:, 1]
        if not np.all((south < 0) | (ring2b[np.maximum(south, 0)] == pb)):
            raise ValueError("a mirror pair spans two FFT buckets (grid not "
                             "symmetric?)")
        n = self.n_shards
        per_bucket = [np.where(pb == k)[0] for k in range(len(buckets))]
        counts = [-(-len(p) // n) for p in per_bucket]
        order = np.full((n, sum(counts), 2), -1, dtype=np.int64)
        for k, p in enumerate(per_bucket):
            off = sum(counts[:k])
            for j, pair_idx in enumerate(p):
                order[j % n, off + j // n] = pairs[pair_idx]
        return [b.length for b in buckets], counts, order.reshape(-1)

    @functools.cached_property
    def n_pairs_pad(self) -> int:
        """Mirror-pair count padded to a multiple of n_shards (per bucket on
        a ragged grid, :attr:`_bucket_deal`)."""
        if not self.grid.uniform:
            return self.n_shards * sum(self._bucket_deal[1])
        n_pairs = (self.grid.n_rings + 1) // 2
        return -(-n_pairs // self.n_shards) * self.n_shards

    @functools.cached_property
    def ring_order(self) -> np.ndarray:
        """(R_pad,) grid ring of each plan slot; -1 = dummy padding ring.

        Pair-interleaved: slot 2i is pair i's northern ring, slot 2i+1 its
        southern mirror.  An odd equator ring is a pair with a dummy south;
        padding pairs are (dummy, dummy).  Every shard owns r_local/2
        consecutive pairs, which the fold and the all-to-all both want.
        """
        if not self.grid.uniform:
            return self._bucket_deal[2]
        R = self.grid.n_rings
        out = np.full(2 * self.n_pairs_pad, -1, dtype=np.int64)
        for i in range(R // 2):
            out[2 * i] = i                 # northern ring
            out[2 * i + 1] = R - 1 - i     # its mirror
        if R % 2 == 1:
            out[2 * (R // 2)] = R // 2     # equator (dummy south partner)
        return out

    @functools.cached_property
    def local_fft_layout(self) -> BucketLayout:
        """The local slot -> FFT bucket structure, the same on every shard
        (a uniform grid: one bucket over all local slots)."""
        if self.grid.uniform:
            return BucketLayout((self.grid.max_n_phi,),
                                (np.arange(self.r_local),))
        lengths, counts, _ = self._bucket_deal
        slots, off = [], 0
        for c in counts:
            slots.append(np.arange(2 * off, 2 * (off + c)))
            off += c
        return BucketLayout(tuple(lengths), tuple(slots))

    @functools.cached_property
    def slot_fft_len(self) -> np.ndarray:
        """(R_pad,) FFT length of each plan slot's bucket."""
        return np.tile(self.local_fft_layout.fft_lengths, self.n_shards)

    @functools.cached_property
    def fft_bin_maps(self) -> tuple[np.ndarray, np.ndarray]:
        """(pos, neg) (R_pad, Mp) int32 alias-fold bin maps in plan slot
        order: ``phase.bucket_bin_maps`` over ``m_flat`` and the slot
        geometry, rings first."""
        from repro_torch.core.phase import bucket_bin_maps
        g = self.ring_geometry
        pos, neg = bucket_bin_maps(self.m_flat, g["n_phi"],
                                   self.slot_fft_len)
        return np.ascontiguousarray(pos.T), np.ascontiguousarray(neg.T)

    @property
    def r_pad(self) -> int:
        return self.ring_order.shape[0]

    @property
    def r_local(self) -> int:
        return self.r_pad // self.n_shards

    @functools.cached_property
    def north_order(self) -> np.ndarray:
        """(n_pairs_pad,) grid ring of each pair's north; -1 = padding."""
        return self.ring_order[0::2]

    @functools.cached_property
    def ring_geometry(self) -> dict[str, np.ndarray]:
        """Per-slot ring geometry (R_pad,); dummy slots have weight 0, a
        benign cos theta, and their bucket's FFT length."""
        g = self.grid
        ro = self.ring_order
        safe = np.maximum(ro, 0)
        dummy = ro < 0
        cos = np.where(dummy, 0.123456, g.cos_theta[safe])
        sin = np.sqrt(1.0 - cos * cos)
        w = np.where(dummy, 0.0, g.weights[safe])
        phi0 = np.where(dummy, 0.0, g.phi0[safe])
        # a dummy slot takes its bucket's FFT length, so the bucket engine's
        # stride arithmetic stays exact (its output is masked away)
        dummy_n = g.max_n_phi if g.uniform else self.slot_fft_len
        nphi = np.where(dummy, dummy_n, g.n_phi[safe])
        return {"cos_theta": cos, "sin_theta": sin, "weights": w,
                "phi0": phi0, "n_phi": nphi, "valid": ~dummy}

    def scatter_map(self, maps_plan):
        """(R_pad, n_phi, ...) plan-order maps -> (R, n_phi, ...) grid
        order (dummy slots dropped)."""
        return maps_plan[_rows(_slot_of(self.ring_order, self.grid.n_rings),
                               maps_plan)]

    def gather_map(self, maps_grid):
        """(R, n_phi, ...) grid-order maps -> (R_pad, n_phi, ...) plan
        order; dummy slots are zero."""
        return _masked_rows(maps_grid, self.ring_order)

    # ---- logs ---------------------------------------------------------------

    def describe(self) -> str:
        steps = self.recurrence_steps_per_shard
        return (f"SHTPlan(grid={self.grid.name}, l_max={self.l_max}, "
                f"m_max={self.m_max}, shards={self.n_shards}, "
                f"m_local={self.m_local}, r_pad={self.r_pad}, "
                f"r_local={self.r_local}, "
                f"balance={steps.min()}/{steps.max()} steps)")
