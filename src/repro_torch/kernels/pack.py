"""Triangular m-pair packing: the slot layout of the fused (and, later, the
packed) Legendre kernels.

Counterpart of ``repro.kernels.pack``, copied as numpy: layouts are
array-equal to the reference's.  Rows are paired longest-with-shortest
(for the scalar transform exactly ``(m, m_max - m)``), so every *slot*
runs a near-constant ``2*l_max - m_max + 2`` recurrence steps.  A slot's
two coefficient streams sit back to back in one l-stream of length ``S``;
segment 1 seeds at stream position ``slot_seed``, which may fall anywhere
inside a panel, and the recurrence re-seeds itself there because its step
seeds whenever ``l == l0``.  Positions past a segment's ``l_max`` are dead
(``a_row == -1``).

One layout serves both directions: synthesis and analysis consume the same
``slot_m``/``slot_seed`` schedule.  ``a_row``/``a_l``/``alm_src``/
``row_dst`` drive the pack and unpack gathers of ``kernels.ops``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = ["PackedLayout", "build_layout", "panel_counts",
           "fused_lp_candidates"]


def fused_lp_candidates(l_max: int) -> tuple:
    """Panel lengths (``lp_size``) the fused pipeline accepts: 128, and 256
    once a slot spans more than one 128-panel.  The panel length sets the
    stream padding ``S``; the reference measures between them, the port
    keeps 128 (the CUDA kernels walk 32-l tiles, so 256 would only round S
    up): not ported, see ROADMAP.md."""
    return (128, 256) if l_max + 1 > 128 else (128,)


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Static description of a packed (slot, panel) Legendre grid.

    A *slot* fuses (at most) two rows of the plain layout: segment 0 is
    the longer row, segment 1 (if any) seeds at intra-slot step
    ``slot_seed``.  ``slot_*`` arrays are the kernels' per-slot maps;
    ``a_row``/``a_l``/``alm_src``/``row_dst`` drive the pack/unpack
    gathers.
    """

    l_max: int
    lp_size: int
    n_rows: int                  # plain row-slot count (incl. m = -1 pads)
    n_slots: int
    n_sp: int                    # panels per slot (uniform, no skips)
    slot_m: np.ndarray           # (n_slots, 2) i64: m per segment
    slot_mp: np.ndarray          # (n_slots, 2) i64: m' per segment (spin)
    slot_seed: np.ndarray        # (n_slots,) i64: step where segment 1 seeds
    slot_row: np.ndarray         # (n_slots, 2) i64: plain row index; -1 none
    spin: bool

    @property
    def S(self) -> int:
        """Packed l-stream length per slot (n_sp * lp_size)."""
        return self.n_sp * self.lp_size

    @property
    def n_panels(self) -> int:
        """Panels per ring block -- the packed panel count."""
        return self.n_slots * self.n_sp

    @functools.cached_property
    def _stream(self) -> tuple[np.ndarray, np.ndarray]:
        """(row, l) per packed stream position, each (n_slots, S); -1 where
        the position is tail padding past a segment's l_max."""
        g = np.arange(self.S)[None, :]                      # (1, S)
        seg1 = g >= self.slot_seed[:, None]                 # (n_slots, S)
        l0 = np.maximum(self.slot_m, np.abs(self.slot_mp))  # (n_slots, 2)
        l = np.where(seg1, l0[:, 1:2] + g - self.slot_seed[:, None],
                     l0[:, 0:1] + g)
        row = np.where(seg1, self.slot_row[:, 1:2], self.slot_row[:, 0:1])
        valid = (row >= 0) & (l <= self.l_max)
        return (np.where(valid, row, -1).astype(np.int64),
                np.where(valid, l, -1).astype(np.int64))

    @property
    def a_row(self) -> np.ndarray:
        """(n_slots, S) plain row index per stream position (-1 padding)."""
        return self._stream[0]

    @property
    def a_l(self) -> np.ndarray:
        """(n_slots, S) multipole l per stream position (-1 padding)."""
        return self._stream[1]

    @functools.cached_property
    def alm_src(self) -> np.ndarray:
        """(n_rows, l_max + 1) flat index into the (n_slots * S) packed
        l-stream; -1 where the (row, l) pair does not exist (l < l0 or a
        padding row)."""
        out = np.full((self.n_rows, self.l_max + 1), -1, dtype=np.int64)
        row, l = self._stream
        valid = row >= 0
        flat = np.arange(self.n_slots * self.S).reshape(self.n_slots, self.S)
        out[row[valid], l[valid]] = flat[valid]
        return out

    @functools.cached_property
    def row_dst(self) -> np.ndarray:
        """(n_rows,) flat index into (n_slots * 2) segments; -1 padding."""
        out = np.full(self.n_rows, -1, dtype=np.int64)
        for s in range(self.n_slots):
            for seg in range(2):
                r = int(self.slot_row[s, seg])
                if r >= 0:
                    out[r] = 2 * s + seg
        return out

    def occupancy(self) -> float:
        """Useful recurrence steps / executed steps of the packed grid."""
        return float(np.count_nonzero(self.a_row >= 0)) \
            / float(self.n_slots * self.S)


def _build(m_key: bytes, mp_key: bytes | None, n_rows: int, l_max: int,
           lp_size: int) -> PackedLayout | None:
    m_vals = np.frombuffer(m_key, dtype=np.int64)
    spin = mp_key is not None
    mp_vals = (np.frombuffer(mp_key, dtype=np.int64) if spin
               else np.zeros(n_rows, np.int64))
    rows = np.where(m_vals >= 0)[0]
    if rows.size == 0:
        return None
    l0 = np.maximum(m_vals[rows], np.abs(mp_vals[rows]))
    if int(np.max(l0)) > l_max:
        return None                        # a row with no l-range: bail out
    lengths = l_max + 1 - l0
    order = rows[np.argsort(-lengths, kind="stable")]
    n = order.size
    n_slots = (n + 1) // 2
    slot_row = np.full((n_slots, 2), -1, dtype=np.int64)
    slot_row[:, 0] = order[:n_slots]                     # longest first
    slot_row[: n - n_slots, 1] = order[::-1][: n - n_slots]
    seg_valid = slot_row >= 0
    safe = np.maximum(slot_row, 0)
    slot_m = np.where(seg_valid, m_vals[safe], 0)
    slot_mp = np.where(seg_valid, mp_vals[safe], 0)
    # duplicate segment 0 into empty segment 1 slots so in-kernel selects
    # stay benign; slot_seed = S means the seam is never reached.
    slot_m[:, 1] = np.where(seg_valid[:, 1], slot_m[:, 1], slot_m[:, 0])
    slot_mp[:, 1] = np.where(seg_valid[:, 1], slot_mp[:, 1], slot_mp[:, 0])
    len0 = l_max + 1 - np.maximum(slot_m[:, 0], np.abs(slot_mp[:, 0]))
    len1 = np.where(seg_valid[:, 1],
                    l_max + 1 - np.maximum(slot_m[:, 1],
                                           np.abs(slot_mp[:, 1])), 0)
    n_sp = int(-(-int(np.max(len0 + len1)) // lp_size))
    S = n_sp * lp_size
    slot_seed = np.where(seg_valid[:, 1], len0, S).astype(np.int64)
    return PackedLayout(
        l_max=int(l_max), lp_size=int(lp_size), n_rows=int(n_rows),
        n_slots=int(n_slots), n_sp=n_sp,
        slot_m=slot_m.astype(np.int64), slot_mp=slot_mp.astype(np.int64),
        slot_seed=slot_seed, slot_row=slot_row, spin=bool(spin))


@functools.lru_cache(maxsize=128)
def _build_cached(m_key, mp_key, n_rows, l_max, lp_size):
    return _build(m_key, mp_key, n_rows, l_max, lp_size)


def build_layout(m_vals, l_max: int, *, lp_size: int = 128,
                 mp_vals=None) -> PackedLayout | None:
    """Build (or fetch) the packed layout for a concrete row set.

    Rows with ``m < 0`` (plan padding) are excluded from the packed grid
    entirely; returns None when nothing remains.
    """
    m = np.asarray(m_vals, dtype=np.int64)
    mp_key = (np.ascontiguousarray(
        np.asarray(mp_vals, dtype=np.int64)).tobytes()
        if mp_vals is not None else None)
    return _build_cached(np.ascontiguousarray(m).tobytes(), mp_key,
                         int(m.shape[0]), int(l_max), int(lp_size))


def panel_counts(m_vals, l_max: int, *, lp_size: int = 128,
                 mp_vals=None) -> dict:
    """Panel accounting, plain vs packed, for a concrete row set.

    ``plain_launched`` counts every panel of the dense rectangular grid;
    ``plain_worked`` the subset on or above the diagonal; ``packed`` the
    packed grid's panel count (every one works).  ``ideal_steps`` is the
    paper's triangular invariant, sum over rows of ``l_max - l0 + 1``.
    """
    m = np.asarray(m_vals, dtype=np.int64)
    n_rows = int(m.shape[0])
    L1p = -(-(l_max + 1) // lp_size) * lp_size
    n_lp = L1p // lp_size
    plain_launched = n_rows * n_lp
    skipped = np.where(m >= 0, np.maximum(m, 0) // lp_size, 0)
    plain_worked = int(n_rows * n_lp - np.sum(skipped))
    layout = build_layout(m, l_max, lp_size=lp_size, mp_vals=mp_vals)
    packed = 0 if layout is None else layout.n_panels
    if mp_vals is None:
        l0 = np.where(m >= 0, np.maximum(m, 0), l_max + 1)
    else:
        mp = np.asarray(mp_vals, dtype=np.int64)
        l0 = np.where(m >= 0, np.maximum(np.maximum(m, 0), np.abs(mp)),
                      l_max + 1)
    ideal = int(np.sum(np.maximum(l_max + 1 - l0, 0)))
    return {
        "lp_size": int(lp_size),
        "plain_launched": int(plain_launched),
        "plain_worked": plain_worked,
        "packed": int(packed),
        "ideal_steps": ideal,
        "launched_ratio": (plain_launched / packed) if packed else 0.0,
        "worked_ratio": (plain_worked / packed) if packed else 0.0,
        "packed_occupancy": (ideal / (packed * lp_size)) if packed else 0.0,
    }
