"""The port's host-side packing against the reference: the slot layout
(``kernels.pack``), the rotation tables of the fused pipeline
(``core.phase.uniform_rotation_tables``, ``kernels.fused._rotation_tables``)
and the pack/unpack gathers of ``kernels.ops``.  All numpy or exact index
operations, so every comparison is array equality."""

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables float64 in the reference)
from repro.core import grids as rgrids
from repro.core import phase as rphase
from repro.kernels import fused as rfused
from repro.kernels import ops as rops
from repro.kernels import pack as rpack

from repro_torch.core import phase
from repro_torch.kernels import fused, ops, pack

L_MAXES = [8, 17, 24, 31]
FIELDS = ["slot_m", "slot_mp", "slot_seed", "slot_row", "a_row", "a_l",
          "alm_src", "row_dst"]


def row_sets(l_max):
    """The plan's rows, a row set with plan padding, and a narrow m_max."""
    full = np.arange(l_max + 1)
    padded = np.insert(np.concatenate([full, [-1]]), 3, -1)
    return [full, padded, np.arange(l_max // 2 + 1)]


@pytest.mark.parametrize("lp_size", [128, 256])
@pytest.mark.parametrize("l_max", L_MAXES)
def test_build_layout_matches_reference(l_max, lp_size):
    for m_vals in row_sets(l_max):
        got = pack.build_layout(m_vals, l_max, lp_size=lp_size)
        want = rpack.build_layout(m_vals, l_max, lp_size=lp_size)
        for f in ("l_max", "lp_size", "n_rows", "n_slots", "n_sp", "S",
                  "spin", "n_panels"):
            assert getattr(got, f) == getattr(want, f), f
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        assert got.occupancy() == want.occupancy()
        assert pack.panel_counts(m_vals, l_max, lp_size=lp_size) == \
            rpack.panel_counts(m_vals, l_max, lp_size=lp_size)


def test_layout_edge_cases_match_reference():
    assert pack.build_layout([-1, -1], 8) is None
    assert rpack.build_layout([-1, -1], 8) is None
    for l_max in (0, 1, 127, 128, 200):
        assert pack.fused_lp_candidates(l_max) == \
            rpack.fused_lp_candidates(l_max)


@pytest.mark.parametrize("direction", ["synth", "anal"])
@pytest.mark.parametrize("l_max", L_MAXES)
def test_uniform_rotation_tables_match_reference(l_max, direction):
    """Random ring offsets, and FFT lengths that put rows on the conjugate
    half (n < 2 m_max) and on the Nyquist bin (n == 2 m), beside the GL
    length; padding rows are zero."""
    rng = np.random.default_rng(l_max)
    m_vals = np.concatenate([np.arange(l_max + 1), [-1]])
    phi0 = rng.uniform(0, 2 * np.pi, l_max + 3)
    for n in (2 * l_max + 2, 2 * l_max, l_max + 3):
        got = phase.uniform_rotation_tables(m_vals, phi0, n, direction)
        want = rphase.uniform_rotation_tables(m_vals, phi0, n, direction)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("l_max", L_MAXES)
def test_fused_rotation_tables_match_reference(l_max, fold):
    """Fold on: north plane, reversed south plane, zero rows past the
    southern count (odd ring counts at even l_max).  GL tables are the
    identity unless a zero row is needed."""
    g = rgrids.make_grid("gl", l_max=l_max)
    nh = (g.n_rings + 1) // 2
    phi0 = np.random.default_rng(1).uniform(0, 1, g.n_rings)
    m_vals = np.arange(l_max + 1)
    for direction in ("synth", "anal"):
        kw = dict(phase_kind="uniform", n=g.max_n_phi, phi0=phi0,
                  fold_rings=g.n_rings if fold else None,
                  n_half=nh if fold else g.n_rings)
        got = fused._rotation_tables(m_vals, direction, **kw)
        want = rfused._rotation_tables(m_vals, direction, **kw)
        np.testing.assert_array_equal(got, want)
        assert fused._tables_identity(got) == rfused._tables_identity(want)
    gl = fused._rotation_tables(m_vals, "synth", phase_kind="uniform",
                                n=g.max_n_phi, phi0=g.phi0,
                                fold_rings=g.n_rings if fold else None,
                                n_half=nh if fold else g.n_rings)
    # a fold table is the identity only when every north ring has a mirror
    assert fused._tables_identity(gl) == (not fold or g.n_rings % 2 == 0)


@pytest.mark.parametrize("l_max", [17, 24])
def test_pack_gathers_match_reference(l_max):
    """``_pack_a``, ``_pack_rows``, ``_unpack_rows``, ``_unpack_alm`` and
    ``_pack_maps`` against the reference's jnp gathers, with padding rows."""
    m_vals = row_sets(l_max)[1]
    lo, rlo = (pack.build_layout(m_vals, l_max),
               rpack.build_layout(m_vals, l_max))
    rng = np.random.default_rng(0)
    Mp, L1 = len(m_vals), l_max + 1
    a = rng.uniform(-1, 1, (Mp, L1, 6)).astype(np.float32)
    rows = rng.integers(-9, 9, (Mp, 2, 5)).astype(np.int32)
    seg = rng.uniform(-1, 1, (lo.n_slots * 2, 3, 4)).astype(np.float32)
    packed = rng.uniform(-1, 1, (lo.n_slots, lo.S, 6)).astype(np.float32)
    t = torch.as_tensor
    for got, want in [
            (ops._pack_a(t(a), lo), rops._pack_a(a, rlo)),
            (ops._pack_rows(t(rows), lo), rops._pack_rows(rows, rlo)),
            (ops._unpack_rows(t(seg), lo, Mp), rops._unpack_rows(seg, rlo, Mp)),
            (ops._unpack_alm(t(packed), lo), rops._unpack_alm(packed, rlo))]:
        want = np.asarray(want)
        assert got.dtype == t(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(ops._pack_maps(lo, "cpu"), rops._pack_maps(rlo)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops._pad_to(130, 128) == rops._pad_to(130, 128) == 256
