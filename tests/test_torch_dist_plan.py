"""The distributed transform's host side against the reference's.

``repro_torch.core.plan.SHTPlan`` deals m rows and ring pairs exactly as
``repro.core.plan.SHTPlan`` does, so every array it builds must be equal;
``core.comm_model`` is the same arithmetic, so it agrees to 1e-12
relative, as does the dist branch of the cost model under the host model
(the reference's own figures).
"""
import numpy as np
import pytest
import torch

from repro.core import comm_model as rcm
from repro.core import grids as rgrids
from repro.core import phase as rphase
from repro.core import plan as rplan
from repro.roofline import analysis as rra
from repro_torch.core import comm_model as cm
from repro_torch.core import grids, phase
from repro_torch.core import plan as tplan
from repro_torch.roofline import analysis as ra

#: small grids of every kind: GL, ECP, true (ragged) HEALPix and
#: ring-uniform HEALPix
GRIDS = [("gl", dict(l_max=12)), ("ecp", dict(l_max=11)),
         ("healpix", dict(nside=4)), ("healpix_ring", dict(nside=4))]
SHARDS = [1, 2, 3, 4, 8]


def plans(kind, kw, n_shards, comm_chunks=1):
    """(port plan, reference plan) on the same grid."""
    l_max = kw.get("l_max") or 2 * kw["nside"]
    g = grids.make_grid(kind, **kw)
    rg = rgrids.make_grid(kind, **kw)
    return (tplan.SHTPlan(g, l_max, l_max, n_shards, comm_chunks),
            rplan.SHTPlan(rg, l_max, l_max, n_shards, comm_chunks))


def test_minmax_order_equals_the_reference():
    for m_max in range(0, 12):
        assert np.array_equal(tplan.minmax_m_order(m_max),
                              rplan.minmax_m_order(m_max))


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("kind,kw", GRIDS)
def test_every_member_equals_the_reference(kind, kw, n_shards):
    """m dealing, ring dealing (bucket-aware on the ragged grid), the local
    FFT layout, bin maps, geometry and the description, array-equal."""
    p, r = plans(kind, kw, n_shards)
    for name in ("m_assignment", "m_flat", "recurrence_steps_per_shard",
                 "_pairs", "ring_order", "slot_fft_len", "north_order"):
        got, want = getattr(p, name), getattr(r, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for name in ("m_local", "n_pairs_pad", "r_pad", "r_local"):
        assert getattr(p, name) == getattr(r, name), name
    for got, want in zip(p.fft_bin_maps, r.fft_bin_maps):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    lo, rlo = p.local_fft_layout, r.local_fft_layout
    assert lo.lengths == rlo.lengths
    assert len(lo.slots) == len(rlo.slots)
    assert all(np.array_equal(a, b) for a, b in zip(lo.slots, rlo.slots))
    assert np.array_equal(lo.fft_lengths, rlo.fft_lengths)
    geo, rgeo = p.ring_geometry, r.ring_geometry
    assert set(geo) == set(rgeo)
    for k in geo:
        assert geo[k].dtype == rgeo[k].dtype and np.array_equal(geo[k],
                                                                rgeo[k]), k
    if not p.grid.uniform:
        got, want = p._bucket_deal, r._bucket_deal
        assert got[0] == want[0] and got[1] == want[1]
        assert np.array_equal(got[2], want[2])
    assert p.describe() == r.describe()


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_local_bucket_index_matches_the_reference_bin_maps(n_shards):
    """On the ragged grid a rank's bucket index over its local slots (the
    local FFT layout, its slice of the slot n_phi, every m_flat row)
    carries the rank's columns of the reference's sharded bin maps."""
    p, r = plans("healpix", dict(nside=4), n_shards)
    pos, neg = r.fft_bin_maps                       # (R_pad, Mp)
    for rank in range(n_shards):
        sl = slice(rank * p.r_local, (rank + 1) * p.r_local)
        bidx = phase.bucket_index(p.m_flat, p.ring_geometry["n_phi"][sl],
                                  p.local_fft_layout, p.grid.max_n_phi)
        assert np.array_equal(bidx.pos, pos[sl].T)
        assert np.array_equal(bidx.neg, neg[sl].T)


@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("C", [1, 2, 4, 64])
@pytest.mark.parametrize("K", [1, 3, 8])
def test_chunk_schedule_equals_the_reference(K, C, ncomp):
    for n_shards in (1, 3, 4):
        p, r = plans("gl", dict(l_max=12), n_shards, comm_chunks=C)
        assert p.chunk_schedule(K, ncomp=ncomp) == \
            r.chunk_schedule(K, ncomp=ncomp)
        for chunks in (None, 1, 3):
            assert p.chunk_schedule(K, ncomp, chunks) == \
                r.chunk_schedule(K, ncomp, chunks)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("kind,kw", GRIDS)
def test_pack_and_scatter_round_trips(kind, kw, n_shards):
    """pack_alm / gather_map equal the reference's on numpy (padding rows
    and dummy rings zero); unpack_alm / scatter_map invert them; a tensor
    goes through the same maps on its own device."""
    p, r = plans(kind, kw, n_shards)
    rng = np.random.default_rng(n_shards)
    L = p.l_max + 1
    alm = rng.standard_normal((L, L, 3)) + 1j * rng.standard_normal((L, L, 3))
    maps = rng.standard_normal((p.grid.n_rings, p.grid.max_n_phi, 2))
    packed, rpacked = p.pack_alm(alm), r.pack_alm(alm)
    assert np.array_equal(packed, rpacked)
    assert np.array_equal(p.unpack_alm(packed), r.unpack_alm(rpacked))
    assert np.array_equal(p.unpack_alm(packed), alm)
    assert not packed[p.m_flat < 0].any()
    gm, rgm = p.gather_map(maps), r.gather_map(maps)
    assert np.array_equal(gm, rgm)
    assert not gm[p.ring_order < 0].any()
    assert np.array_equal(p.scatter_map(gm), r.scatter_map(rgm))
    assert np.array_equal(p.scatter_map(gm), maps)
    t_alm, t_maps = torch.as_tensor(alm), torch.as_tensor(maps)
    assert torch.equal(p.pack_alm(t_alm), torch.as_tensor(packed))
    assert torch.equal(p.unpack_alm(p.pack_alm(t_alm)), t_alm)
    assert torch.equal(p.gather_map(t_maps), torch.as_tensor(gm))
    assert torch.equal(p.scatter_map(p.gather_map(t_maps)), t_maps)
    with pytest.raises(ValueError, match="plan is for"):
        p.pack_alm(alm[:, :-1])


def test_comm_model_equals_the_reference():
    """sht_times, sht_times_overlap, best_chunks and crossover_nproc under
    the paper's and the TPU constants, 1e-12 relative."""
    def close(a, b):
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-12 * max(abs(b[k]), 1e-300), k

    for params, rparams in ((cm.MPICH_CLUSTER, rcm.MPICH_CLUSTER),
                            (cm.TPU_V5E_ICI, rcm.TPU_V5E_ICI)):
        assert params == cm.CommParams(**vars(rparams))
        for nside in (64, 512, 2048):
            for n_proc in (1, 2, 8, 64, 1024):
                for fold in (False, True):
                    close(cm.sht_times(nside, n_proc, params, fold=fold),
                          rcm.sht_times(nside, n_proc, rparams, fold=fold))
                    for chunks in (None, 1, 4):
                        close(cm.sht_times_overlap(nside, n_proc, params,
                                                   chunks=chunks, fold=fold),
                              rcm.sht_times_overlap(nside, n_proc, rparams,
                                                    chunks=chunks,
                                                    fold=fold))
                assert cm.best_chunks(nside, n_proc, params) == \
                    rcm.best_chunks(nside, n_proc, rparams)
            assert cm.crossover_nproc(nside, params) == \
                rcm.crossover_nproc(nside, rparams)


@pytest.mark.parametrize("kind,kw", GRIDS)
def test_dist_cost_model_equals_the_reference(kind, kw):
    """predict_sht_time("dist") with the overlap on and off, C 1-8, and
    predict_comm_chunks under HW_HOST, 1e-12 relative."""
    g = grids.make_grid(kind, **kw)
    rg = rgrids.make_grid(kind, **kw)
    l_max = kw.get("l_max") or 2 * kw["nside"]
    fl = phase.make_phase(g, l_max).fft_lengths
    assert np.array_equal(fl, rphase.make_phase(rg, l_max,
                                                "float64").fft_lengths)
    for K in (1, 4):
        for spin in (0, 2):
            for n_dev in (1, 2, 4, 8):
                kw_ = dict(l_max=l_max, m_max=l_max, n_rings=g.n_rings,
                           n_phi=g.max_n_phi, K=K, n_devices=n_dev,
                           fft_lengths=fl, spin=spin)
                for d in ("synth", "anal"):
                    for overlap in (False, True):
                        for C in range(1, 9):
                            got = ra.predict_sht_time(
                                "dist", hw=ra.HW_HOST, direction=d,
                                overlap=overlap, comm_chunks=C, **kw_)
                            want = rra.predict_sht_time(
                                "dist", hw=rra.HW_HOST, direction=d,
                                overlap=overlap, comm_chunks=C, **kw_)
                            assert abs(got - want) <= 1e-12 * want
                    assert ra.predict_comm_chunks(
                        hw=ra.HW_HOST, direction=d, **kw_) == \
                        rra.predict_comm_chunks(hw=rra.HW_HOST, direction=d,
                                                **kw_)
