"""The port's fused bucket chains on the CPU (``kernels.fused``'s
``fused_synth_bucket`` / ``fused_anal_bucket`` through the kernels' plain
versions) against the reference's, run in Pallas interpret mode, the fused
layout against the staged ones on HEALPix plans, adjointness through
autograd, and the same bits on every call.

Tolerances: 5e-5 x max|ref| against the reference (the same float32
schedule, rounded differently by the two frameworks; ROADMAP ground
rules); 1e-5 x max against the port's staged layouts (the reference's own
fused-vs-staged band, tests/test_fused.py); 2e-3 on the float32 dot
identities (the reference's float32 band, tests/test_adjoint.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables float64 in the reference)
from repro.core import grids as rgrids
from repro.core import legendre as rleg
from repro.core import phase as rphase
from repro.kernels import fused as rfused

import repro_torch
from repro_torch import interop
from repro_torch.core import phase
from repro_torch.kernels import fused
from repro_torch.kernels import ref as kref

TOL = 5e-5
STAGED_TOL = 1e-5
DOT_TOL = 2e-3


def rel(got, want) -> float:
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def bucket_case(nside, K, spin, seed=0):
    """Seeded numpy inputs for both packages on a HEALPix grid (l_max =
    2 nside): the rows (the 2M spin rows with ``spin``), float32 seeds,
    coefficients zero below each row's first multipole, padded maps, and
    the port's bucket index with the reference's phase stage."""
    g = rgrids.make_grid("healpix", nside=nside)
    l_max = 2 * nside
    m = np.arange(l_max + 1)
    if spin:
        m_vals, mp_vals = rleg._spin_rows(m)
        pmm, pms = kref.prepare_seeds_spin(m_vals, mp_vals, g.cos_theta,
                                           g.sin_theta, m_max=l_max)
        l0 = np.maximum(m_vals, np.abs(mp_vals))
    else:
        m_vals, mp_vals = m, None
        pmm, pms = kref.prepare_seeds(m, g.sin_theta, rleg.log_mu(l_max))
        l0 = m
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (len(m_vals), l_max + 1, 2 * K)).astype(np.float32)
    a *= (np.arange(l_max + 1)[None, :] >= l0[:, None])[..., None]
    C = 2 * K if spin else K
    maps = np.zeros((g.n_rings, g.max_n_phi, C), np.float32)
    for r in range(g.n_rings):
        maps[r, :int(g.n_phi[r])] = rng.normal(size=(int(g.n_phi[r]), C))
    rph = rphase.make_phase(g, l_max, "float64")
    # the port's bucket index on the reference's own geometry and layout
    pg = interop.grid_from_reference(g)
    layout = interop.layout_from_reference(rph.layout)
    return dict(g=g, l_max=l_max, m_vals=m_vals, mp_vals=mp_vals,
                x=g.cos_theta.astype(np.float32), pmm=pmm, pms=pms, a=a,
                maps=maps, rph=rph,
                bucket=phase.bucket_index(m, pg.n_phi, layout, pg.max_n_phi))


def port_args(c):
    t = torch.as_tensor
    return (c["m_vals"], t(c["x"]), t(c["pmm"]), t(c["pms"]))


def port_kw(c, variant):
    return dict(l_max=c["l_max"], bucket=c["bucket"], phi0=c["g"].phi0,
                variant=variant, mp_vals=c["mp_vals"])


@pytest.mark.parametrize("spin", [False, True])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
@pytest.mark.parametrize("nside", [2, 4])
def test_fused_bucket_chains_match_reference(nside, variant, spin):
    c = bucket_case(nside, 2, spin, seed=nside)
    g, rph = c["g"], c["rph"]
    j = jnp.asarray
    rkw = dict(l_max=c["l_max"], layout=rph.layout, pos=rph._pos,
               neg=rph._neg, n_phi=g.n_phi, phi0=g.phi0, variant=variant,
               mp_vals=c["mp_vals"])
    want_s = rfused.fused_synth_bucket(
        j(c["a"]), c["m_vals"], j(c["x"]), j(c["pmm"]), j(c["pms"]),
        out_width=g.max_n_phi, **rkw)
    want_a = rfused.fused_anal_bucket(
        j(c["maps"]), g.weights, c["m_vals"], j(c["x"]), j(c["pmm"]),
        j(c["pms"]), **rkw)
    args = port_args(c)
    got_s = fused.fused_synth_bucket(torch.as_tensor(c["a"]), *args,
                                     **port_kw(c, variant))
    got_a = fused.fused_anal_bucket(torch.as_tensor(c["maps"]), g.weights,
                                    *args, **port_kw(c, variant))
    assert got_s.shape == want_s.shape and got_a.shape == want_a.shape
    assert rel(got_s, want_s) < TOL
    assert rel(got_a, want_a) < TOL


@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("mode", ["cuda_vpu", "cuda_mxu"])
@pytest.mark.parametrize("nside", [4, 8])
def test_fused_bucket_layout_matches_staged(nside, mode, spin):
    """The fused HEALPix plan (the default) against the plain and packed
    layouts of the same plan, both directions."""
    p = repro_torch.make_plan("healpix", nside=nside, K=2, dtype="float32",
                              mode=mode, spin=spin, device="cpu")
    assert p.layouts == {"synth": "fused", "anal": "fused"}
    rng = np.random.default_rng(nside + spin)
    shp = p._alm_shape
    a = rng.uniform(-1, 1, shp) + 1j * rng.uniform(-1, 1, shp)
    keep = np.arange(p.l_max + 1)[None, :] >= np.maximum(
        np.arange(p.m_max + 1), spin)[:, None]
    a = torch.as_tensor((a * keep[..., None]).astype(np.complex64))
    maps = p.alm2map(a)
    alm = p.map2alm(maps)
    for layout in ("plain", "packed"):
        m2 = p._synth_fn(mode, layout)(a)
        assert rel(maps, m2) < STAGED_TOL
        assert rel(alm, p._anal_fn(mode, layout)(maps)) < STAGED_TOL
    # padding past each ring's n_phi stays exactly zero
    n_phi = torch.as_tensor(p.grid.n_phi)
    pad = torch.arange(p.grid.max_n_phi)[None, :] >= n_phi[:, None]
    assert bool((maps[..., pad, :] == 0).all())


@pytest.mark.parametrize("spin", [False, True])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_fused_bucket_dot_identities(variant, spin):
    """<A x, y> = <x, A^T y> through autograd on both bucket pairs (the
    backward runs the other direction's chain)."""
    c = bucket_case(4, 2, spin, seed=7)
    args, kw = port_args(c), port_kw(c, variant)
    g = c["g"]
    rng = np.random.default_rng(8)
    a = torch.as_tensor(c["a"]).requires_grad_(True)
    y = torch.as_tensor(rng.normal(size=c["maps"].shape).astype(np.float32))
    out = fused.fused_synth_bucket(a, *args, **kw)
    (out * y).sum().backward()
    lhs = float((out * y).sum().detach())
    rhs = float((a.detach() * a.grad).sum())
    assert abs(lhs - rhs) / abs(lhs) < DOT_TOL
    maps = torch.as_tensor(c["maps"]).requires_grad_(True)
    b = torch.as_tensor(rng.normal(size=c["a"].shape).astype(np.float32))
    out = fused.fused_anal_bucket(maps, g.weights, *args, **kw)
    (out * b).sum().backward()
    lhs = float((out * b).sum().detach())
    rhs = float((maps.detach() * maps.grad).sum())
    assert abs(lhs - rhs) / abs(lhs) < DOT_TOL


@pytest.mark.parametrize("spin", [0, 2])
def test_bucket_plan_dot_identity(spin):
    """The plan-level identity on a HEALPix plan, alm2map against its
    autograd transpose (complex alm as re, im pairs)."""
    p = repro_torch.make_plan("healpix", nside=4, K=1, dtype="float32",
                              spin=spin, device="cpu")
    rng = np.random.default_rng(9 + spin)
    shp = p._alm_shape
    keep = np.arange(p.l_max + 1)[None, :] >= np.maximum(
        np.arange(p.m_max + 1), spin)[:, None]
    a = (rng.normal(size=shp) + 1j * rng.normal(size=shp)) * keep[..., None]
    a[..., 0, :, :] = a[..., 0, :, :].real
    x = torch.as_tensor(a.astype(np.complex64)).requires_grad_(True)
    y = torch.as_tensor(rng.normal(size=p._maps_shape).astype(np.float32))
    out = p.alm2map(x)
    (out * y).sum().backward()
    lhs = float((out * y).sum().detach())
    rhs = float((x.detach().real * x.grad.real
                 + x.detach().imag * x.grad.imag).sum())
    assert abs(lhs - rhs) / abs(lhs) < DOT_TOL


@pytest.mark.parametrize("spin", [0, 2])
def test_fused_bucket_plan_gives_the_same_bits_twice(spin):
    """Two calls of a fused HEALPix plan, both directions, are bit-equal:
    the alias fold sums fixed gathers, whatever order work runs in."""
    p = repro_torch.make_plan("healpix", nside=8, K=2, dtype="float32",
                              mode="cuda_mxu", spin=spin, device="cpu")
    rng = np.random.default_rng(11)
    shp = p._alm_shape
    a = torch.as_tensor((rng.normal(size=shp) + 1j * rng.normal(size=shp))
                        .astype(np.complex64))
    m1, m2 = p.alm2map(a), p.alm2map(a)
    assert torch.equal(m1, m2)
    assert torch.equal(p.map2alm(m1), p.map2alm(m2))


def test_bucket_chain_refuses_a_foreign_index():
    c = bucket_case(2, 1, False)
    other = phase.bucket_index(np.arange(3), c["bucket"].n_phi,
                               c["bucket"].layout, c["bucket"].width)
    with pytest.raises(ValueError, match="other m rows"):
        fused.fused_synth_bucket(torch.as_tensor(c["a"]), *port_args(c),
                                 **dict(port_kw(c, "vpu"), bucket=other))
