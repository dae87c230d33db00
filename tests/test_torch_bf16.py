"""The bfloat16 branch of the fused mxu kernels (kernels 10 and 12) on the
CPU, through their plain versions (``kernels.ref``'s ``bf16=True``),
reached as in the reference through ``Plan._make_fused_synth`` /
``_make_fused_anal(variant, bf16=True)``.

* The reference's gate (tests/test_fused.py): 0 < err < 1e-2 against
  ``bf16=False``, both directions; err > 0 catches a path that quietly
  stays in float32.
* Against the reference's bf16 plan in Pallas interpret mode at l_max <=
  24 within 4e-3 x max|ref|, one bfloat16 ulp (2^-8): the two frameworks'
  float32 inputs to the rounding differ in the last bits (ROADMAP ground
  rules), so an input on a rounding boundary can round to neighbouring
  bfloat16 values.  Measured: 4.3e-8 to 2.0e-7 on most cases, 1.55e-3 on
  the GL l_max 24 spin-2 analysis, whose float32 inputs perturbed by 1e-6
  move the port's own bf16 output by up to the same 1.55e-3.
* The vpu variant has no bfloat16 contraction: the reference ignores
  ``bf16`` there and runs float32; the port raises (ROADMAP check A).
* ``bf16=False`` keeps every float32 bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro

import repro_torch
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

GATE = 1e-2
REF_TOL = 4e-3


def rel(got, want) -> float:
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def plan_alm(p, seed=1):
    rng = np.random.default_rng(seed)
    shp = p._alm_shape
    keep = np.arange(p.l_max + 1)[None, :] >= np.maximum(
        np.arange(p.m_max + 1), p.spin)[:, None]
    a = (rng.uniform(-1, 1, shp) + 1j * rng.uniform(-1, 1, shp)) \
        * keep[..., None]
    return a.astype(np.complex64)


PLANS = [("gl", dict(l_max=24)), ("gl", dict(l_max=17)),
         ("healpix", dict(nside=4)), ("ecp", dict(l_max=12))]


@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("kind,kw", PLANS)
def test_bf16_error_band(kind, kw, spin):
    p = repro_torch.make_plan(kind, **kw, K=2, dtype="float32",
                              mode="cuda_mxu", spin=spin, device="cpu")
    a = torch.as_tensor(plan_alm(p))
    m32 = p._make_fused_synth("mxu", bf16=False)(a)
    m16 = p._make_fused_synth("mxu", bf16=True)(a)
    assert 0.0 < rel(m16, m32) < GATE
    a32 = p._make_fused_anal("mxu", bf16=False)(m32)
    a16 = p._make_fused_anal("mxu", bf16=True)(m32)
    assert 0.0 < rel(a16, a32) < GATE


@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("kind,kw", [("gl", dict(l_max=24)),
                                     ("gl", dict(l_max=17)),
                                     ("healpix", dict(nside=4))])
def test_bf16_matches_reference_bf16_plan(kind, kw, spin):
    rp = repro.make_plan(kind, **kw, K=2, dtype="float32",
                         mode="pallas_mxu", spin=spin)
    p = repro_torch.make_plan(kind, **kw, K=2, dtype="float32",
                              mode="cuda_mxu", spin=spin, device="cpu")
    a = plan_alm(p)
    want_s = rp._make_fused_synth("mxu", bf16=True)(jnp.asarray(a))
    got_s = p._make_fused_synth("mxu", bf16=True)(torch.as_tensor(a))
    assert rel(got_s, want_s) < REF_TOL
    maps = np.asarray(rp._make_fused_synth("mxu")(jnp.asarray(a)))
    want_a = rp._make_fused_anal("mxu", bf16=True)(jnp.asarray(maps))
    got_a = p._make_fused_anal("mxu", bf16=True)(torch.as_tensor(maps))
    assert rel(got_a, want_a) < REF_TOL


def test_vpu_variant_has_no_bf16_contraction():
    """Check A: the reference runs float32 for (vpu, bf16=True); the port
    substitutes nothing silently and raises, naming the reason."""
    p = repro_torch.make_plan("gl", 12, K=1, dtype="float32", device="cpu")
    a = torch.as_tensor(plan_alm(p))
    for make, arg in ((p._make_fused_synth, a),
                      (p._make_fused_anal, p.alm2map(a))):
        with pytest.raises(ValueError, match="vpu variant has no bfloat16 "
                                             "contraction"):
            make("vpu", bf16=True)(arg)


def test_bf16_plain_versions_round_before_an_exact_product():
    """The plain bf16 synthesis equals a float32 contraction of the
    bfloat16-rounded coefficients and recurrence values; products of two
    bfloat16 values are exact in float32."""
    x = torch.rand(10000) * 2 - 1
    y = torch.rand(10000) * 2 - 1
    xb, yb = kref._bf16(x), kref._bf16(y)
    assert torch.equal(xb.double() * yb.double(), (xb * yb).double())
    assert not torch.equal(xb, x)


@pytest.mark.parametrize("fold,spin", [(False, 0), (True, 0), (False, 2)])
def test_bf16_false_keeps_every_float32_bit(fold, spin):
    """bf16=False is the float32 path bit for bit: the plan's default, the
    explicit keyword, and the plain versions composed as before the option
    existed (packed sums, fold combine, rotation)."""
    p = repro_torch.make_plan("gl", 15, K=2, dtype="float32",
                              mode="cuda_mxu", spin=spin, fold=fold,
                              device="cpu")
    a = torch.as_tensor(plan_alm(p))
    m = p.alm2map(a)
    assert torch.equal(m, p._make_fused_synth("mxu", bf16=False)(a))
    assert torch.equal(p.map2alm(m), p._make_fused_anal("mxu")(m))
    lo = p._fused_layout()
    maps, x, pmm_pk, pms_pk = ops._prep(lo, *p._row_seeds()[1:4])
    gen = torch.Generator().manual_seed(3)
    K2, P = 4, 2 if fold else 1
    a_pk = torch.rand((lo.n_slots, lo.S, K2), generator=gen)
    tab = torch.rand((lo.n_slots, 2, P, 4, x.shape[0]), generator=gen)
    f = torch.rand((lo.n_slots, 2, P, x.shape[0], K2), generator=gen)
    kw = dict(l_max=p.l_max, spin=bool(spin))
    got = kref.synth_fused_ref(a_pk, maps, x, pmm_pk, pms_pk, tab, fold=fold,
                               bf16=False, **kw)
    acc = kref.synth_packed_ref(a_pk, maps, x, pmm_pk, pms_pk, fold=fold,
                                **kw).reshape(lo.n_slots, 2, P, -1, K2)
    if fold:
        acc = torch.stack([acc[:, :, 0] + acc[:, :, 1],
                           acc[:, :, 0] - acc[:, :, 1]], dim=2)
    re, im = kref._rotate(tab, acc[..., :2], acc[..., 2:])
    assert torch.equal(got, torch.cat([re, im], dim=-1))
    got = kref.anal_fused_ref(f, maps, x, pmm_pk, pms_pk, tab, s_len=lo.S,
                              bf16=False, **kw)
    re, im = kref._rotate(tab, f[..., :2], f[..., 2:])
    fr = torch.cat([re, im], dim=-1)
    if fold:
        fr = torch.stack([fr[:, :, 0] + fr[:, :, 1],
                          fr[:, :, 0] - fr[:, :, 1]], dim=2)
    want = kref.anal_packed_ref(fr.reshape(lo.n_slots, 2 * P, -1, K2), maps,
                                x, pmm_pk, pms_pk, s_len=lo.S, **kw)
    assert torch.equal(got, want)


def test_bf16_reaches_the_bucket_chains():
    """bf16 threads through the fused bucket chains (HEALPix) and through
    their gradients: the backward of a bf16 synthesis runs the bf16
    analysis chain."""
    p = repro_torch.make_plan("healpix", nside=4, K=1, dtype="float32",
                              mode="cuda_mxu", device="cpu")
    a = torch.as_tensor(plan_alm(p))
    s16 = p._make_fused_synth("mxu", bf16=True)
    s32 = p._make_fused_synth("mxu", bf16=False)
    assert 0.0 < rel(s16(a), s32(a)) < GATE
    x = a.clone().requires_grad_(True)
    s16(x).sum().backward()
    g16 = x.grad.clone()
    x.grad = None
    s32(x).sum().backward()
    assert 0.0 < rel(g16, x.grad) < GATE
