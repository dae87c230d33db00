"""Gradients of the port's spin-2 plans on the CPU: the adjoint pairs of the
Wigner-general layer, the spin seam and the fused spin chains, through
``Plan.alm2map`` / ``map2alm`` on every backend and layout.

Bands, as the reference's (tests/test_adjoint.py): the plan-level dot
identity <A x, y> = <x, A^T y> within 1e-11 in float64 and 2e-3 in float32;
float64 gradients against ``jax.grad`` of the reference's jnp spin-2 plan
within 1e-10 x max, the port's gradients conjugated first (PyTorch's
complex gradient is the conjugate of ``jax.grad``'s).  The fused spin
adjoints carry the pair packing's factor (1/2 on the synthesis backward,
2 on the analysis backward): a missing factor shows as a gap of exactly 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import sht as rsht

import repro_torch
from repro_torch.kernels import ref as kref

KERNEL_PLANS = [(v, lay) for v in ("vpu", "mxu")
                for lay in ("plain", "packed", "fused")]


def rand_eb(l_max, K, seed, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    shape = (2, l_max + 1, l_max + 1, K)
    a = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    a[:, 0] = a[:, 0].real
    return torch.as_tensor((a * rsht.alm_mask(l_max, l_max, spin=2)
                            [None, ..., None]).astype(dtype))


def rand_maps(plan, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=plan._maps_shape).astype(
        np.float64 if plan.dtype == "float64" else np.float32))


def identity_err(plan, seed):
    """Both directions through torch.autograd: <A x, y> against <x, grad>,
    the larger relative gap."""
    cdt = np.complex128 if plan.dtype == "float64" else np.complex64
    errs = []
    a = rand_eb(plan.l_max, plan.K, seed, cdt).requires_grad_(True)
    t = rand_maps(plan, seed + 1)
    lhs = (plan.alm2map(a) * t).sum()
    (g,) = torch.autograd.grad(lhs, a)
    a = a.detach()
    errs.append((lhs.item(), float((a.real * g.real + a.imag * g.imag).sum())))
    maps = rand_maps(plan, seed + 2).requires_grad_(True)
    b = rand_eb(plan.l_max, plan.K, seed + 3, cdt)
    out = plan.map2alm(maps)
    lhs = (out.real * b.real + out.imag * b.imag).sum()
    (g,) = torch.autograd.grad(lhs, maps)
    errs.append((lhs.item(), float((maps.detach() * g).sum())))
    return max(abs(p - q) / max(abs(p), abs(q), 1e-30) for p, q in errs)


@pytest.mark.parametrize("l_max,K", [(6, 1), (11, 2)])
def test_spin_dot_identity_torch_f64(l_max, K):
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float64", spin=2,
                                 device="cpu")
    assert plan.grad_ready == {"synth": True, "anal": True}
    assert identity_err(plan, 3 + l_max) < 1e-11


@pytest.mark.parametrize("variant,layout", KERNEL_PLANS)
def test_spin_dot_identity_kernel_plans_f32(variant, layout):
    plan = repro_torch.make_plan("gl", 12, K=2, dtype="float32",
                                 mode=f"cuda_{variant}", layout=layout,
                                 spin=2, device="cpu")
    assert plan.layouts["synth"] == layout
    assert identity_err(plan, 7) < 2e-3


def test_spin_gradients_match_jax_grad_f64():
    """Port float64 spin gradients (conjugated) against jax.grad of the
    reference's jnp spin-2 plan, both directions, within 1e-10 x max."""
    l_max, K = 9, 2
    a0 = rand_eb(l_max, K, 1)
    ref = repro.make_plan("gl", l_max, K=K, dtype="float64", mode="jnp",
                          spin=2)
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float64", spin=2,
                                 device="cpu")
    t = rand_maps(plan, 2)
    want = jax.grad(lambda a: jnp.sum(ref.alm2map(a) * jnp.asarray(t)))(
        jnp.asarray(a0.numpy()))
    a = a0.clone().requires_grad_(True)
    (plan.alm2map(a) * t).sum().backward()
    got = a.grad.conj().resolve_conj().numpy()
    assert np.max(np.abs(got - want)) < 1e-10 * np.max(np.abs(want))
    maps0 = plan.alm2map(a0).detach()
    want = jax.grad(lambda m: jnp.sum(jnp.abs(ref.map2alm(m)) ** 2))(
        jnp.asarray(maps0.numpy()))
    maps = maps0.clone().requires_grad_(True)
    plan.map2alm(maps).abs().pow(2).sum().backward()
    assert np.max(np.abs(maps.grad.numpy() - want)) \
        < 1e-10 * np.max(np.abs(want))


@pytest.mark.parametrize("layout", ["plain", "packed", "fused"])
def test_spin_kernel_gradients_match_torch_plan(layout):
    """A float32 kernel plan's spin gradients against the float64 torch
    plan's, both directions (a dropped pair factor would give 2x)."""
    l_max, K = 10, 1
    a0 = rand_eb(l_max, K, 4)
    p64 = repro_torch.make_plan("gl", l_max, K=K, dtype="float64", spin=2,
                                device="cpu")
    p32 = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                                mode="cuda_vpu", layout=layout, spin=2,
                                device="cpu")
    t = rand_maps(p64, 5)
    grads = []
    for plan, a in ((p64, a0), (p32, a0.to(torch.complex64))):
        a = a.clone().requires_grad_(True)
        (plan.alm2map(a) * t.to(plan.alm2map(a).dtype)).sum().backward()
        grads.append(a.grad.to(torch.complex128))
    err = float((grads[1] - grads[0]).abs().max() / grads[0].abs().max())
    assert err < 1e-4
    grads = []
    for plan in (p64, p32):
        maps = t.to(torch.float32 if plan is p32 else torch.float64)
        maps = maps.clone().requires_grad_(True)
        out = plan.map2alm(maps)
        (out.real.sum() + out.imag.sum()).backward()
        grads.append(maps.grad.to(torch.float64))
    err = float((grads[1] - grads[0]).abs().max() / grads[0].abs().max())
    assert err < 1e-4


def test_spin_backward_runs_the_other_direction_of_the_same_layout(
        monkeypatch):
    """The backward of a spin synthesis runs the spin analysis of the same
    layout (and the reverse), counted on the plain versions, which stand in
    for the kernels on the CPU; every call is the spin branch."""
    calls = []
    for name in ("synth_packed_ref", "anal_packed_ref", "synth_fused_ref",
                 "anal_fused_ref", "synth_ref", "anal_ref"):
        fn = getattr(kref, name)
        monkeypatch.setattr(kref, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append((_n, k.get("spin", k.get("mp_vals") is not None))),
            _f(*a, **k))[1])
    for layout, stem in (("plain", ""), ("packed", "_packed"),
                         ("fused", "_fused")):
        plan = repro_torch.make_plan("gl", 6, K=1, dtype="float32",
                                     layout=layout, spin=2, device="cpu")
        a = rand_eb(6, 1, 0, np.complex64).requires_grad_(True)
        out = plan.alm2map(a)
        calls.clear()
        out.sum().backward()
        assert calls[0] == (f"anal{stem}_ref", True)
        assert all(spin and c.startswith("anal_") for c, spin in calls)
        maps = rand_maps(plan, 1).requires_grad_(True)
        out = plan.map2alm(maps)
        calls.clear()
        out.abs().sum().backward()
        assert calls[0] == (f"synth{stem}_ref", True)
        assert all(spin and c.startswith("synth_") for c, spin in calls)
