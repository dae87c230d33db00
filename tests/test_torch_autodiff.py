"""Gradients of the port on the CPU: the adjoint pairs of every layer
(``core.autodiff.linear_pair``) through ``Plan.alm2map`` / ``map2alm`` on
every backend and layout, against the reference's bands in
tests/test_adjoint.py and against ``jax.grad`` of the reference plan.

Bands, as the reference's: the plan-level dot identity <A x, y> =
<x, A^T y> within 1e-11 in float64 and 2e-3 in float32 (the float32
transforms round at 1e-6 per sum, and the identity compares two
independently rounded transforms); the kernel-level transpose within 2e-4.
Gradients against ``jax.grad`` within 1e-10 in float64 (the same math,
rounded by two frameworks).  For a real loss of a complex input PyTorch
returns the conjugate of what ``jax.grad`` returns (d/dRe + i d/dIm
against d/dRe - i d/dIm), so the port's gradients are conjugated before
the comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

import repro
from repro.core import grids as rgrids
from repro.core import legendre as rleg
from repro.core import sht as rsht
from repro.core import spectra as rspectra

import repro_torch
from repro_torch.core import legendre, spectra
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

KERNEL_PLANS = [(v, lay) for v in ("vpu", "mxu")
                for lay in ("plain", "packed", "fused")]


def rand_alm(l_max, K, seed, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    shape = (l_max + 1, l_max + 1, K)
    alm = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    alm[0] = alm[0].real
    return torch.as_tensor((alm * rsht.alm_mask(l_max, l_max)[..., None])
                           .astype(dtype))


def rand_maps(plan, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=plan._maps_shape).astype(
        np.float64 if plan.dtype == "float64" else np.float32))


def real_dot(u, v) -> float:
    """The real inner product <u, v> = sum Re(u) Re(v) + Im(u) Im(v)."""
    if u.is_complex():
        return float((u.real * v.real + u.imag * v.imag).sum())
    return float((u * v).sum())


def autograd_identity_err(plan, seed):
    """Both directions of the plan through torch.autograd: the gradient of
    <A x, y> in x is A^T y, so <A x, y> and <x, grad> agree."""
    cdt = np.complex128 if plan.dtype == "float64" else np.complex64
    errs = []
    a = rand_alm(plan.l_max, plan.K, seed, cdt).requires_grad_(True)
    t = rand_maps(plan, seed + 1)
    lhs = (plan.alm2map(a) * t).sum()
    (g,) = torch.autograd.grad(lhs, a)
    errs.append((lhs.item(), real_dot(a.detach(), g)))
    maps = rand_maps(plan, seed + 2).requires_grad_(True)
    b = rand_alm(plan.l_max, plan.K, seed + 3, cdt)
    out = plan.map2alm(maps)
    lhs = (out.real * b.real + out.imag * b.imag).sum()
    (g,) = torch.autograd.grad(lhs, maps)
    errs.append((float(lhs), real_dot(maps.detach(), g)))
    return max(abs(p - q) / max(abs(p), abs(q), 1e-30) for p, q in errs)


def plan_identity_err(plan, seed):
    """The reference's plan-level identity without autograd:
    <alm2map(a), t> = sum fac_m Re(a conj(map2alm(t / w)))."""
    cdt = np.complex128 if plan.dtype == "float64" else np.complex64
    a = rand_alm(plan.l_max, plan.K, seed, cdt)
    t = rand_maps(plan, seed + 1)
    w = torch.as_tensor(plan.grid.weights, dtype=t.dtype)[:, None, None]
    lhs = float((plan.alm2map(a) * t).sum())
    ahat = plan.map2alm(t / w)
    fac = torch.where(torch.arange(plan.m_max + 1) == 0, 1.0, 2.0)
    rhs = float((fac[:, None, None] * (a * ahat.conj()).real).sum())
    return abs(lhs - rhs) / max(abs(lhs), abs(rhs), 1e-30)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("l_max,K", [(6, 1), (11, 2)])
def test_dot_identity_torch_f64(l_max, K, fold):
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float64",
                                 fold=fold, device="cpu")
    assert autograd_identity_err(plan, l_max) < 1e-11
    assert plan_identity_err(plan, l_max) < 1e-11


@pytest.mark.parametrize("variant,layout", KERNEL_PLANS)
def test_dot_identity_kernel_plans_f32(variant, layout):
    plan = repro_torch.make_plan("gl", 8, K=2, dtype="float32",
                                 mode=f"cuda_{variant}", layout=layout,
                                 device="cpu")
    assert plan.layouts == {"synth": layout, "anal": layout}
    assert autograd_identity_err(plan, 3) < 2e-3
    assert plan_identity_err(plan, 3) < 2e-3


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("layout", ["plain", "packed"])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_kernel_transpose(variant, layout, fold):
    """<synth(a), y> = <a, anal(y)> at the ops seam, and the gradient of
    the first is exactly anal(y) (the backward is the analysis)."""
    l_max = 8
    g = rgrids.make_grid("gl", l_max=l_max)
    nh = (g.n_rings + 1) // 2
    x = (g.cos_theta[:nh] if fold else g.cos_theta).astype(np.float32)
    sin = g.sin_theta[:nh] if fold else g.sin_theta
    m_vals = np.arange(l_max + 1)
    pmm, pms = kref.prepare_seeds(m_vals, sin, rleg.log_mu(l_max))
    rng = np.random.default_rng(int(fold))
    a = torch.as_tensor(rng.normal(size=(l_max + 1, l_max + 1, 2)),
                        dtype=torch.float32).requires_grad_(True)
    y = torch.as_tensor(rng.normal(size=(l_max + 1, 2 if fold else 1,
                                         len(x), 2)), dtype=torch.float32)
    kw = dict(l_max=l_max, fold=fold, variant=variant, layout=layout)
    lhs = (ops.synth(a, m_vals, x, pmm, pms, **kw) * y).sum()
    ay = ops.anal(y, m_vals, x, pmm, pms, **kw)
    rhs = float((ay * a.detach()).sum())
    assert abs(float(lhs) - rhs) <= 2e-4 * max(abs(float(lhs)), abs(rhs))
    (grad,) = torch.autograd.grad(lhs, a)
    assert torch.equal(grad, ay)


def test_gradients_match_jax_grad_f64():
    """Port float64 gradients (conjugated) against jax.grad of the
    reference's jnp plan, both directions, within 1e-10 x max."""
    l_max, K = 9, 2
    a0 = rand_alm(l_max, K, 1)
    ref = repro.make_plan("gl", l_max, K=K, dtype="float64", mode="jnp")
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float64",
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


def test_gradcheck_through_jacobi_iters():
    """map2alm(iters=1) stays differentiable: finite differences in float64
    (torch.autograd.gradcheck) on the torch plan."""
    plan = repro_torch.make_plan("gl", 4, K=1, dtype="float64", fold=True,
                                 device="cpu")
    maps = rand_maps(plan, 0).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda m: plan.map2alm(m, iters=1),
                                    (maps,))


@pytest.mark.parametrize("variant,layout", KERNEL_PLANS)
def test_directional_gradients_kernel_plans_f32(variant, layout):
    """The reference's float32 gradcheck (rtol 1e-3): the directional
    derivative of each direction's loss against a central difference."""
    plan = repro_torch.make_plan("gl", 8, K=1, dtype="float32",
                                 mode=f"cuda_{variant}", layout=layout,
                                 device="cpu")
    a0 = rand_alm(8, 1, 7, np.complex64)
    v = rand_alm(8, 1, 9, np.complex64)
    t = rand_maps(plan, 8)
    a = a0.clone().requires_grad_(True)
    (plan.alm2map(a) * t).sum().backward()
    eps = 1e-2
    fd = float(((plan.alm2map(a0 + eps * v) - plan.alm2map(a0 - eps * v))
                * t).sum()) / (2 * eps)
    assert abs(real_dot(v, a.grad) - fd) <= 1e-3 * max(abs(fd), 1.0)
    maps0 = plan.alm2map(a0).detach()
    vm = rand_maps(plan, 11)
    maps = maps0.clone().requires_grad_(True)

    def loss(m):
        return plan.map2alm(m, iters=1).abs().pow(2).sum()

    loss(maps).backward()
    fd = float(loss(maps0 + eps * vm) - loss(maps0 - eps * vm)) / (2 * eps)
    assert abs(float((maps.grad * vm).sum()) - fd) <= 1e-3 * max(abs(fd), 1.0)


@pytest.mark.parametrize("mode,layout", [("torch", None),
                                         ("cuda_vpu", "packed"),
                                         ("cuda_mxu", "fused")])
def test_jvp_is_the_forward_map(mode, layout):
    """Forward mode: the tangent of alm2map is alm2map of the tangent."""
    dtype = "float64" if mode == "torch" else "float32"
    cdt = np.complex128 if mode == "torch" else np.complex64
    plan = repro_torch.make_plan("gl", 10, K=1, dtype=dtype, mode=mode,
                                 layout=layout, device="cpu")
    a, v = rand_alm(10, 1, 0, cdt), rand_alm(10, 1, 1, cdt)
    with forward_ad.dual_level():
        out = plan.alm2map(forward_ad.make_dual(a, v))
        tangent = forward_ad.unpack_dual(out).tangent
    want = plan.alm2map(v)
    tol = 1e-12 if mode == "torch" else 1e-6
    assert float((tangent - want).abs().max()) <= tol * float(
        want.abs().max())


def test_residual_gradients_raise_not_silently_zero():
    """d/d(weights) is undefined under the adjoint rules: asking for it
    raises, naming the residual, instead of returning a zero gradient."""
    g = rgrids.make_grid("gl", l_max=6)
    rng = np.random.default_rng(0)
    d = torch.as_tensor(rng.normal(size=(7, g.n_rings, 1)))
    w = torch.as_tensor(g.weights).requires_grad_(True)
    with pytest.raises(ValueError, match="residual 'weights'"):
        legendre.alm_from_delta(d, torch.zeros_like(d), np.arange(7),
                                g.cos_theta, g.sin_theta, w,
                                legendre.log_mu(6), l_max=6)
    x = torch.as_tensor(g.cos_theta, dtype=torch.float32).requires_grad_(True)
    pmm, pms = kref.prepare_seeds(np.arange(7), g.sin_theta,
                                  legendre.log_mu(6))
    with pytest.raises(ValueError, match="residual 'x'"):
        ops.synth(torch.zeros(7, 7, 2), np.arange(7), x, pmm, pms, l_max=6)


def test_grad_ready_surface():
    for kw in (dict(dtype="float64"), dict(dtype="float32", layout="packed")):
        plan = repro_torch.make_plan("gl", 8, device="cpu", **kw)
        assert plan.grad_ready == {"synth": True, "anal": True}
        d = plan.describe()["differentiable"]
        assert d["synth"] and d["anal"] and d["higher_order"] is False


def test_backward_runs_the_other_direction_of_the_same_layout(monkeypatch):
    """The backward of a packed (fused) synthesis runs the packed (fused)
    analysis once, and the reverse: counted on the plain versions, which
    stand in for the kernels on the CPU."""
    calls = []
    for name in ("synth_packed_ref", "anal_packed_ref", "synth_fused_ref",
                 "anal_fused_ref", "synth_ref", "anal_ref"):
        fn = getattr(kref, name)
        monkeypatch.setattr(kref, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    for layout in ("packed", "fused"):
        plan = repro_torch.make_plan("gl", 6, K=1, dtype="float32",
                                     layout=layout, device="cpu")
        a = rand_alm(6, 1, 0, np.complex64).requires_grad_(True)
        out = plan.alm2map(a)
        calls.clear()
        out.sum().backward()
        # (the fused plain versions run the packed ones inside)
        assert calls[0] == f"anal_{layout}_ref"
        assert all(c.startswith("anal_") and c != "anal_ref" for c in calls)
        maps = rand_maps(plan, 1).requires_grad_(True)
        out = plan.map2alm(maps)
        calls.clear()
        out.abs().sum().backward()
        assert calls[0] == f"synth_{layout}_ref"
        assert all(c.startswith("synth_") and c != "synth_ref"
                   for c in calls)


def test_grad_through_power_spectrum_loss():
    """The motivating workload: the gradient of a C_l-space loss through
    map2alm(alm2map(a)), and cl_from_alm against the reference's."""
    plan = repro_torch.make_plan("gl", 8, K=1, dtype="float64", device="cpu")
    a0 = rand_alm(8, 1, 5)
    target = spectra.cl_from_alm(a0)
    np.testing.assert_allclose(target.numpy(), np.asarray(
        rspectra.cl_from_alm(jnp.asarray(a0.numpy()))), rtol=1e-13)
    a = (0.5 * a0).requires_grad_(True)
    cl = spectra.cl_from_alm(plan.map2alm(plan.alm2map(a)))
    ((cl - target) ** 2).sum().backward()
    assert bool(torch.isfinite(torch.view_as_real(a.grad)).all())
    assert float(a.grad.abs().max()) > 0.0
