"""The port's Legendre seam (``kernels.ops``) on CPU tensors -- the plain
versions of the CUDA kernels -- against the JAX reference's schedule
oracles ``repro.kernels.ref.synth_ref`` / ``anal_ref``.

Tolerance 5e-5 x max|ref|: both run the same float32 scaled recurrence,
but the port computes beta with a correctly rounded 1/sqrt and XLA with
its rsqrt, and the recurrence amplifies such last-bit differences (the
measured gap at l_max 64 is 3.5e-6 to 5.3e-6 of max|ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables float64 in the reference)
from repro.core import grids as rgrids
from repro.core import legendre as rleg
from repro.kernels import ref as rref

from repro_torch.core import legendre
from repro_torch.kernels import legendre_cuda, ops
from repro_torch.kernels import ref as kref

TOL = 5e-5


def case(l_max, K, fold, m_vals=None, seed=0):
    """Seeded numpy inputs of one (l_max, K, fold) case, for both packages."""
    g = rgrids.make_grid("gl", l_max=l_max)
    nh = (g.n_rings + 1) // 2
    x = (g.cos_theta[:nh] if fold else g.cos_theta).astype(np.float32)
    sin = g.sin_theta[:nh] if fold else g.sin_theta
    m_vals = np.arange(l_max + 1) if m_vals is None else np.asarray(m_vals)
    pmm, pms = kref.prepare_seeds(m_vals, sin, rleg.log_mu(l_max))
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (len(m_vals), l_max + 1, 2 * K)).astype(np.float32)
    a *= (np.arange(l_max + 1)[None, :] >= m_vals[:, None])[..., None]
    dw = rng.uniform(-1, 1, (len(m_vals), 2 if fold else 1, len(x), 2 * K)
                     ).astype(np.float32)
    return m_vals, x, pmm, pms, a, dw


def rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)))


def port_synth(m_vals, x, pmm, pms, a, l_max, fold, variant="vpu"):
    return ops.synth(torch.as_tensor(a), m_vals, x, pmm, pms, l_max=l_max,
                     fold=fold, variant=variant)


def port_anal(m_vals, x, pmm, pms, dw, l_max, fold, variant="vpu"):
    return ops.anal(torch.as_tensor(dw), m_vals, x, pmm, pms, l_max=l_max,
                    fold=fold, variant=variant)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("l_max", [24, 40, 64])
def test_synth_and_anal_match_reference(l_max, K, fold):
    m_vals, x, pmm, pms, a, dw = case(l_max, K, fold, seed=l_max + K)
    want = rref.synth_ref(jnp.asarray(a), m_vals, jnp.asarray(x),
                          jnp.asarray(pmm), jnp.asarray(pms), l_max=l_max,
                          fold=fold)
    got = port_synth(m_vals, x, pmm, pms, a, l_max, fold)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel(got, want) < TOL
    want = rref.anal_ref(jnp.asarray(dw), m_vals, jnp.asarray(x),
                         jnp.asarray(pmm), jnp.asarray(pms), l_max=l_max,
                         l1p=l_max + 1, fold=fold)
    got = port_anal(m_vals, x, pmm, pms, dw, l_max, fold)
    assert got.shape == want.shape
    assert rel(got, want) < TOL


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_plan_padding_rows_are_exact_zeros(variant):
    """-1 m rows (plan padding) give exactly zero, as the reference pins in
    test_kernel_handles_plan_padding."""
    l_max = 20
    m_vals = np.array([0, 5, -1, 17, -1])
    m_vals, x, pmm, pms, a, dw = case(l_max, 1, False, m_vals=m_vals)
    got = port_synth(m_vals, x, pmm, pms, a, l_max, False, variant)
    want = rref.synth_ref(jnp.asarray(a), m_vals, jnp.asarray(x),
                          jnp.asarray(pmm), jnp.asarray(pms), l_max=l_max)
    assert torch.all(got[2] == 0) and torch.all(got[4] == 0)
    assert torch.any(got[1] != 0)
    assert rel(got, want) < TOL
    got = port_anal(m_vals, x, pmm, pms, dw, l_max, False, variant)
    assert torch.all(got[2] == 0) and torch.all(got[4] == 0)
    want = rref.anal_ref(jnp.asarray(dw), m_vals, jnp.asarray(x),
                         jnp.asarray(pmm), jnp.asarray(pms), l_max=l_max,
                         l1p=l_max + 1)
    assert rel(got, want) < TOL


def test_high_m_rescaling_matches_reference_and_truth():
    """m = 250 seeds underflow float32 at polar rings: the rescaled
    recurrence must recover the representable values (the reference's
    test_kernel_f32_rescaling_high_m)."""
    l_max = 300
    m_vals = np.array([250])
    m_vals, x, pmm, pms, a, dw = case(l_max, 1, False, m_vals=m_vals)
    assert int(pms.min()) < 0                       # scaling engaged
    a = np.zeros_like(a)
    a[0, l_max, 0] = 1.0
    got = port_synth(m_vals, x, pmm, pms, a, l_max, False)[0, 0, :, 0]
    want = np.asarray(rref.synth_ref(
        jnp.asarray(a), m_vals, jnp.asarray(x), jnp.asarray(pmm),
        jnp.asarray(pms), l_max=l_max))[0, 0, :, 0]
    assert torch.all(torch.isfinite(got))
    assert rel(got, want) < TOL
    g = rgrids.make_grid("gl", l_max=l_max)
    truth, _ = legendre.delta_from_alm(
        torch.as_tensor(a[:, :, :1], dtype=torch.float64),
        torch.zeros(1, l_max + 1, 1, dtype=torch.float64), m_vals,
        g.cos_theta, g.sin_theta, rleg.log_mu(l_max), l_max=l_max)
    assert rel(got.double(), truth[0, :, 0]) < 5e-4
    gota = port_anal(m_vals, x, pmm, pms, dw, l_max, False)
    wanta = rref.anal_ref(jnp.asarray(dw), m_vals, jnp.asarray(x),
                          jnp.asarray(pmm), jnp.asarray(pms), l_max=l_max,
                          l1p=l_max + 1)
    assert rel(gota, wanta) < TOL


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_anal_fold_equals_unfold(variant):
    """Folded analysis of mirror-combined rows equals the unfolded one (the
    reference's test_anal_fold_vs_unfold)."""
    l_max, K = 32, 1
    g = rgrids.make_grid("gl", l_max=l_max)
    m_vals, x, pmm, pms, _, dw = case(l_max, K, False)
    got_u = port_anal(m_vals, x, pmm, pms, dw, l_max, False, variant)
    R, nh = g.n_rings, (g.n_rings + 1) // 2
    n_part = dw[:, 0, :nh]
    s_part = np.zeros_like(n_part)
    s_part[:, :R - nh] = dw[:, 0, nh:][:, ::-1]
    dw_f = np.stack([n_part + s_part, n_part - s_part], axis=1)
    m_vals, x_n, pmm_n, pms_n, _, _ = case(l_max, K, True)
    got_f = port_anal(m_vals, x_n, pmm_n, pms_n, dw_f, l_max, True, variant)
    assert float((got_u - got_f).abs().max()) < 2e-4 * max(
        1.0, float(got_u.abs().max()))


def test_anal_reduce_plain_version():
    rng = np.random.default_rng(4)
    part = torch.as_tensor(rng.normal(size=(4, 3, 6, 2)).astype(np.float32))
    m_vals = torch.tensor([0, 2, -1, 5], dtype=torch.int32)
    out = kref.anal_reduce_ref(part, m_vals, l_max=5)
    want = part.sum(dim=1)
    for i, m in enumerate((0, 2, -1, 5)):
        for l in range(6):
            if m >= 0 and l >= m:
                assert torch.equal(out[i, l], want[i, l])
            else:
                assert torch.all(out[i, l] == 0)


@pytest.mark.parametrize("spin", [False, True])
def test_anal_reduce_plain_version_slot_route(spin):
    """The slot route of the second pass (m_vals None, the layout's slot
    maps): each slot keeps its stream up to its live end past both
    segments, which is where the layout's dead positions start, and the
    chunk sum there; the wrapper takes m_vals or slot_maps, not both and
    not neither."""
    from repro_torch.kernels import fused_cuda, pack
    l_max = 20
    rows, mp = (np.arange(l_max + 1), None) if not spin else \
        legendre._spin_rows(np.arange(l_max + 1))
    lo = pack.build_layout(rows, l_max, mp_vals=mp)
    maps = fused_cuda.slot_maps(ops._pack_maps(lo, "cpu"), spin)
    rng = np.random.default_rng(5)
    part = torch.as_tensor(rng.normal(size=(lo.n_slots, 3, lo.S, 4))
                           .astype(np.float32))
    out = kref.anal_reduce_ref(part, None, l_max=l_max, slot_maps=maps)
    dead = torch.as_tensor(lo.a_row < 0)[..., None]
    assert torch.equal(out, torch.where(dead, 0.0, part.sum(dim=1)))
    m = torch.zeros(lo.n_slots, dtype=torch.int32)
    for m_vals, sm in ((None, None), (m, maps)):
        with pytest.raises(ValueError, match="m_vals .* or slot_maps"):
            legendre_cuda.anal_reduce(part, m_vals, l_max=l_max,
                                      slot_maps=sm)


@pytest.mark.parametrize("K2,variant,want", [
    (2, None, "vpu"), (14, None, "vpu"), (16, None, "mxu"), (64, None, "mxu"),
    (2, "mxu", "mxu"), (32, "vpu", "vpu")])
def test_pick_variant_static_rule(K2, variant, want):
    from repro.kernels import ops as rops
    assert ops.pick_variant(K2, variant) == want
    if variant is None:
        assert rops.pick_variant(K2) == want
    with pytest.raises(ValueError):
        ops.pick_variant(K2, "tpu")


def test_other_devices_raise_instead_of_falling_back():
    """A kernel request on a device that is neither the CPU (plain version)
    nor CUDA (the kernel) raises; nothing falls back."""
    m_vals, x, pmm, pms, a, dw = case(8, 1, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.synth(torch.as_tensor(a).to("meta"), m_vals, x, pmm, pms,
                  l_max=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.anal(torch.as_tensor(dw).to("meta"), m_vals, x, pmm, pms,
                 l_max=8)


@pytest.mark.parametrize("name", ["synth_vpu", "synth_mxu", "anal_vpu",
                                  "anal_mxu"])
def test_kernel_wrappers_take_cuda_tensors_only(name):
    """The CUDA wrappers never run a plain version: a CPU tensor is refused
    before anything is built or launched, and no launch is counted."""
    m_vals, x, pmm, pms, a, dw = case(8, 1, False)
    op = torch.as_tensor(a if name.startswith("synth") else dw)
    t = [torch.as_tensor(v) for v in (m_vals.astype(np.int32), x, pmm, pms)]
    before = dict(legendre_cuda.launches)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        getattr(legendre_cuda, name)(op, *t, l_max=8)
    assert legendre_cuda.launches == before
