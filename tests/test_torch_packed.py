"""The port's packed staged layout on the CPU: the plain versions of the
packed kernels (``kernels.ref.synth_packed_ref`` / ``anal_packed_ref``)
against the reference's packed oracles, the port's ``ops.synth`` /
``ops.anal`` with ``layout="packed"`` against the reference's packed
kernels in Pallas interpret mode, packed against the port's own plain
layout, and ``make_plan(layout="packed")`` against the reference plan
forced onto its packed kernels.

Tolerances: 5e-5 x max|ref| against the reference (the same float32
schedule, rounded differently by the two frameworks, see
test_torch_ops.py); synthesis bit-equal to the port's plain layout (the
same P_lm bits and the same per-row sums in the same order), analysis
within 1e-5 x max (the ring sums run as one contraction per slot instead
of one per row, so they round in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import grids as rgrids
from repro.core import legendre as rleg
from repro.core import sht as rsht
from repro.kernels import ops as rops
from repro.kernels import pack as rpack
from repro.kernels import ref as rref

import repro_torch
from repro_torch.kernels import ops, pack
from repro_torch.kernels import ref as kref

TOL = 5e-5
PLAIN_TOL = 1e-5


def rel(got, want) -> float:
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def case(l_max, K, fold, seed=0, m_vals=None):
    """Seeded numpy inputs of one case, for both packages: GL seeds (the
    northern half with the fold), coefficients zero where l < m, and
    weighted Delta planes."""
    g = rgrids.make_grid("gl", l_max=l_max)
    nh = (g.n_rings + 1) // 2
    x = (g.cos_theta[:nh] if fold else g.cos_theta).astype(np.float32)
    sin = g.sin_theta[:nh] if fold else g.sin_theta
    m_vals = np.arange(l_max + 1) if m_vals is None else np.asarray(m_vals)
    pmm, pms = kref.prepare_seeds(m_vals, sin, rleg.log_mu(l_max))
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (len(m_vals), l_max + 1, 2 * K)).astype(np.float32)
    a *= ((np.arange(l_max + 1)[None, :] >= m_vals[:, None])
          & (m_vals[:, None] >= 0))[..., None]
    dw = rng.uniform(-1, 1, (len(m_vals), 2 if fold else 1, len(x), 2 * K)
                     ).astype(np.float32)
    return m_vals, x, pmm, pms, a, dw


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("l_max", [24, 64])
def test_packed_plain_versions_match_reference_oracles(l_max, K, fold):
    """synth_packed_ref / anal_packed_ref against the reference's
    synth_packed_ref / anal_packed_ref on the same packed operands, in the
    two memory orders of the vpu and mxu kernels."""
    m_vals, x, pmm, pms, a, _ = case(l_max, K, fold, seed=l_max + K)
    lo, rlo = pack.build_layout(m_vals, l_max), rpack.build_layout(m_vals,
                                                                   l_max)
    t = torch.as_tensor
    maps, x_t, pmm_pk, pms_pk = ops._prep(lo, t(x), t(pmm), t(pms))
    a_pk = ops._pack_a(t(a), lo)
    want = rref.synth_packed_ref(jnp.asarray(a_pk.numpy()), rlo,
                                 jnp.asarray(x), jnp.asarray(pmm_pk.numpy()),
                                 jnp.asarray(pms_pk.numpy()), fold=fold)
    Q = 2 * (2 if fold else 1)
    dw_pk = np.random.default_rng(l_max).uniform(
        -1, 1, (lo.n_slots, Q, len(x), 2 * K)).astype(np.float32)
    want_a = rref.anal_packed_ref(jnp.asarray(dw_pk), rlo, jnp.asarray(x),
                                  jnp.asarray(pmm_pk.numpy()),
                                  jnp.asarray(pms_pk.numpy()), fold=fold)
    for layout in ("mxu", "vpu"):
        got = kref.synth_packed_ref(a_pk, maps, x_t, pmm_pk, pms_pk,
                                    l_max=l_max, fold=fold, layout=layout)
        if layout == "vpu":
            assert got.shape == (lo.n_slots, Q, 2 * K, len(x))
            got = got.movedim(2, -1)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert rel(got, want) < TOL
        d = t(dw_pk).movedim(-1, 2).contiguous() if layout == "vpu" \
            else t(dw_pk)
        got_a = kref.anal_packed_ref(d, maps, x_t, pmm_pk, pms_pk,
                                     l_max=l_max, s_len=lo.S, layout=layout)
        assert got_a.shape == want_a.shape
        assert rel(got_a, want_a) < TOL


@pytest.mark.parametrize("variant,fold,l_max", [
    ("vpu", False, 24), ("mxu", True, 21), ("vpu", True, 17)])
def test_packed_seam_matches_reference_pallas(variant, fold, l_max):
    """ops.synth / ops.anal with layout="packed" against the reference's
    packed Pallas kernels in interpret mode, with a plan padding row."""
    m_vals = np.insert(np.arange(l_max + 1), 5, -1)
    m_vals, x, pmm, pms, a, dw = case(l_max, 2, fold, seed=l_max,
                                      m_vals=m_vals)
    kw = dict(l_max=l_max, fold=fold, variant=variant, layout="packed")
    want_s = rops.synth(jnp.asarray(a), m_vals, jnp.asarray(x),
                        jnp.asarray(pmm), jnp.asarray(pms), **kw)
    want_a = rops.anal(jnp.asarray(dw), m_vals, jnp.asarray(x),
                       jnp.asarray(pmm), jnp.asarray(pms), **kw)
    got_s = ops.synth(torch.as_tensor(a), m_vals, x, pmm, pms, **kw)
    got_a = ops.anal(torch.as_tensor(dw), m_vals, x, pmm, pms, **kw)
    assert got_s.shape == want_s.shape and got_a.shape == want_a.shape
    assert rel(got_s, want_s) < TOL
    assert rel(got_a, want_a) < TOL
    assert bool((got_s[5] == 0).all()) and bool((got_a[5] == 0).all())


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
@pytest.mark.parametrize("l_max", [16, 40])
def test_packed_against_plain_layout(l_max, variant, fold):
    """Packed synthesis equals the plain layout's bit for bit; packed
    analysis agrees within 1e-5 x max, padding rows exactly zero."""
    m_vals = np.concatenate([np.arange(l_max + 1), [-1]])
    m_vals, x, pmm, pms, a, dw = case(l_max, 3, fold, seed=7, m_vals=m_vals)
    store = {}
    kw = dict(l_max=l_max, fold=fold, variant=variant)
    t = torch.as_tensor
    plain = ops.synth(t(a), m_vals, x, pmm, pms, **kw)
    packed = ops.synth(t(a), m_vals, x, pmm, pms, layout="packed",
                       store=store, **kw)
    assert torch.equal(packed, plain)
    plain = ops.anal(t(dw), m_vals, x, pmm, pms, **kw)
    packed = ops.anal(t(dw), m_vals, x, pmm, pms, layout="packed",
                      store=store, **kw)
    assert rel(packed, plain) < PLAIN_TOL
    assert bool((packed[-1] == 0).all())
    assert store["layout"] is pack.build_layout(m_vals, l_max)


def test_pick_layout_and_store():
    assert ops.pick_layout("packed") == "packed"
    assert ops.pick_layout("plain") == "plain"
    with pytest.raises(ValueError, match="None"):
        ops.pick_layout(None)
    with pytest.raises(ValueError, match="plan level"):
        ops.pick_layout("fused")
    with pytest.raises(ValueError, match="banded"):
        ops.pick_layout("banded")
    with pytest.raises(ValueError, match="live row"):
        m_vals, x, pmm, pms, a, _ = case(4, 1, False, m_vals=[-1, -1])
        ops.synth(torch.as_tensor(a), m_vals, x, pmm, pms, l_max=4,
                  layout="packed")


@pytest.mark.parametrize("layout", ["plain", "packed"])
@pytest.mark.parametrize("fold", [False, True])
def test_seam_refuses_shapes_without_a_transpose(fold, layout):
    """Every seam call is a linear pair: a row count other than l_max + 1
    (synthesis) or a plane count other than P (analysis) raises instead of
    running without its backward rule."""
    l_max = 8
    m_vals, x, pmm, pms, a, dw = case(l_max, 1, fold)
    kw = dict(l_max=l_max, fold=fold, layout=layout)
    with pytest.raises(ValueError, match="coefficient rows"):
        ops.synth(torch.as_tensor(a[:, :-1]), m_vals, x, pmm, pms, **kw)
    bad = np.concatenate([dw, dw], axis=1)
    with pytest.raises(ValueError, match="planes"):
        ops.anal(torch.as_tensor(bad), m_vals, x, pmm, pms, **kw)


def alm_for(l_max, K, seed):
    rng = np.random.default_rng(seed)
    shape = (l_max + 1, l_max + 1, K)
    alm = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    alm[0] = alm[0].real
    return (alm * rsht.alm_mask(l_max, l_max)[..., None]).astype(np.complex64)


@pytest.mark.parametrize("variant,K,fold", [("vpu", 1, False),
                                            ("mxu", 8, True)])
def test_packed_plan_matches_reference_packed_plan(variant, K, fold):
    """make_plan(layout="packed") against the reference plan forced onto
    its packed kernels (``_synth_fn(backend, "packed")``), both directions,
    and the port's packed plan against its plain plan."""
    l_max = 23 if fold else 20
    alm = alm_for(l_max, K, seed=K)
    ref = repro.make_plan("gl", l_max, K=K, dtype="float32",
                          mode=f"pallas_{variant}", fold=fold)
    want_maps = np.array(ref._synth_fn(f"pallas_{variant}", "packed")(alm))
    want_alm = np.array(ref._anal_fn(f"pallas_{variant}",
                                     "packed")(want_maps))
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                                 mode=f"cuda_{variant}", fold=fold,
                                 layout="packed", device="cpu")
    assert plan.layouts == {"synth": "packed", "anal": "packed"}
    assert f"synth -> cuda_{variant}[packed]" in plan.report()
    maps = plan.alm2map(alm)
    assert maps.shape == want_maps.shape and maps.dtype == torch.float32
    assert rel(maps, want_maps) < TOL
    got = plan.map2alm(want_maps)
    assert rel(got, want_alm) < TOL
    plain = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                                  mode=f"cuda_{variant}", fold=fold,
                                  layout="plain", device="cpu")
    assert torch.equal(plain.alm2map(alm), maps)
    assert rel(plain.map2alm(want_maps), got) < PLAIN_TOL


@pytest.mark.parametrize("l_max,m_max", [(20, 20), (200, 200), (64, 30)])
def test_describe_panels_match_reference(l_max, m_max):
    plan = repro_torch.make_plan("gl", l_max, m_max=m_max, K=1,
                                 dtype="float32", layout="packed",
                                 device="cpu")
    ref = repro.make_plan("gl", l_max, m_max=m_max, K=1, dtype="float32",
                          mode="pallas_vpu")
    got, want = (p.describe()["legendre"] for p in (plan, ref))
    assert got["layouts"] == {"synth": "packed", "anal": "packed"}
    assert got["panels"].keys() == want["panels"].keys()
    for k, v in want["panels"].items():
        np.testing.assert_array_equal(got["panels"][k], v)
