"""The spin branch of the port's kernels on the CPU: the plain versions
(``kernels.ref``, ``mp_vals=`` / ``spin=True``) against the reference's
``_f32_step_spin`` oracles, the ``ops`` seam and the fused chains against
the reference's Pallas kernels in interpret mode, and the spin-2 plans of
every backend and layout against the reference's spin-2 plans.

Tolerances: 5e-5 x max|ref| against the reference's float32 schedule (the
same arithmetic, rounded differently by the two frameworks, see
test_torch_ops.py); 1e-12 for the float64 ``torch`` plan against the
reference's float64 plan; bit equality where the port runs one code path
twice (packed = plain synthesis, fused = packed without tables); 1e-5 x
max between the port's layouts where only the ring sums round apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import grids as rgrids
from repro.core import legendre as rleg
from repro.core import sht as rsht
from repro.kernels import fused as rfused
from repro.kernels import ops as rops
from repro.kernels import pack as rpack
from repro.kernels import ref as rref

import repro_torch
from repro_torch.core import transform
from repro_torch.kernels import fused, ops, pack
from repro_torch.kernels import ref as kref

TOL = 5e-5
LAYOUT_TOL = 1e-5


def rel(got, want) -> float:
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def spin_case(l_max, K, seed=0, pad=False):
    """Seeded numpy operands of the spin branch, for both packages: the 2M
    rows [m' = -2 | m' = +2] (a padding row among them with ``pad``), GL
    spin seeds, coefficients zero below l0 = max(m, |m'|), weighted
    Delta rows."""
    g = rgrids.make_grid("gl", l_max=l_max)
    m2, mp2 = rleg._spin_rows(np.arange(l_max + 1))
    if pad:
        m2, mp2 = np.insert(m2, 5, -1), np.insert(mp2, 5, 2)
    pmm, pms = kref.prepare_seeds_spin(m2, mp2, g.cos_theta, g.sin_theta,
                                       m_max=l_max)
    rng = np.random.default_rng(seed)
    l0 = np.maximum(m2, np.abs(mp2))
    keep = (np.arange(l_max + 1)[None, :] >= l0[:, None]) & (m2 >= 0)[:, None]
    a = rng.uniform(-1, 1, (len(m2), l_max + 1, 2 * K)).astype(np.float32)
    a *= keep[..., None]
    dw = rng.uniform(-1, 1, (len(m2), 1, g.n_rings, 2 * K)).astype(np.float32)
    return dict(g=g, m=m2, mp=mp2, x=g.cos_theta.astype(np.float32), pmm=pmm,
                pms=pms, a=a, dw=dw, l0=l0)


@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("l_max", [24, 40, 64])
def test_spin_plain_versions_match_reference(l_max, K):
    """synth_ref / anal_ref with mp_vals against the reference's oracles;
    the analysis rows below l0 = max(m, |m'|) are exact zeros."""
    c = spin_case(l_max, K, seed=l_max + K)
    t = torch.as_tensor
    j = jnp.asarray
    want_s = rref.synth_ref(j(c["a"]), c["m"], j(c["x"]), j(c["pmm"]),
                            j(c["pms"]), l_max=l_max, mp_vals=c["mp"])
    want_a = rref.anal_ref(j(c["dw"]), c["m"], j(c["x"]), j(c["pmm"]),
                           j(c["pms"]), l_max=l_max, l1p=l_max + 1,
                           mp_vals=c["mp"])
    got_s = kref.synth_ref(t(c["a"]), t(c["m"]), t(c["x"]), t(c["pmm"]),
                           t(c["pms"]), l_max=l_max, mp_vals=t(c["mp"]))
    got_a = kref.anal_ref(t(c["dw"]), t(c["m"]), t(c["x"]), t(c["pmm"]),
                          t(c["pms"]), l_max=l_max, mp_vals=t(c["mp"]))
    assert got_s.shape == want_s.shape and got_a.shape == want_a.shape
    assert rel(got_s, want_s) < TOL
    assert rel(got_a, want_a) < TOL
    below = np.arange(l_max + 1)[None, :] < c["l0"][:, None]
    assert bool((got_a[torch.as_tensor(below)] == 0).all())


def test_spin_step_reduces_to_its_own_rows_only():
    """Rows with m' = 0 through the spin step reproduce the scalar P_lm to
    float32 rounding, and the spin anal_reduce zeroes l < max(m, |m'|)."""
    l_max = 20
    g = rgrids.make_grid("gl", l_max=l_max)
    m = np.arange(l_max + 1)
    x = torch.as_tensor(g.cos_theta, dtype=torch.float32)
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, (l_max + 1, l_max + 1, 2)).astype(np.float32)
    a *= (np.arange(l_max + 1)[None, :] >= m[:, None])[..., None]
    pmm, pms = kref.prepare_seeds(m, g.sin_theta, rleg.log_mu(l_max))
    spm, sps = kref.prepare_seeds_spin(m, 0 * m, g.cos_theta, g.sin_theta)
    assert np.array_equal(sps, pms)
    np.testing.assert_allclose(spm, pmm, rtol=1e-6)
    t = torch.as_tensor
    scalar = kref.synth_ref(t(a), t(m), x, t(pmm), t(pms), l_max=l_max)
    spin = kref.synth_ref(t(a), t(m), x, t(spm), t(sps), l_max=l_max,
                          mp_vals=t(0 * m))
    assert rel(spin, scalar) < 1e-5
    part = torch.rand((4, 2, l_max + 1, 2))
    mv, mpv = torch.tensor([0, 1, 5, -1]), torch.tensor([-2, 2, -2, 2])
    red = kref.anal_reduce_ref(part, mv, l_max=l_max, mp_vals=mpv)
    for r, l0 in enumerate((2, 2, 5)):
        assert bool((red[r, :l0] == 0).all()) and bool((red[r, l0:] != 0).all())
    assert bool((red[3] == 0).all())


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("l_max", [24, 64])
def test_spin_packed_plain_versions_match_reference_oracles(l_max, K):
    """synth_packed_ref / anal_packed_ref (spin=True) against the
    reference's packed oracles on its spin layout, both memory orders."""
    c = spin_case(l_max, K, seed=3 * l_max + K)
    lo = pack.build_layout(c["m"], l_max, mp_vals=c["mp"])
    rlo = rpack.build_layout(c["m"], l_max, mp_vals=c["mp"])
    t = torch.as_tensor
    maps, x_t, pmm_pk, pms_pk = ops._prep(lo, t(c["x"]), t(c["pmm"]),
                                          t(c["pms"]))
    a_pk = ops._pack_a(t(c["a"]), lo)
    want = rref.synth_packed_ref(jnp.asarray(a_pk.numpy()), rlo,
                                 jnp.asarray(c["x"]),
                                 jnp.asarray(pmm_pk.numpy()),
                                 jnp.asarray(pms_pk.numpy()))
    dw_pk = np.random.default_rng(l_max).uniform(
        -1, 1, (lo.n_slots, 2, len(c["x"]), 2 * K)).astype(np.float32)
    want_a = rref.anal_packed_ref(jnp.asarray(dw_pk), rlo,
                                  jnp.asarray(c["x"]),
                                  jnp.asarray(pmm_pk.numpy()),
                                  jnp.asarray(pms_pk.numpy()))
    for layout in ("mxu", "vpu"):
        got = kref.synth_packed_ref(a_pk, maps, x_t, pmm_pk, pms_pk,
                                    l_max=l_max, layout=layout, spin=True)
        if layout == "vpu":
            got = got.movedim(2, -1)
        assert got.shape == want.shape
        assert rel(got, want) < TOL
        d = t(dw_pk).movedim(-1, 2).contiguous() if layout == "vpu" \
            else t(dw_pk)
        got_a = kref.anal_packed_ref(d, maps, x_t, pmm_pk, pms_pk,
                                     l_max=l_max, s_len=lo.S, layout=layout,
                                     spin=True)
        assert rel(got_a, want_a) < TOL
        assert bool((got_a[torch.as_tensor(lo.a_row < 0)] == 0).all())


@pytest.mark.parametrize("layout,variant,l_max", [
    ("plain", "vpu", 20), ("plain", "mxu", 17), ("packed", "vpu", 16),
    ("packed", "mxu", 19)])
def test_spin_seam_matches_reference_pallas(layout, variant, l_max):
    """ops.synth / ops.anal with mp_vals against the reference's Pallas
    kernels with mp_vals in interpret mode, a padding row included."""
    c = spin_case(l_max, 2, seed=l_max, pad=True)
    kw = dict(l_max=l_max, variant=variant, layout=layout)
    j = jnp.asarray
    want_s = rops.synth(j(c["a"]), c["m"], j(c["x"]), j(c["pmm"]),
                        j(c["pms"]), mp_vals=c["mp"], **kw)
    want_a = rops.anal(j(c["dw"]), c["m"], j(c["x"]), j(c["pmm"]),
                       j(c["pms"]), mp_vals=c["mp"], **kw)
    t = torch.as_tensor
    got_s = ops.synth(t(c["a"]), c["m"], c["x"], c["pmm"], c["pms"],
                      mp_vals=c["mp"], **kw)
    got_a = ops.anal(t(c["dw"]), c["m"], c["x"], c["pmm"], c["pms"],
                     mp_vals=c["mp"], **kw)
    assert got_s.shape == want_s.shape and got_a.shape == want_a.shape
    assert rel(got_s, want_s) < TOL
    assert rel(got_a, want_a) < TOL
    assert bool((got_s[5] == 0).all()) and bool((got_a[5] == 0).all())


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_spin_packed_layout_against_plain_layout(variant):
    """Packed spin synthesis equals the plain layout's bit for bit (the
    same lambda bits, the same per-row sums); packed spin analysis agrees
    within 1e-5 x max (ring sums in another order)."""
    l_max = 30
    c = spin_case(l_max, 3, seed=9, pad=True)
    kw = dict(l_max=l_max, variant=variant, mp_vals=c["mp"])
    t = torch.as_tensor
    args = (c["m"], c["x"], c["pmm"], c["pms"])
    store = {}
    plain = ops.synth(t(c["a"]), *args, **kw)
    packed = ops.synth(t(c["a"]), *args, layout="packed", store=store, **kw)
    assert torch.equal(packed, plain)
    assert store["layout"] is pack.build_layout(c["m"], l_max,
                                                mp_vals=c["mp"])
    plain = ops.anal(t(c["dw"]), *args, **kw)
    packed = ops.anal(t(c["dw"]), *args, layout="packed", store=store, **kw)
    assert rel(packed, plain) < LAYOUT_TOL
    below = np.arange(l_max + 1)[None, :] < c["l0"][:, None]
    assert bool((packed[torch.as_tensor(below)] == 0).all())


def test_spin_seam_refuses_the_fold():
    c = spin_case(8, 1)
    with pytest.raises(ValueError, match="fold"):
        ops.synth(torch.as_tensor(c["a"]), c["m"], c["x"], c["pmm"],
                  c["pms"], l_max=8, fold=True, mp_vals=c["mp"])
    with pytest.raises(ValueError, match="fold"):
        fused._resolve(c["m"], 8, None, c["mp"], False, 17)


def fused_case(l_max, K, seed):
    """Spin operands of the fused chains, with random ring offsets phi0 (so
    the rotation tables are not the identity) and an FFT length with a
    row on the conjugate half."""
    c = spin_case(l_max, K, seed=seed)
    rng = np.random.default_rng(seed)
    R = c["g"].n_rings
    n = 2 * l_max + 2
    c["maps"] = rng.normal(size=(R, n, 2 * K)).astype(np.float32)
    c["kw"] = dict(l_max=l_max, n=n, phi0=rng.uniform(0, 6, R))
    return c


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_spin_fused_chain_matches_reference(variant):
    """fused_synth / fused_anal with mp_vals against the reference's fused
    chains with mp_vals (Pallas interpret mode): Q|U maps (R, n, 2K) and
    the 2M a^{+-} rows."""
    l_max, K = 16, 2
    c = fused_case(l_max, K, seed=21)
    kw = dict(c["kw"], variant=variant, mp_vals=c["mp"])
    j = jnp.asarray
    want_s = rfused.fused_synth(j(c["a"]), c["m"], j(c["x"]), j(c["pmm"]),
                                j(c["pms"]), **kw)
    want_a = rfused.fused_anal(j(c["maps"]), c["g"].weights, c["m"],
                               j(c["x"]), j(c["pmm"]), j(c["pms"]), **kw)
    t = torch.as_tensor
    got_s = fused.fused_synth(t(c["a"]), c["m"], t(c["x"]), t(c["pmm"]),
                              t(c["pms"]), **kw)
    got_a = fused.fused_anal(t(c["maps"]), c["g"].weights, c["m"], t(c["x"]),
                             t(c["pmm"]), t(c["pms"]), **kw)
    assert got_s.shape == want_s.shape == (c["g"].n_rings, c["kw"]["n"], 2 * K)
    assert got_a.shape == want_a.shape == (2 * (l_max + 1), l_max + 1, 2 * K)
    assert rel(got_s, want_s) < TOL
    assert rel(got_a, want_a) < TOL


def test_spin_fused_chain_against_the_staged_seam():
    """On a GL grid (identity tables) the fused spin synthesis is the
    staged spin synthesis of the plain layout followed by the phase stage,
    within 1e-5 x max."""
    l_max, K = 20, 2
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                                 mode="cuda_vpu", spin=2, device="cpu")
    staged = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                                   mode="cuda_vpu", spin=2, layout="plain",
                                   device="cpu")
    assert plan.layouts == {"synth": "fused", "anal": "fused"}
    a = torch.as_tensor(spin_alm(l_max, K, 5))
    assert rel(plan.alm2map(a), staged.alm2map(a).numpy()) < LAYOUT_TOL
    maps = staged.alm2map(a)
    assert rel(plan.map2alm(maps), staged.map2alm(maps).numpy()) < LAYOUT_TOL
    assert plan._fused_store[("tables", "synth")] is None


def spin_alm(l_max, K, seed):
    rng = np.random.default_rng(seed)
    shape = (2, l_max + 1, l_max + 1, K)
    a = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    a[:, 0] = a[:, 0].real
    return (a * rsht.alm_mask(l_max, l_max, spin=2)[None, ..., None]
            ).astype(np.complex64)


@pytest.mark.parametrize("layout,variant,K", [
    ("plain", "vpu", 1), ("packed", "mxu", 8), ("fused", "vpu", 2),
    ("fused", "mxu", 8)])
def test_spin_kernel_plan_matches_reference_pallas_plan(layout, variant, K):
    """make_plan(spin=2) on every layout against the reference's spin-2 plan
    forced onto the same Pallas kernels and layout (interpret mode)."""
    l_max = 14
    alm = spin_alm(l_max, K, seed=K)
    ref = repro.make_plan("gl", l_max, K=K, dtype="float32",
                          mode=f"pallas_{variant}", spin=2)
    want_maps = np.array(ref._synth_fn(f"pallas_{variant}", layout)(alm))
    want_alm = np.array(ref._anal_fn(f"pallas_{variant}", layout)(want_maps))
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                                 mode=f"cuda_{variant}", spin=2,
                                 layout=None if layout == "fused" else layout,
                                 device="cpu")
    assert plan.layouts == {"synth": layout, "anal": layout}
    maps = plan.alm2map(alm)
    assert maps.shape == want_maps.shape == plan._maps_shape
    assert maps.dtype == torch.float32
    assert rel(maps, want_maps) < TOL
    got = plan.map2alm(want_maps)
    assert got.shape == want_alm.shape and got.dtype == torch.complex64
    assert rel(got, want_alm) < TOL


@pytest.mark.parametrize("dtype,mode", [("float64", "torch"),
                                        ("float32", "torch")])
def test_spin_torch_plan_matches_reference_plan(dtype, mode):
    """The torch backend's spin-2 plan against the reference's jnp spin-2
    plan: 1e-12 in float64, 5e-5 in float32."""
    l_max, K = 20, 3
    alm = spin_alm(l_max, K, seed=8).astype(np.complex128)
    ref = repro.make_plan("gl", l_max, K=K, dtype=dtype, mode="jnp", spin=2)
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype=dtype, mode=mode,
                                 spin=2, device="cpu")
    tol = 1e-12 if dtype == "float64" else TOL
    want_maps = np.array(ref.alm2map(jnp.asarray(alm)))
    assert rel(plan.alm2map(torch.as_tensor(alm)), want_maps) < tol
    want = np.asarray(ref.map2alm(jnp.asarray(want_maps), iters=1))
    assert rel(plan.map2alm(torch.as_tensor(want_maps), iters=1), want) < tol


@pytest.mark.parametrize("layout", ["fused", "plain", "packed"])
@pytest.mark.parametrize("mode", ["cuda_vpu", "cuda_mxu"])
def test_spin_kernel_plans_round_trip(mode, layout):
    l_max, K = 24, 2
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                                 mode=mode, spin=2, layout=layout,
                                 device="cpu")
    alm = torch.as_tensor(spin_alm(l_max, K, seed=2))
    back = plan.map2alm(plan.alm2map(alm))
    err = float(((back - alm).abs() ** 2).sum().sqrt()
                / (alm.abs() ** 2).sum().sqrt())
    assert err < 1e-5
    assert bool((back[:, :, :2] == 0).all())


def test_spin_plan_surface():
    transform.clear_plan_cache()
    p0 = repro_torch.make_plan("gl", 12, K=2, dtype="float32", device="cpu")
    p2 = repro_torch.make_plan("gl", 12, K=2, dtype="float32", spin=2,
                               device="cpu")
    assert p2 is not p0 and p2.spin == 2 and p0.spin == 0
    assert repro_torch.make_plan("gl", 12, K=2, dtype="float32", spin=2,
                                 layout="fused", device="cpu") is p2
    assert p2._alm_shape == (2, 13, 13, 2)
    assert p2._maps_shape == (2, p2.grid.n_rings, p2.grid.max_n_phi, 2)
    # the seed cache keys carry the spin: no plan reuses the other's seeds
    assert p0._seeds_key != p2._seeds_key
    assert p2._seeds_spin()[2].shape == (26, p2.grid.n_rings)
    assert p0._seeds()[2].shape == (13, p2.grid.n_rings)
    d = p2.describe()
    assert d["signature"]["spin"] == 2
    assert d["fusion"]["eligible"] and d["layouts"]["synth"] == "fused"
    m2, mp2 = ops.spin_rows(np.arange(13))
    assert d["legendre"]["panels"] == pack.panel_counts(m2, 12, mp_vals=mp2)
    assert d["legendre"]["panels"]["ideal_steps"] == 2 * sum(
        13 - max(m, 2) for m in range(13))
    assert "spin=2" in p2.report()
    assert p2.memory_footprint()["alm_bytes"] == \
        2 * p0.memory_footprint()["alm_bytes"]
    with pytest.raises(ValueError, match="shape"):
        p2.alm2map(torch.zeros((13, 13, 2), dtype=torch.complex64))


def test_spin_nyquist_rule_is_the_reference_one():
    """Spin 2 at the uniform Nyquist alias point (n_phi == 2 m_max) is not
    fused, as in the reference; the default layout is then plain."""
    g = rgrids.make_grid("gl", l_max=10)
    from repro_torch.core.grids import RingGrid
    grid = RingGrid(name="gl-nyquist", cos_theta=g.cos_theta,
                    sin_theta=g.sin_theta, weights=g.weights,
                    n_phi=np.full(g.n_rings, 20), phi0=np.zeros(g.n_rings),
                    uniform=True)
    plan = repro_torch.make_plan(grid, 10, K=1, dtype="float32", spin=2,
                                 device="cpu")
    ok, reason = plan._fusion_eligibility()
    assert not ok and "Nyquist" in reason
    assert plan.layouts == {"synth": "plain", "anal": "plain"}
    with pytest.raises(ValueError, match="Nyquist"):
        repro_torch.make_plan(grid, 10, K=1, dtype="float32", spin=2,
                              layout="fused", device="cpu")
    assert transform._fusion_eligibility(grid, 0, 10) == (True, None)
    rplan = repro.make_plan(rgrids.RingGrid(
        name="gl-nyquist", cos_theta=g.cos_theta, sin_theta=g.sin_theta,
        weights=g.weights, n_phi=np.full(g.n_rings, 20),
        phi0=np.zeros(g.n_rings), uniform=True), 10, K=1, dtype="float32",
        mode="pallas_vpu", spin=2)
    assert not rplan._fusion_eligibility()[0]
    a = torch.as_tensor(spin_alm(10, 1, seed=4))
    back = plan.map2alm(plan.alm2map(a))
    assert back.shape == a.shape and bool(torch.isfinite(back.real).all())
