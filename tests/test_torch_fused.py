"""The port's fused Legendre+phase pipeline on the CPU: its plain kernel
versions (``kernels.ref.synth_fused_ref`` / ``anal_fused_ref``) behind
``kernels.fused.fused_synth`` / ``fused_anal`` against the reference's
``repro.kernels.fused`` run in Pallas interpret mode, the whole fused plan
against the reference plan's fused path, and fused against the port's own
staged path.

Tolerances: 5e-5 x max|ref| against the reference (the same float32
schedule, rounded differently by the two frameworks, see
test_torch_ops.py); 1e-5 x max against the port's staged path (the
reference's own fused-vs-staged band, tests/test_fused.py).
"""

import os
import subprocess
import sys

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

import repro_torch
from repro_torch import interop
from repro_torch.core import spectra
from repro_torch.kernels import fused, ops, pack
from repro_torch.kernels import ref as kref

TOL = 5e-5
STAGED_TOL = 1e-5


def rel(got, want) -> float:
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def case(l_max, K, fold, seed=0):
    """Seeded numpy inputs for both packages: GL geometry with random ring
    offsets phi0 (so the rotation tables are not the identity), an FFT
    length that puts a row on the Nyquist bin (fold off) or on the
    conjugate half (fold on), coefficients and maps."""
    g = rgrids.make_grid("gl", l_max=l_max)
    R = g.n_rings
    nh = (R + 1) // 2
    x = (g.cos_theta[:nh] if fold else g.cos_theta).astype(np.float32)
    sin = g.sin_theta[:nh] if fold else g.sin_theta
    m_vals = np.arange(l_max + 1)
    pmm, pms = kref.prepare_seeds(m_vals, sin, rleg.log_mu(l_max))
    rng = np.random.default_rng(seed)
    n = l_max + 3 if fold else 2 * l_max
    a = rng.uniform(-1, 1, (l_max + 1, l_max + 1, 2 * K)).astype(np.float32)
    a *= (np.arange(l_max + 1)[None, :] >= m_vals[:, None])[..., None]
    return dict(g=g, m_vals=m_vals, x=x, pmm=pmm, pms=pms, a=a,
                maps=rng.normal(size=(R, n, K)).astype(np.float32),
                kw=dict(l_max=l_max, n=n, phi0=rng.uniform(0, 6, R),
                        fold_rings=R if fold else None))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_fused_chain_matches_reference(variant, fold):
    c = case(24, 2, fold, seed=fold)
    kw = dict(c["kw"], variant=variant)
    want_s = rfused.fused_synth(jnp.asarray(c["a"]), c["m_vals"],
                                jnp.asarray(c["x"]), jnp.asarray(c["pmm"]),
                                jnp.asarray(c["pms"]), **kw)
    want_a = rfused.fused_anal(jnp.asarray(c["maps"]), c["g"].weights,
                               c["m_vals"], jnp.asarray(c["x"]),
                               jnp.asarray(c["pmm"]), jnp.asarray(c["pms"]),
                               **kw)
    t = torch.as_tensor
    got_s = fused.fused_synth(t(c["a"]), c["m_vals"], t(c["x"]), t(c["pmm"]),
                              t(c["pms"]), **kw)
    got_a = fused.fused_anal(t(c["maps"]), c["g"].weights, c["m_vals"],
                             t(c["x"]), t(c["pmm"]), t(c["pms"]), **kw)
    assert got_s.shape == want_s.shape and got_s.dtype == torch.float32
    assert got_a.shape == want_a.shape and got_a.dtype == torch.float32
    assert rel(got_s, want_s) < TOL
    assert rel(got_a, want_a) < TOL


def test_reference_packed_operands_carry_across():
    """``interop.from_reference`` takes the reference's packed operands
    (ring-tiled seeds and fold tables, the stacked slot maps); the port's
    plain fused versions on them match the reference's mxu kernels run
    directly, on every live stream position."""
    l_max, K = 24, 2
    c = case(l_max, K, True, seed=3)
    R, nh = c["g"].n_rings, c["x"].shape[0]
    lo = rpack.build_layout(c["m_vals"], l_max)
    _, R1, Rf1, x2d, pmm2, pms2 = rfused._prep(
        lo, jnp.asarray(c["x"]), jnp.asarray(c["pmm"]), jnp.asarray(c["pms"]),
        "mxu")
    tabs = {d: rfused._pack_tables(rfused._rotation_tables(
        c["m_vals"], d, phase_kind="uniform", n=c["kw"]["n"],
        phi0=c["kw"]["phi0"], fold_rings=R, n_half=nh), lo, Rf1)
        for d in ("synth", "anal")}
    a_pk = rops._pack_a(jnp.asarray(c["a"]), lo)
    pmaps = rops._pack_maps(lo)
    f_pk = np.random.default_rng(4).uniform(
        -1, 1, (lo.n_slots, 2, 2, R1 * 128, 2 * K)).astype(np.float32)
    f_pk[:, :, :, nh:] = 0.0
    want_s = np.asarray(rfused.synth_fused_mxu(
        a_pk, pmaps, x2d, pmm2, pms2, tabs["synth"], l_max=l_max))[:, :, :,
                                                                      :nh]
    want_a = np.asarray(rfused.anal_fused_mxu(
        jnp.asarray(f_pk), pmaps, x2d, pmm2, pms2, tabs["anal"], l_max=l_max,
        s_len=lo.S))
    t = interop.from_reference(
        {"a_pk": a_pk, "slot_maps": np.stack(pmaps), "pmm_pk": pmm2,
         "pms_pk": pms2, "tab_pk": tabs["synth"]}, device="cpu", n_rings=nh)
    tab_a = interop.from_reference({"tab_pk": tabs["anal"]}, device="cpu",
                                   n_rings=nh)["tab_pk"]
    assert t["pmm_pk"].shape == (lo.n_slots, 2, nh)
    assert t["tab_pk"].shape == (lo.n_slots, 2, 2, 4, nh)
    args = (tuple(t["slot_maps"]), torch.as_tensor(c["x"]), t["pmm_pk"],
            t["pms_pk"])
    got_s = kref.synth_fused_ref(t["a_pk"], *args, t["tab_pk"], l_max=l_max,
                                 fold=True, layout="mxu")
    assert rel(got_s, want_s) < TOL
    got_a = kref.anal_fused_ref(torch.as_tensor(f_pk[:, :, :, :nh]), *args,
                                tab_a, l_max=l_max, s_len=lo.S, layout="mxu")
    live = lo.a_row >= 0
    assert rel(got_a.numpy()[live], want_a[live]) < TOL
    with pytest.raises(ValueError, match="n_rings"):
        interop.from_reference({"pmm_pk": pmm2}, device="cpu")


def alm_for(l_max, K, seed):
    rng = np.random.default_rng(seed)
    shape = (l_max + 1, l_max + 1, K)
    alm = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    alm[0] = alm[0].real
    return (alm * rsht.alm_mask(l_max, l_max)[..., None]).astype(np.complex64)


@pytest.mark.parametrize("variant,K,fold", [("vpu", 1, False),
                                            ("mxu", 8, True)])
def test_fused_plan_matches_reference_plan(variant, K, fold):
    l_max = 24
    alm = alm_for(l_max, K, seed=K)
    ref = repro.make_plan("gl", l_max, K=K, dtype="float32",
                          mode=f"pallas_{variant}", fold=fold)
    want_maps = np.array(ref._synth_fn(f"pallas_{variant}", "fused")(alm))
    want_alm = np.array(ref._anal_fn(f"pallas_{variant}", "fused")(want_maps))
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                                 mode=f"cuda_{variant}", fold=fold,
                                 layout="fused", device="cpu")
    assert plan.layouts == {"synth": "fused", "anal": "fused"}
    maps = plan.alm2map(alm)
    assert rel(maps, want_maps) < TOL
    got_alm = plan.map2alm(want_maps)
    assert got_alm.dtype == torch.complex64
    assert rel(got_alm, want_alm) < TOL


@pytest.mark.parametrize("l_max", [17, 24])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_fused_matches_staged(variant, fold, l_max):
    K = 3
    fz = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                               mode=f"cuda_{variant}", fold=fold,
                               device="cpu")
    assert fz.layouts == {"synth": "fused", "anal": "fused"}
    alm = alm_for(l_max, K, seed=l_max)
    maps = np.random.default_rng(1).normal(
        size=fz._maps_shape).astype(np.float32)
    got_s = fz.alm2map(alm)
    want_s = fz._synth_fn(f"cuda_{variant}", "plain")(torch.as_tensor(alm))
    assert rel(got_s, want_s) < STAGED_TOL
    got_a = fz.map2alm(maps)
    want_a = fz._anal_fn(f"cuda_{variant}", "plain")(torch.as_tensor(maps))
    assert rel(got_a, want_a) < STAGED_TOL
    assert spectra.d_err(alm, fz.map2alm(got_s)) < 1e-5


@pytest.mark.parametrize("layout", ["vpu", "mxu"])
def test_plain_fused_versions_zero_dead_positions(layout):
    """Odd row count: one slot has no segment 1.  Its synthesis rows come
    out zero, and analysis leaves every dead stream position zero."""
    l_max, K = 16, 2
    c = case(l_max, K, False)
    lo = pack.build_layout(c["m_vals"], l_max)
    assert (lo.slot_seed == lo.S).any()
    t = torch.as_tensor
    maps, x, pmm_pk, pms_pk = ops._prep(lo, t(c["x"]), t(c["pmm"]),
                                          t(c["pms"]))
    a_pk = ops._pack_a(t(c["a"]), lo)
    h = kref.synth_fused_ref(a_pk, maps, x, pmm_pk, pms_pk, l_max=l_max,
                             layout=layout)
    empty = torch.as_tensor(lo.slot_seed == lo.S)
    assert bool((h[empty, 1] == 0).all()) and bool(h[:, 0].abs().sum() > 0)
    R = x.shape[0]
    f = torch.randn(lo.n_slots, 2, 1, R, 2 * K, generator=torch.Generator()
                    .manual_seed(0))
    if layout == "vpu":
        f = f.movedim(-1, 3).contiguous()
    out = kref.anal_fused_ref(f, maps, x, pmm_pk, pms_pk, l_max=l_max,
                              s_len=lo.S, layout=layout)
    dead = torch.as_tensor(lo.a_row < 0)
    assert bool((out[dead] == 0).all()) and bool((out[~dead] != 0).all())


def test_unported_fused_options_name_their_roadmap_item():
    c = case(8, 1, False)
    t = torch.as_tensor
    args = (c["m_vals"], t(c["x"]), t(c["pmm"]), t(c["pms"]))
    # the backward (item 4) is ported: it runs the analysis chain
    a = t(c["a"]).requires_grad_(True)
    fused.fused_synth(a, *args, **c["kw"]).sum().backward()
    assert a.grad.shape == a.shape and bool(torch.isfinite(a.grad).all())
    # the spin-2 row set (item 7) is ported: a spin layout's rows run the
    # spin chain, Q|U out as 2K channels; the fold stays refused for spin
    m2, mp2 = ops.spin_rows(c["m_vals"])
    g = c["g"]
    pmm2, pms2 = kref.prepare_seeds_spin(m2, mp2, g.cos_theta, g.sin_theta)
    a2 = np.concatenate([c["a"], c["a"]]) * (np.arange(9)[None, :] >= 2)[
        ..., None]
    qu = fused.fused_synth(t(a2.astype(np.float32)), m2, args[1], t(pmm2),
                           t(pms2), mp_vals=mp2, **c["kw"])
    assert qu.shape == (g.n_rings, c["kw"]["n"], 2)
    assert bool(torch.isfinite(qu).all()) and float(qu.abs().max()) > 0
    with pytest.raises(ValueError, match="fold"):
        fused.fused_synth(t(a2.astype(np.float32)), m2, args[1], t(pmm2),
                          t(pms2), mp_vals=mp2,
                          **dict(c["kw"], fold_rings=g.n_rings))
    # the bfloat16 contraction (item 6) is ported for the mxu variant; the
    # vpu variant has none and raises (ROADMAP check A)
    with pytest.raises(ValueError, match="no bfloat16 contraction"):
        fused.fused_anal(t(c["maps"]), c["g"].weights, *args, bf16=True,
                         **c["kw"])
    a32, a16 = (fused.fused_anal(t(c["maps"]), c["g"].weights, *args,
                                 variant="mxu", bf16=b, **c["kw"])
                for b in (False, True))
    assert 0 < rel(a16, a32) < 1e-2
    # the bucket rotation tables (item 8) are ported: one plane of
    # e^{+-i m phi0}, as the reference's
    tabs = fused._rotation_tables(c["m_vals"], "synth", phase_kind="bucket",
                                  n=None, phi0=c["kw"]["phi0"],
                                  fold_rings=None, n_half=0)
    np.testing.assert_array_equal(
        tabs, rfused._rotation_tables(c["m_vals"], "synth",
                                      phase_kind="bucket", n=None,
                                      phi0=c["kw"]["phi0"], fold_rings=None,
                                      n_half=0))


def test_fused_plan_lp_size_and_describe():
    """The panel length is the constant ``FUSED_LP_SIZE`` (make_plan takes
    no ``lp_size``); the default call and ``layout="fused"`` are one plan."""
    plan = repro_torch.make_plan("gl", 140, K=1, dtype="float32",
                                 device="cpu")
    assert repro_torch.make_plan("gl", 140, K=1, dtype="float32",
                                 layout="fused", device="cpu") is plan
    lo = plan._fused_layout()
    assert (lo.lp_size, lo.S) == (fused.FUSED_LP_SIZE, 256) == (128, 256)
    f = plan.describe()["fusion"]
    assert f == {"eligible": True, "reason": None, "skipped": None,
                 "lp_size": 128, "active": {"synth": True, "anal": True},
                 "pipelines": {"synth": "fused", "anal": "fused"}}
    assert "synth -> cuda_vpu[fused]" in plan.report()
    staged = repro_torch.make_plan("gl", 140, K=1, dtype="float32",
                                   layout="plain", device="cpu")
    assert staged is not plan
    assert staged.describe()["fusion"]["pipelines"] == {"synth": "staged",
                                                        "anal": "staged"}
    with pytest.raises(TypeError, match="lp_size"):
        repro_torch.make_plan("gl", 8, dtype="float32", lp_size=256,
                              device="cpu")
    with pytest.raises(ValueError):
        repro_torch.make_plan("gl", 8, dtype="float32", layout="fused",
                              mode="torch", device="cpu")


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_fused_plan_store_keeps_indices_and_skips_identity_tables(variant):
    """A fused plan keeps its pack/unpack index tensors in its own store,
    keyed by device type and index, and none on the shared layout object;
    the identity tables of an unfolded GL grid are skipped for both
    variants (stored as None)."""
    l_max = 12
    plan = repro_torch.make_plan("gl", l_max, K=1, dtype="float32",
                                 mode=f"cuda_{variant}", device="cpu")
    alm = alm_for(l_max, 1, seed=5)
    assert spectra.d_err(alm, plan.map2alm(plan.alm2map(alm))) < 1e-5
    store = plan._fused_store
    assert store[("tables", "synth")] is None
    assert store[("tables", "anal")] is None
    index = [k for k in store if isinstance(k, tuple) and k[0] == "index"]
    assert {k[1] for k in index} == {f"a{l_max + 1}", "rows", "row_dst",
                                     "alm_src"}
    assert all(k[2:] == ("cpu", None) for k in index)
    assert "_torch_index" not in vars(plan._fused_layout())


def test_port_imports_neither_jax_nor_the_reference():
    """The port package and chip_smoke.py import nothing of JAX or of
    ``repro``: a fresh interpreter with both blocked imports every module,
    runs a fused CPU round trip, serves two requests on the CPU, and runs
    a distributed round trip on a gloo group of one rank."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np, torch, repro_torch\n"
        "from repro_torch.kernels import fused, fused_cuda, legendre_cuda\n"
        "from repro_torch.core import sht, spectra\n"
        "import repro_torch.interop\n"
        "p = repro_torch.make_plan('gl', 8, K=1, dtype='float32',"
        " device='cpu')\n"
        "a = sht.random_alm(torch.Generator().manual_seed(0), 8, 8, 1,"
        " dtype=torch.float32, device='cpu')\n"
        "assert p.layouts['synth'] == 'fused'\n"
        "assert spectra.d_err(a, p.map2alm(p.alm2map(a))) < 1e-5\n"
        "import repro_torch.roofline.admission, repro_torch.launch.serve\n"
        "from repro_torch.serve import ShtEngine\n"
        "eng = ShtEngine(max_k=2, device='cpu', p99_target_s=60.0)\n"
        "futs = [eng.submit(direction='alm2map', grid='gl', l_max=8,\n"
        "                   dtype='float32', payload=a[..., 0].numpy())\n"
        "        for _ in range(2)]\n"
        "eng.drain()\n"
        "assert [f.result().shape for f in futs] == [(9, 18)] * 2\n"
        "assert eng.batch_log[0]['n_requests'] == 2\n"
        "import torch.distributed as dist\n"
        "from repro_torch.core import comm_model, dist_sht, plan\n"
        "dist.init_process_group('gloo', store=dist.HashStore(), rank=0,"
        " world_size=1)\n"
        "sp = plan.SHTPlan(p.grid, 8, 8, 1)\n"
        "d = dist_sht.DistSHT(sp, device='cpu', dtype='float32',"
        " stage1='plain', comm_chunks=2)\n"
        "back = sp.unpack_alm(d.map2alm(d.alm2map(sp.pack_alm(a))))\n"
        "assert spectra.d_err(a, back) < 1e-5\n"
        "dist.destroy_process_group()\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run([sys.executable, "-c", code, root], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for dirpath, _, files in os.walk(os.path.join(root, "src",
                                                  "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                assert "import jax" not in src and "from jax" not in src
                assert "from repro " not in src and "from repro." not in src
                assert "import repro\n" not in src
