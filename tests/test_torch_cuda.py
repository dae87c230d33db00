"""The CUDA kernels of the port on the card: each against its plain
version, determinism of the analysis reduction, and the launch counters
of a plan's main path, for the staged (``legendre_cuda``), the fused and
the packed (``fused_cuda``) kernels, and gradients through the plans of
every layout; then the same for the spin branch of every kernel and the
spin-2 plans.  Skipped without a CUDA device; run on the GPU with
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerance 5e-5 x max|plain|: kernel and plain version compute the
recurrence with the same correctly rounded operations and differ only in
how the sums round.
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import grids, legendre, spectra
from repro_torch.kernels import fused, fused_cuda, ops, pack
from repro_torch.kernels import legendre_cuda as lc
from repro_torch.kernels import ref as kref

pytestmark = pytest.mark.cuda

TOL = 5e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def operands(l_max, K, fold, dev, seed=0):
    g = grids.make_grid("gl", l_max=l_max)
    nh = (g.n_rings + 1) // 2
    m_vals = np.concatenate([np.arange(l_max + 1), [-1]])
    sin = g.sin_theta[:nh] if fold else g.sin_theta
    x = g.cos_theta[:nh] if fold else g.cos_theta
    pmm, pms = kref.prepare_seeds(m_vals, sin, legendre.log_mu(l_max))
    gen = torch.Generator().manual_seed(seed)
    L, Mp, R = l_max + 1, len(m_vals), len(x)
    keep = torch.as_tensor(np.arange(L)[None, :] >= m_vals[:, None])
    a = (torch.rand((Mp, L, 2 * K), generator=gen) * 2 - 1) * keep[..., None]
    dw = torch.rand((Mp, 2 if fold else 1, R, 2 * K), generator=gen) * 2 - 1
    t = lambda v, dt: torch.as_tensor(v, dtype=dt, device=dev)
    return (t(m_vals, torch.int32), t(x, torch.float32),
            t(pmm, torch.float32), t(pms, torch.int32), a.to(dev), dw.to(dev))


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("K", [1, 3, 8, 12])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_kernels_match_plain_versions(dev, variant, K, fold):
    l_max = 150
    m_t, x, pmm, pms, a, dw = operands(l_max, K, fold, dev, seed=K)
    got = getattr(lc, f"synth_{variant}")(a, m_t, x, pmm, pms, l_max=l_max,
                                          fold=fold)
    want = kref.synth_ref(a, m_t, x, pmm, pms, l_max=l_max, fold=fold)
    assert rel(got, want) < TOL and bool((got[-1] == 0).all())
    got = getattr(lc, f"anal_{variant}")(dw, m_t, x, pmm, pms, l_max=l_max,
                                         fold=fold)
    want = kref.anal_ref(dw, m_t, x, pmm, pms, l_max=l_max, fold=fold)
    assert rel(got, want) < TOL and bool((got[-1] == 0).all())


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_analysis_is_deterministic(dev, variant):
    """Many ring chunks, no atomics: repeated runs give identical bits."""
    l_max = 1100
    m_t, x, pmm, pms, _, dw = operands(l_max, 1, False, dev)
    anal = getattr(lc, f"anal_{variant}")
    first = anal(dw, m_t, x, pmm, pms, l_max=l_max)
    assert lc.ANAL_CHUNK[variant] < x.shape[0]
    for _ in range(3):
        assert torch.equal(anal(dw, m_t, x, pmm, pms, l_max=l_max), first)


def test_anal_reduce_matches_plain_version(dev):
    gen = torch.Generator().manual_seed(1)
    part = torch.rand((9, 5, 12, 6), generator=gen).to(dev)
    m_t = torch.tensor([0, 3, -1, 11, 2, 0, 5, -1, 7], dtype=torch.int32,
                       device=dev)
    got = lc.anal_reduce(part, m_t, l_max=11)
    assert rel(got, kref.anal_reduce_ref(part, m_t, l_max=11)) < 1e-6


@pytest.mark.parametrize("mode,K", [("cuda_vpu", 1), ("cuda_mxu", 8)])
def test_plan_main_path_launches_its_kernels(dev, mode, K):
    var = mode[5:]
    plan = repro_torch.make_plan("gl", 96, K=K, dtype="float32", mode=mode,
                                 layout="plain")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.core import sht
    alm = sht.random_alm(gen, 96, 96, K, dtype=torch.float32, device=dev)
    lc.reset_launches()
    back = plan.map2alm(plan.alm2map(alm))
    assert lc.launches[f"synth_{var}"] == 1
    assert lc.launches[f"anal_{var}"] == 1 and lc.launches["anal_reduce"] == 1
    assert back.device.type == "cuda"
    assert spectra.d_err(alm, back) < 1e-4


def fused_operands(l_max, K, fold, dev, seed=0):
    """Packed operands of one fused case: a layout over the rows 0..l_max
    with plan padding (so one slot has an empty segment 1), random
    non-identity rotation tables, coefficients and FFT rows."""
    m_vals = np.insert(np.arange(l_max + 1), 5, -1)
    m_t, x, pmm, pms, a, _ = operands(l_max, K, fold, dev, seed)
    m_t, pmm, pms, a = m_t[:-1], pmm[:-1], pms[:-1], a[:-1]
    keep = torch.as_tensor(m_vals >= 0, device=dev)
    idx = torch.as_tensor(np.maximum(m_vals, 0), device=dev)
    pmm, pms, a = (torch.where(keep[:, None], pmm[idx], 0),
                   torch.where(keep[:, None], pms[idx], 0),
                   torch.where(keep[:, None, None], a[idx], 0))
    lo = pack.build_layout(m_vals, l_max)
    maps, x, pmm_pk, pms_pk = ops._prep(lo, x, pmm, pms)
    gen = torch.Generator().manual_seed(seed + 1)
    P, R = (2 if fold else 1), x.shape[0]
    tab = (torch.rand((lo.n_slots, 2, P, 4, R), generator=gen) * 2 - 1)
    f = torch.rand((lo.n_slots, 2, P, R, 2 * K), generator=gen) * 2 - 1
    return (lo, maps, x, pmm_pk, pms_pk, ops._pack_a(a, lo).contiguous(),
            tab.to(dev), f.to(dev))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("K", [1, 3, 12])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_fused_kernels_match_plain_versions(dev, variant, K, fold):
    """Random tables (the rotation) and no tables (identity tables are
    skipped); the empty segment and the dead stream tail come out exactly
    zero."""
    l_max = 150
    lo, maps, x, pmm_pk, pms_pk, a_pk, tab, f = fused_operands(
        l_max, K, fold, dev, seed=K)
    empty = torch.as_tensor(lo.slot_seed == lo.S, device=dev)
    dead = torch.as_tensor(lo.a_row < 0, device=dev)
    fk = f.movedim(-1, 3).contiguous() if variant == "vpu" else f
    for t in (tab, None):
        synth = getattr(fused_cuda, f"synth_fused_{variant}")
        got = synth(a_pk, maps, x, pmm_pk, pms_pk, t, l_max=l_max, fold=fold)
        want = kref.synth_fused_ref(a_pk, maps, x, pmm_pk, pms_pk, t,
                                    l_max=l_max, fold=fold, layout=variant)
        assert rel(got, want) < TOL and bool((got[empty, 1] == 0).all())
        anal = getattr(fused_cuda, f"anal_fused_{variant}")
        got = anal(fk, maps, x, pmm_pk, pms_pk, t, l_max=l_max, s_len=lo.S)
        want = kref.anal_fused_ref(fk, maps, x, pmm_pk, pms_pk, t,
                                   l_max=l_max, s_len=lo.S, layout=variant)
        assert rel(got, want) < TOL and bool((got[dead] == 0).all())


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_fused_analysis_is_deterministic(dev, variant):
    """Many ring chunks, no atomics: repeated runs give identical bits."""
    l_max = 1100
    lo, maps, x, pmm_pk, pms_pk, _, tab, f = fused_operands(l_max, 1, False,
                                                            dev)
    fk = f.movedim(-1, 3).contiguous() if variant == "vpu" else f
    anal = getattr(fused_cuda, f"anal_fused_{variant}")
    first = anal(fk, maps, x, pmm_pk, pms_pk, tab, l_max=l_max, s_len=lo.S)
    assert lc.ANAL_CHUNK[variant] < x.shape[0]
    for _ in range(3):
        assert torch.equal(anal(fk, maps, x, pmm_pk, pms_pk, tab,
                                l_max=l_max, s_len=lo.S), first)


@pytest.mark.parametrize("mode,K,fold", [("cuda_vpu", 1, False),
                                         ("cuda_mxu", 8, True)])
def test_fused_plan_launches_fused_kernels_only(dev, mode, K, fold):
    var = mode[5:]
    plan = repro_torch.make_plan("gl", 96, K=K, dtype="float32", mode=mode,
                                 fold=fold)
    assert plan.layouts == {"synth": "fused", "anal": "fused"}
    gen = torch.Generator().manual_seed(0)
    from repro_torch.core import sht
    alm = sht.random_alm(gen, 96, 96, K, dtype=torch.float32, device=dev)
    lc.reset_launches()
    fused_cuda.reset_launches()
    back = plan.map2alm(plan.alm2map(alm))
    torch.cuda.synchronize()
    assert fused_cuda.launches[f"synth_fused_{var}"] == 1
    assert fused_cuda.launches[f"anal_fused_{var}"] == 1
    assert lc.launches["anal_reduce"] == 1
    assert all(lc.launches[k] == 0 for k in
               ("synth_vpu", "synth_mxu", "anal_vpu", "anal_mxu"))
    assert back.device.type == "cuda"
    assert spectra.d_err(alm, back) < 1e-4


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("K", [1, 3, 12])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_packed_kernels_match_plain_versions(dev, variant, K, fold):
    """Kernels 5-8 against their plain versions; the empty segment's planes
    and the dead stream tail exactly zero; with the fold off the packed
    kernels equal the fused ones without tables bit for bit."""
    l_max = 150
    lo, maps, x, pmm_pk, pms_pk, a_pk, _, _ = fused_operands(
        l_max, K, fold, dev, seed=K)
    P, R = (2 if fold else 1), x.shape[0]
    gen = torch.Generator().manual_seed(K + 7)
    dw = (torch.rand((lo.n_slots, 2 * P, R, 2 * K), generator=gen) * 2
          - 1).to(dev)
    dk = dw.movedim(-1, 2).contiguous() if variant == "vpu" else dw
    empty = torch.as_tensor(lo.slot_seed == lo.S, device=dev)
    dead = torch.as_tensor(lo.a_row < 0, device=dev)
    synth = getattr(fused_cuda, f"synth_packed_{variant}")
    got_s = synth(a_pk, maps, x, pmm_pk, pms_pk, l_max=l_max, fold=fold)
    want = kref.synth_packed_ref(a_pk, maps, x, pmm_pk, pms_pk, l_max=l_max,
                                 fold=fold, layout=variant)
    assert rel(got_s, want) < TOL
    assert bool((got_s[empty, P:] == 0).all())
    anal = getattr(fused_cuda, f"anal_packed_{variant}")
    got_a = anal(dk, maps, x, pmm_pk, pms_pk, l_max=l_max, s_len=lo.S)
    want = kref.anal_packed_ref(dk, maps, x, pmm_pk, pms_pk, l_max=l_max,
                                s_len=lo.S, layout=variant)
    assert rel(got_a, want) < TOL and bool((got_a[dead] == 0).all())
    if not fold:
        fs = getattr(fused_cuda, f"synth_fused_{variant}")(
            a_pk, maps, x, pmm_pk, pms_pk, None, l_max=l_max)
        assert torch.equal(got_s, fs.reshape(got_s.shape))
        fa = getattr(fused_cuda, f"anal_fused_{variant}")(
            dk.reshape(lo.n_slots, 2, 1, *dk.shape[2:]), maps, x, pmm_pk,
            pms_pk, None, l_max=l_max, s_len=lo.S)
        assert torch.equal(got_a, fa)


@pytest.mark.parametrize("mode,K,fold", [("cuda_vpu", 1, False),
                                         ("cuda_mxu", 8, True)])
def test_packed_plan_launches_packed_kernels_only(dev, mode, K, fold):
    var = mode[5:]
    plan = repro_torch.make_plan("gl", 96, K=K, dtype="float32", mode=mode,
                                 fold=fold, layout="packed")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.core import sht
    alm = sht.random_alm(gen, 96, 96, K, dtype=torch.float32, device=dev)
    lc.reset_launches()
    fused_cuda.reset_launches()
    back = plan.map2alm(plan.alm2map(alm))
    torch.cuda.synchronize()
    launched = {k: c for k, c in {**lc.launches, **fused_cuda.launches}
                .items() if c}
    assert launched == {f"synth_packed_{var}": 1, f"anal_packed_{var}": 1,
                        "anal_reduce": 1}
    assert spectra.d_err(alm, back) < 1e-4


@pytest.mark.parametrize("layout", ["plain", "packed", "fused"])
@pytest.mark.parametrize("mode,K", [("cuda_vpu", 1), ("cuda_mxu", 8)])
def test_gradients_on_card(dev, mode, K, layout):
    """The dot identity <A x, y> = <x, A^T y> through autograd within 2e-3
    (the reference's float32 band), and the backward of each direction
    launches the other direction's kernels of the same layout, once."""
    var = mode[5:]
    plan = repro_torch.make_plan("gl", 96, K=K, dtype="float32", mode=mode,
                                 layout=layout)
    from repro_torch.core import sht
    gen = torch.Generator().manual_seed(3)
    names = {"plain": (f"synth_{var}", f"anal_{var}"),
             "packed": (f"synth_packed_{var}", f"anal_packed_{var}"),
             "fused": (f"synth_fused_{var}", f"anal_fused_{var}")}[layout]
    a = sht.random_alm(gen, 96, 96, K, dtype=torch.float32,
                       device=dev).requires_grad_(True)
    t = torch.randn(plan._maps_shape, generator=gen).to(dev)
    lhs = (plan.alm2map(a) * t).sum()
    lc.reset_launches()
    fused_cuda.reset_launches()
    (g,) = torch.autograd.grad(lhs, a)
    torch.cuda.synchronize()
    launched = {k: c for k, c in {**lc.launches, **fused_cuda.launches}
                .items() if c}
    assert launched == {names[1]: 1, "anal_reduce": 1}
    a = a.detach()
    rhs = float((a.real * g.real + a.imag * g.imag).sum())
    assert abs(lhs.item() - rhs) < 2e-3 * abs(rhs)
    maps = t.clone().requires_grad_(True)
    b = sht.random_alm(gen, 96, 96, K, dtype=torch.float32, device=dev)
    out = plan.map2alm(maps)
    lhs = (out.real * b.real + out.imag * b.imag).sum()
    lc.reset_launches()
    fused_cuda.reset_launches()
    (g,) = torch.autograd.grad(lhs, maps)
    torch.cuda.synchronize()
    launched = {k: c for k, c in {**lc.launches, **fused_cuda.launches}
                .items() if c}
    assert launched == {names[0]: 1}
    assert abs(lhs.item() - float((t * g).sum())) < 2e-3 * abs(lhs.item())


# ---------------------------------------------------------------------------
# the spin branch (spin-2 plans): every kernel's Wigner-d rows
# ---------------------------------------------------------------------------


def spin_operands(l_max, K, dev, seed=0):
    """The 2M spin rows of l_max, the last made a padding row (so the live
    row count is odd), their seeds, and coefficients zero below
    l0 = max(m, |m'|); weighted Delta rows."""
    g = grids.make_grid("gl", l_max=l_max)
    m2, mp2 = ops.spin_rows(np.arange(l_max + 1))
    m2[-1] = -1
    pmm, pms = kref.prepare_seeds_spin(m2, mp2, g.cos_theta, g.sin_theta,
                                       m_max=l_max)
    gen = torch.Generator().manual_seed(seed)
    L, Mp, R = l_max + 1, len(m2), g.n_rings
    l0 = np.maximum(m2, np.abs(mp2))
    keep = torch.as_tensor((np.arange(L)[None, :] >= l0[:, None])
                           & (m2 >= 0)[:, None])
    a = (torch.rand((Mp, L, 2 * K), generator=gen) * 2 - 1) * keep[..., None]
    dw = torch.rand((Mp, 1, R, 2 * K), generator=gen) * 2 - 1
    t = lambda v, dt: torch.as_tensor(v, dtype=dt, device=dev)
    return dict(m=t(m2, torch.int32), mp=t(mp2, torch.int32),
                x=t(g.cos_theta, torch.float32), pmm=t(pmm, torch.float32),
                pms=t(pms, torch.int32), a=a.to(dev), dw=dw.to(dev),
                below=torch.as_tensor(np.arange(L)[None, :] < l0[:, None],
                                      device=dev), m2=m2, mp2=mp2)


@pytest.mark.parametrize("K", [1, 3, 8, 12])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_spin_kernels_match_plain_versions(dev, variant, K):
    """Kernels 1-4's spin branch against the plain versions with mp_vals;
    the analysis rows below l0 and the padding row exactly zero, and only
    the spin counters move."""
    l_max = 150
    c = spin_operands(l_max, K, dev, seed=K)
    args = (c["m"], c["x"], c["pmm"], c["pms"])
    kw = dict(l_max=l_max, mp_vals=c["mp"])
    lc.reset_launches()
    got = getattr(lc, f"synth_{variant}")(c["a"], *args, **kw)
    want = kref.synth_ref(c["a"], *args, **kw)
    assert rel(got, want) < TOL and bool((got[-1] == 0).all())
    got = getattr(lc, f"anal_{variant}")(c["dw"], *args, **kw)
    want = kref.anal_ref(c["dw"], *args, **kw)
    assert rel(got, want) < TOL and bool((got[-1] == 0).all())
    assert bool((got[c["below"]] == 0).all())
    assert {k: n for k, n in lc.launches.items() if n} == {
        f"synth_{variant}_spin": 1, f"anal_{variant}_spin": 1,
        "anal_reduce": 1}
    with pytest.raises(ValueError, match="fold"):
        lc.synth_vpu(c["a"], *args, fold=True, **kw)


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_spin_slot_kernels_match_plain_versions(dev, variant, K):
    """Kernels 9-12 (random tables and none) and 5-8 on the spin slot
    layout against their plain versions; empty segments and dead stream
    positions exactly zero; packed spin = fused spin without tables, bit
    for bit."""
    l_max = 150
    c = spin_operands(l_max, K, dev, seed=K + 1)
    lo = pack.build_layout(c["m2"], l_max, mp_vals=c["mp2"])
    assert lo.slot_seed.max() == lo.S            # the odd row: one empty seg
    maps, x, pmm_pk, pms_pk = ops._prep(lo, c["x"], c["pmm"], c["pms"])
    a_pk = ops._pack_a(c["a"], lo).contiguous()
    R = x.shape[0]
    gen = torch.Generator().manual_seed(K)
    tab = (torch.rand((lo.n_slots, 2, 1, 4, R), generator=gen) * 2 - 1).to(dev)
    f = (torch.rand((lo.n_slots, 2, 1, R, 2 * K), generator=gen) * 2
         - 1).to(dev)
    fk = f.movedim(-1, 3).contiguous() if variant == "vpu" else f
    empty = torch.as_tensor(lo.slot_seed == lo.S, device=dev)
    dead = torch.as_tensor(lo.a_row < 0, device=dev)
    skw = dict(l_max=l_max, spin=True)
    synth = getattr(fused_cuda, f"synth_fused_{variant}")
    anal = getattr(fused_cuda, f"anal_fused_{variant}")
    for t in (tab, None):
        got = synth(a_pk, maps, x, pmm_pk, pms_pk, t, **skw)
        want = kref.synth_fused_ref(a_pk, maps, x, pmm_pk, pms_pk, t,
                                    layout=variant, **skw)
        assert rel(got, want) < TOL and bool((got[empty, 1] == 0).all())
        got = anal(fk, maps, x, pmm_pk, pms_pk, t, s_len=lo.S, **skw)
        want = kref.anal_fused_ref(fk, maps, x, pmm_pk, pms_pk, t,
                                   s_len=lo.S, layout=variant, **skw)
        assert rel(got, want) < TOL and bool((got[dead] == 0).all())
    got_s = getattr(fused_cuda, f"synth_packed_{variant}")(
        a_pk, maps, x, pmm_pk, pms_pk, **skw)
    assert rel(got_s, kref.synth_packed_ref(
        a_pk, maps, x, pmm_pk, pms_pk, layout=variant, **skw)) < TOL
    assert torch.equal(got_s, synth(a_pk, maps, x, pmm_pk, pms_pk, None,
                                    **skw).reshape(got_s.shape))
    dk = fk.reshape(lo.n_slots, 2, *fk.shape[3:])
    got_a = getattr(fused_cuda, f"anal_packed_{variant}")(
        dk, maps, x, pmm_pk, pms_pk, s_len=lo.S, **skw)
    assert rel(got_a, kref.anal_packed_ref(
        dk, maps, x, pmm_pk, pms_pk, s_len=lo.S, layout=variant, **skw)) < TOL
    assert torch.equal(got_a, anal(fk, maps, x, pmm_pk, pms_pk, None,
                                   s_len=lo.S, **skw))


@pytest.mark.parametrize("layout", ["fused", "plain", "packed"])
@pytest.mark.parametrize("mode,K", [("cuda_vpu", 1), ("cuda_mxu", 8)])
def test_spin_plan_round_trip_anchor_and_launches(dev, mode, K, layout):
    """make_plan(spin=2) on the card: its round trip launches the spin
    branch of its layout's kernels and anal_reduce, once each and nothing
    else; d_err < 1e-4; within 1e-3 of the float64 torch spin plan."""
    var = mode[5:]
    l_max = 96
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                                 mode=mode, spin=2,
                                 layout=None if layout == "fused" else layout)
    assert plan.layouts == {"synth": layout, "anal": layout}
    from repro_torch.core import sht
    gen = torch.Generator().manual_seed(4)
    alm = sht.random_alm_spin(gen, l_max, l_max, K, device=dev)
    lc.reset_launches()
    fused_cuda.reset_launches()
    maps = plan.alm2map(alm.to(torch.complex64))
    back = plan.map2alm(maps)
    torch.cuda.synchronize()
    stem = {"plain": "", "packed": "_packed", "fused": "_fused"}[layout]
    launched = {k: c for k, c in {**lc.launches, **fused_cuda.launches}
                .items() if c}
    assert launched == {f"synth{stem}_{var}_spin": 1,
                        f"anal{stem}_{var}_spin": 1, "anal_reduce": 1}
    assert back.device.type == "cuda" and back.shape == alm.shape
    assert spectra.d_err(alm, back) < 1e-4
    p64 = repro_torch.make_plan("gl", l_max, K=K, dtype="float64",
                                mode="torch", spin=2)
    want = p64.alm2map(alm)
    assert rel(maps, want) < 1e-3
    assert rel(plan.map2alm(want.to(torch.float32)), p64.map2alm(want)) < 1e-3


@pytest.mark.parametrize("layout", ["plain", "packed", "fused"])
@pytest.mark.parametrize("mode,K", [("cuda_vpu", 1), ("cuda_mxu", 8)])
def test_spin_gradients_on_card(dev, mode, K, layout):
    """The spin-2 dot identity through autograd within 2e-3, and the
    backward of each direction launches the spin branch of the other
    direction's kernels of the same layout, once."""
    var = mode[5:]
    plan = repro_torch.make_plan("gl", 96, K=K, dtype="float32", mode=mode,
                                 layout=layout, spin=2)
    from repro_torch.core import sht
    gen = torch.Generator().manual_seed(5)
    stem = {"plain": "", "packed": "_packed", "fused": "_fused"}[layout]
    a = sht.random_alm_spin(gen, 96, 96, K, dtype=torch.float32,
                            device=dev).requires_grad_(True)
    t = torch.randn(plan._maps_shape, generator=gen).to(dev)
    lhs = (plan.alm2map(a) * t).sum()
    lc.reset_launches()
    fused_cuda.reset_launches()
    (g,) = torch.autograd.grad(lhs, a)
    torch.cuda.synchronize()
    launched = {k: c for k, c in {**lc.launches, **fused_cuda.launches}
                .items() if c}
    assert launched == {f"anal{stem}_{var}_spin": 1, "anal_reduce": 1}
    a = a.detach()
    rhs = float((a.real * g.real + a.imag * g.imag).sum())
    assert abs(lhs.item() - rhs) < 2e-3 * abs(rhs)
    maps = t.clone().requires_grad_(True)
    b = sht.random_alm_spin(gen, 96, 96, K, dtype=torch.float32, device=dev)
    out = plan.map2alm(maps)
    lhs = (out.real * b.real + out.imag * b.imag).sum()
    lc.reset_launches()
    fused_cuda.reset_launches()
    (g,) = torch.autograd.grad(lhs, maps)
    torch.cuda.synchronize()
    launched = {k: c for k, c in {**lc.launches, **fused_cuda.launches}
                .items() if c}
    assert launched == {f"synth{stem}_{var}_spin": 1}
    assert abs(lhs.item() - float((t * g).sum())) < 2e-3 * abs(lhs.item())


# ---------------------------------------------------------------------------
# the bfloat16 branch of kernels 10 and 12, and the ragged-grid paths
# ---------------------------------------------------------------------------

#: bf16 kernels vs their bf16 plain versions: both round the same float32
#: panel and rows to bfloat16 and form exact float32 products, so they
#: differ only in the order of the float32 sums (tensor-core accumulation
#: against a sequential one)
BF16_TOL = 1e-5


@pytest.mark.parametrize("spin", [False, True])
@pytest.mark.parametrize("K", [1, 3, 8, 12])
def test_bf16_kernels_match_plain_versions(dev, K, spin):
    """Kernels 10 and 12 with bf16=True against their bf16 plain versions
    at l_max 256, random tables and none, fold on and off (spin: off);
    the empty segment and dead stream positions exactly zero; only the
    bf16 counters move; the result differs from the float32 kernel."""
    l_max = 256
    sfx = "_spin" if spin else ""
    for fold in ((False,) if spin else (False, True)):
        if spin:
            c = spin_operands(l_max, K, dev, seed=K)
            lo = pack.build_layout(c["m2"], l_max, mp_vals=c["mp2"])
            maps, x, pmm_pk, pms_pk = ops._prep(lo, c["x"], c["pmm"],
                                                c["pms"])
            a_pk = ops._pack_a(c["a"], lo).contiguous()
            gen = torch.Generator().manual_seed(K)
            R = x.shape[0]
            tab = (torch.rand((lo.n_slots, 2, 1, 4, R), generator=gen) * 2
                   - 1).to(dev)
            f = (torch.rand((lo.n_slots, 2, 1, R, 2 * K), generator=gen) * 2
                 - 1).to(dev)
        else:
            lo, maps, x, pmm_pk, pms_pk, a_pk, tab, f = fused_operands(
                l_max, K, fold, dev, seed=K)
        empty = torch.as_tensor(lo.slot_seed == lo.S, device=dev)
        dead = torch.as_tensor(lo.a_row < 0, device=dev)
        kw = dict(l_max=l_max, spin=spin)
        for t in (tab, None):
            lc.reset_launches()
            fused_cuda.reset_launches()
            got = fused_cuda.synth_fused_mxu(a_pk, maps, x, pmm_pk, pms_pk,
                                             t, fold=fold, bf16=True, **kw)
            want = kref.synth_fused_ref(a_pk, maps, x, pmm_pk, pms_pk, t,
                                        fold=fold, bf16=True, **kw)
            assert rel(got, want) < BF16_TOL
            assert bool((got[empty, 1] == 0).all())
            f32 = fused_cuda.synth_fused_mxu(a_pk, maps, x, pmm_pk, pms_pk,
                                             t, fold=fold, **kw)
            assert 0 < rel(got, f32) < 1e-2
            got = fused_cuda.anal_fused_mxu(f, maps, x, pmm_pk, pms_pk, t,
                                            s_len=lo.S, bf16=True, **kw)
            want = kref.anal_fused_ref(f, maps, x, pmm_pk, pms_pk, t,
                                       s_len=lo.S, bf16=True, **kw)
            assert rel(got, want) < BF16_TOL
            assert bool((got[dead] == 0).all())
            torch.cuda.synchronize()
            launched = {k: c for k, c in {**lc.launches,
                                          **fused_cuda.launches}.items()
                        if c}
            assert launched == {f"synth_fused_mxu_bf16{sfx}": 1,
                                f"synth_fused_mxu{sfx}": 1,
                                f"anal_fused_mxu_bf16{sfx}": 1,
                                "anal_reduce": 1}


@pytest.mark.parametrize("spin", [0, 2])
def test_bf16_plan_gate_on_card(dev, spin):
    """The reference's gate on the card: 0 < err < 1e-2 against bf16=False,
    both directions, through Plan._make_fused_*("mxu", bf16=True)."""
    from repro_torch.core import sht
    plan = repro_torch.make_plan("gl", 256, K=8, dtype="float32", spin=spin)
    gen = torch.Generator().manual_seed(6)
    draw = sht.random_alm_spin if spin else sht.random_alm
    alm = draw(gen, 256, 256, 8, dtype=torch.float32, device=dev)
    m32 = plan._make_fused_synth("mxu")(alm)
    m16 = plan._make_fused_synth("mxu", bf16=True)(alm)
    assert 0 < rel(m16, m32) < 1e-2
    a32 = plan._make_fused_anal("mxu")(m32)
    a16 = plan._make_fused_anal("mxu", bf16=True)(m32)
    assert 0 < rel(a16, a32) < 1e-2


@pytest.mark.parametrize("layout", ["fused", "plain", "packed"])
@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("mode,K", [("cuda_vpu", 1), ("cuda_mxu", 8)])
def test_healpix_plan_on_card(dev, mode, K, spin, layout):
    """A HEALPix plan (nside 64) on the card against the same plan on the
    CPU (the kernels' plain versions, same bucket engine) within 5e-5,
    both directions; the same bits on a second call; its layout's kernels
    and anal_reduce launched once each, nothing else."""
    var = mode[5:]
    kw = dict(nside=64, K=K, dtype="float32", mode=mode, spin=spin,
              layout=layout)
    plan = repro_torch.make_plan("healpix", **kw)
    cpu = repro_torch.make_plan("healpix", device="cpu", **kw)
    rng = np.random.default_rng(spin)
    shp = plan._alm_shape
    a = (rng.uniform(-1, 1, shp) + 1j * rng.uniform(-1, 1, shp)) \
        * (np.arange(plan.l_max + 1)[None, :] >= np.maximum(
            np.arange(plan.m_max + 1), spin)[:, None])[..., None]
    a = torch.as_tensor(a.astype(np.complex64))
    lc.reset_launches()
    fused_cuda.reset_launches()
    maps = plan.alm2map(a.to(dev))
    back = plan.map2alm(maps)
    torch.cuda.synchronize()
    stem = {"plain": "", "packed": "_packed", "fused": "_fused"}[layout]
    sfx = "_spin" if spin else ""
    launched = {k: c for k, c in {**lc.launches, **fused_cuda.launches}
                .items() if c}
    assert launched == {f"synth{stem}_{var}{sfx}": 1,
                        f"anal{stem}_{var}{sfx}": 1, "anal_reduce": 1}
    assert rel(maps.cpu(), cpu.alm2map(a)) < TOL
    assert rel(back.cpu(), cpu.map2alm(maps.cpu())) < TOL
    assert torch.equal(plan.alm2map(a.to(dev)), maps)
    assert torch.equal(plan.map2alm(maps), back)


# ---------------------------------------------------------------------------
# anal_reduce's vector kernel and the vpu analysis template of kernels 11/7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,K2,n_ch", [(13, 3, 5), (13, 2, 3), (12, 2, 4),
                                       (9, 6, 1)])
@pytest.mark.parametrize("route", ["plain", "spin", "slot", "slot spin",
                                   "unaligned"])
def test_anal_reduce_equals_a_chunk_order_loop(dev, route, L, K2, n_ch):
    """anal_reduce adds the chunks in chunk order from 0.0f, as a loop of
    float32 additions does: equal bit for bit, on the plain route (rows
    below l0 = m, or max(m, |m'|), and padding rows exact zeros) and the
    slot route (each slot's stream kept up to its live end past both
    segments, zeros after, unread), at (l, c) stretches of L 2K floats that
    take 4-, 2- and 1-float vectors, and from a buffer whose start is not
    16-byte aligned."""
    gen = torch.Generator().manual_seed(L * K2 + n_ch)
    m = np.array([0, 3, -1, L - 1, 2, 0, 5, -1, 7, 1]) % L
    m[[2, 7]] = -1
    mp = np.where(np.arange(len(m)) % 2, 2, -2)
    shape = (len(m), n_ch, L, K2)
    n = int(np.prod(shape))
    buf = (torch.rand(n + 1, generator=gen) * 2 - 1).to(dev)
    part = (buf[1:] if route == "unaligned" else buf[:n]).view(shape)
    assert part.is_contiguous()
    t = lambda v: torch.as_tensor(v, dtype=torch.int32, device=dev)
    want = torch.zeros((len(m), L, K2), device=dev)
    for ch in range(n_ch):
        want = want + part[:, ch]
    l = np.arange(L)[None, :]
    if route.startswith("slot"):
        # band limit L - 3: segment 0 (m0) then segment 1 (m1) from seed;
        # the last slot has no segment 1 (seed == S == L)
        l_max, spin = L - 3, route.endswith("spin")
        m0 = np.arange(len(m)) % (l_max + 1)
        m1 = l_max - m0
        lz = (lambda mm, pp: np.maximum(mm, np.abs(pp))) if spin else \
            (lambda mm, pp: mm)
        seed = l_max + 1 - lz(m0, mp)
        seed[-1] = L
        end = np.where(seed < L, seed + l_max + 1 - lz(m1, -mp),
                       l_max + 1 - lz(m0, mp))
        got = lc.anal_reduce(part, None, l_max=l_max, slot_maps=(
            t(m0), t(m1), t(mp) if spin else None,
            t(-mp) if spin else None, t(seed)))
        keep = l < end[:, None]
    else:
        spin = route == "spin"
        got = lc.anal_reduce(part, t(m), l_max=L - 1,
                             mp_vals=t(mp) if spin else None)
        l0 = np.maximum(m, np.abs(mp)) if spin else m
        keep = (m[:, None] >= 0) & (l >= l0[:, None])
    want = torch.where(torch.as_tensor(keep, device=dev)[..., None], want,
                       0.0)
    assert torch.equal(got, want)
    if route == "plain":
        assert torch.equal(lc.anal_reduce(part, t(m), l_max=L - 1), got)


def _vpu_template_check(dev, f_pk, maps, x, pmm_pk, pms_pk, tab, lo, l_max,
                        spin):
    """Kernel 11 (with ``tab``) and kernel 7 (planes as given, no tables)
    on one set of operands: each within TOL of its plain version, dead
    positions exactly zero, the same bits on a rerun."""
    fk = f_pk.movedim(-1, 3).contiguous()
    dead = torch.as_tensor(lo.a_row < 0, device=dev)
    kw = dict(l_max=l_max, s_len=lo.S, spin=spin)
    got = fused_cuda.anal_fused_vpu(fk, maps, x, pmm_pk, pms_pk, tab, **kw)
    want = kref.anal_fused_ref(fk, maps, x, pmm_pk, pms_pk, tab,
                               layout="vpu", **kw)
    assert rel(got, want) < TOL and bool((got[dead] == 0).all())
    assert torch.equal(fused_cuda.anal_fused_vpu(fk, maps, x, pmm_pk, pms_pk,
                                                 tab, **kw), got)
    dk = fk.reshape(lo.n_slots, -1, *fk.shape[3:])
    got = fused_cuda.anal_packed_vpu(dk, maps, x, pmm_pk, pms_pk, **kw)
    want = kref.anal_packed_ref(dk, maps, x, pmm_pk, pms_pk, layout="vpu",
                                **kw)
    assert rel(got, want) < TOL and bool((got[dead] == 0).all())
    assert torch.equal(fused_cuda.anal_packed_vpu(dk, maps, x, pmm_pk,
                                                  pms_pk, **kw), got)


@pytest.mark.parametrize("tables", ["random", "none"])
@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("spin,fold", [(0, False), (0, True), (2, False)])
def test_vpu_analysis_template_matches_plain_versions(dev, spin, fold, K,
                                                      tables):
    """Kernels 11 and 7 at l_max 256 against their plain versions: spin 0
    with the fold off and on, spin 2, one and two maps per block (K 3 runs
    both), random rotation tables and none; identical bits on a rerun."""
    l_max = 256
    lo, maps, x, pmm_pk, pms_pk, f, tab = _slot_operands(
        l_max, K, bool(spin), fold, dev, 10 * K + spin)
    _vpu_template_check(dev, f, maps, x, pmm_pk, pms_pk,
                        tab if tables == "random" else None, lo, l_max,
                        bool(spin))


@pytest.mark.parametrize("K", [1, 2, 3])
def test_vpu_analysis_template_with_bucket_tables(dev, K):
    """Kernels 11 and 7 on a HEALPix nside 64 plan's own seeds, layout and
    bucket rotation tables (kernel 11 applies them in-kernel) against
    their plain versions; identical bits on a rerun."""
    plan = repro_torch.make_plan("healpix", nside=64, K=K, dtype="float32",
                                 mode="cuda_vpu")
    assert plan.layouts["anal"] == "fused"
    a = torch.zeros(plan._alm_shape, dtype=torch.complex64, device=dev)
    plan.map2alm(plan.alm2map(a))                # fills the plan's store
    _, kw, _ = plan._fused_parts("vpu", False)
    store = kw["store"]
    maps, x, pmm_pk, pms_pk = store["prep"]
    tab = store[("tables", "anal")]
    assert tab is not None
    gen = torch.Generator().manual_seed(K)
    f = (torch.rand((kw["lo"].n_slots, 2, 1, x.shape[0], 2 * K),
                    generator=gen) * 2 - 1).to(dev)
    _vpu_template_check(dev, f, maps, x, pmm_pk, pms_pk, tab, kw["lo"],
                        plan.l_max, False)


@pytest.mark.parametrize("rings", [1025, 2049])
def test_vpu_analysis_template_one_ring_past_a_chunk(dev, rings):
    """R one ring past a multiple of the 1024-ring chunk: the last chunk's
    block carries a single live ring tile.  Kernels 11 and 7 against their
    plain versions at l_max 256 (random tables), identical bits on a
    rerun."""
    l_max = 256
    g = grids.make_grid("gl", l_max=rings - 1)
    assert g.n_rings == rings and rings % lc.ANAL_CHUNK["vpu"] == 1
    m_vals = np.insert(np.arange(l_max + 1), 5, -1)
    pmm, pms = kref.prepare_seeds(m_vals, g.sin_theta, legendre.log_mu(l_max))
    t = lambda v, dt: torch.as_tensor(v, dtype=dt, device=dev)
    lo = pack.build_layout(m_vals, l_max)
    maps, x, pmm_pk, pms_pk = ops._prep(
        lo, t(g.cos_theta, torch.float32), t(pmm, torch.float32),
        t(pms, torch.int32))
    gen = torch.Generator().manual_seed(rings)
    f = (torch.rand((lo.n_slots, 2, 1, rings, 2), generator=gen) * 2
         - 1).to(dev)
    tab = (torch.rand((lo.n_slots, 2, 1, 4, rings), generator=gen) * 2
           - 1).to(dev)
    _vpu_template_check(dev, f, maps, x, pmm_pk, pms_pk, tab, lo, l_max,
                        False)


def _slot_synth_check(dev, a_pk, maps, x, pmm_pk, pms_pk, tab, lo, l_max,
                     fold, spin, var="vpu"):
    """Kernel 9 (with ``tab``) and kernel 5 (planes kept apart, no tables)
    on one set of operands, or with ``var="mxu"`` kernels 10 and 6: each
    within TOL of its plain version, the empty segment's planes exactly
    zero, the same bits on a rerun; with the fold off the packed kernel
    equals the fused one without tables bit for bit."""
    empty = torch.as_tensor(lo.slot_seed == lo.S, device=dev)
    kw = dict(l_max=l_max, fold=fold, spin=spin)
    fused_k = getattr(fused_cuda, f"synth_fused_{var}")
    packed_k = getattr(fused_cuda, f"synth_packed_{var}")
    got = fused_k(a_pk, maps, x, pmm_pk, pms_pk, tab, **kw)
    want = kref.synth_fused_ref(a_pk, maps, x, pmm_pk, pms_pk, tab,
                                layout=var, **kw)
    assert rel(got, want) < TOL and bool((got[empty, 1] == 0).all())
    assert torch.equal(fused_k(a_pk, maps, x, pmm_pk, pms_pk, tab, **kw),
                       got)
    got = packed_k(a_pk, maps, x, pmm_pk, pms_pk, **kw)
    want = kref.synth_packed_ref(a_pk, maps, x, pmm_pk, pms_pk, layout=var,
                                 **kw)
    P = 2 if fold else 1
    assert rel(got, want) < TOL and bool((got[empty, P:] == 0).all())
    assert torch.equal(packed_k(a_pk, maps, x, pmm_pk, pms_pk, **kw), got)
    if not fold:
        fs = fused_k(a_pk, maps, x, pmm_pk, pms_pk, None, **kw)
        assert torch.equal(got, fs.reshape(got.shape))


def _random_a_pk(lo, K, seed, dev):
    """Random packed coefficients (n_slots, S, 2K), dead positions zero."""
    gen = torch.Generator().manual_seed(seed)
    a_pk = torch.rand((lo.n_slots, lo.S, 2 * K), generator=gen) * 2 - 1
    a_pk[torch.as_tensor(lo.a_row < 0)] = 0.0
    return a_pk.to(dev)


@pytest.mark.parametrize("tables", ["random", "none"])
@pytest.mark.parametrize("K", [1, 2, 3, 7])
@pytest.mark.parametrize("spin,fold", [(0, False), (0, True), (2, False)])
def test_vpu_synthesis_template_matches_plain_versions(dev, spin, fold, K,
                                                       tables):
    """Kernels 9 and 5 at l_max 256 against their plain versions: spin 0
    with the fold off and on, spin 2, map chunks of 1, 2, 4 and 8 (4 rings
    a thread at 1 and 2, 2 at 4, 1 at 8; K 3 and 7 leave part of the chunk
    idle), random rotation tables and none; identical bits on a rerun."""
    l_max = 256
    if spin:
        c = spin_operands(l_max, K, dev, seed=K)
        lo = pack.build_layout(c["m2"], l_max, mp_vals=c["mp2"])
        maps, x, pmm_pk, pms_pk = ops._prep(lo, c["x"], c["pmm"], c["pms"])
        a_pk = ops._pack_a(c["a"], lo).contiguous()
    else:
        lo, maps, x, pmm_pk, pms_pk, a_pk, _, _ = fused_operands(
            l_max, K, fold, dev, seed=K)
    P, R = (2 if fold else 1), x.shape[0]
    gen = torch.Generator().manual_seed(10 * K + spin + 1)
    tab = (torch.rand((lo.n_slots, 2, P, 4, R), generator=gen) * 2
           - 1).to(dev) if tables == "random" else None
    _slot_synth_check(dev, a_pk, maps, x, pmm_pk, pms_pk, tab, lo, l_max,
                     fold, bool(spin))


@pytest.mark.parametrize("K", [1, 2, 3, 7])
def test_vpu_synthesis_template_with_bucket_tables(dev, K):
    """Kernels 9 and 5 on a HEALPix nside 64 plan's own seeds, layout and
    bucket rotation tables (kernel 9 applies them in-kernel) against their
    plain versions; identical bits on a rerun."""
    plan = repro_torch.make_plan("healpix", nside=64, K=K, dtype="float32",
                                 mode="cuda_vpu")
    assert plan.layouts["synth"] == "fused"
    a = torch.zeros(plan._alm_shape, dtype=torch.complex64, device=dev)
    plan.map2alm(plan.alm2map(a))                # fills the plan's store
    _, kw, _ = plan._fused_parts("vpu", False)
    lo, store = kw["lo"], kw["store"]
    maps, x, pmm_pk, pms_pk = store["prep"]
    tab = store[("tables", "synth")]
    assert tab is not None
    _slot_synth_check(dev, _random_a_pk(lo, K, K, dev), maps, x, pmm_pk,
                     pms_pk, tab, lo, plan.l_max, tab.shape[2] == 2, False)


@pytest.mark.parametrize("K", [1, 3, 7])
@pytest.mark.parametrize("rings", [1025, 2049])
def test_vpu_synthesis_template_one_ring_past_a_block(dev, rings, K):
    """R one ring past a multiple of the ring block (512, 256 or 128 rings
    at map chunks 1, 4 and 8): the last block carries a single live ring.
    Kernels 9 and 5 against their plain versions at l_max 256 (random
    tables), identical bits on a rerun."""
    l_max = 256
    g = grids.make_grid("gl", l_max=rings - 1)
    assert g.n_rings == rings and rings % 512 == 1
    m_vals = np.insert(np.arange(l_max + 1), 5, -1)
    pmm, pms = kref.prepare_seeds(m_vals, g.sin_theta, legendre.log_mu(l_max))
    t = lambda v, dt: torch.as_tensor(v, dtype=dt, device=dev)
    lo = pack.build_layout(m_vals, l_max)
    maps, x, pmm_pk, pms_pk = ops._prep(
        lo, t(g.cos_theta, torch.float32), t(pmm, torch.float32),
        t(pms, torch.int32))
    gen = torch.Generator().manual_seed(rings)
    tab = (torch.rand((lo.n_slots, 2, 1, 4, rings), generator=gen) * 2
           - 1).to(dev)
    _slot_synth_check(dev, _random_a_pk(lo, K, rings, dev), maps, x, pmm_pk,
                     pms_pk, tab, lo, l_max, False, False)


def _anal_vpu_check(dw, m_t, x, pmm, pms, l_max, fold, mp_t=None):
    """Kernel 3 through anal_reduce: within TOL of its plain version, the
    padding rows (m < 0) exact zeros, the same bits on a rerun."""
    kw = dict(l_max=l_max, fold=fold, mp_vals=mp_t)
    got = lc.anal_vpu(dw, m_t, x, pmm, pms, **kw)
    want = kref.anal_ref(dw, m_t, x, pmm, pms, **kw)
    assert rel(got, want) < TOL and bool((got[m_t < 0] == 0).all())
    assert torch.equal(lc.anal_vpu(dw, m_t, x, pmm, pms, **kw), got)
    return got


@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("spin,fold", [(0, False), (0, True), (2, False)])
def test_anal_vpu_template_matches_plain_version(dev, spin, fold, K):
    """Kernel 3 at l_max 256 on the plain layout against its plain version:
    spin 0 with the fold off and on, spin 2 (rows below l0 exact zeros),
    channel chunks of 2 (K 1) and 4 (K 2; K 3 runs both)."""
    l_max = 256
    if spin:
        c = spin_operands(l_max, K, dev, seed=K)
        got = _anal_vpu_check(c["dw"], c["m"], c["x"], c["pmm"], c["pms"],
                              l_max, False, c["mp"])
        assert bool((got[c["below"]] == 0).all())
    else:
        m_t, x, pmm, pms, _, dw = operands(l_max, K, fold, dev, seed=K)
        _anal_vpu_check(dw, m_t, x, pmm, pms, l_max, fold)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_anal_vpu_template_on_a_healpix_plan(dev, K):
    """Kernel 3 on a plain-layout HEALPix nside 64 plan's own rows and seeds
    against its plain version; identical bits on a rerun."""
    plan = repro_torch.make_plan("healpix", nside=64, K=K, dtype="float32",
                                 mode="cuda_vpu", layout="plain")
    m_t, x, pmm, pms, _ = plan._row_seeds()
    P = 2 if plan.fold else 1
    gen = torch.Generator().manual_seed(K)
    dw = (torch.rand((m_t.shape[0], P, x.shape[0], 2 * K), generator=gen)
          * 2 - 1).to(dev)
    _anal_vpu_check(dw, m_t, x, pmm, pms, plan.l_max, plan.fold)


@pytest.mark.parametrize("rings", [1025, 2049])
def test_anal_vpu_template_one_ring_past_a_chunk(dev, rings):
    """R one ring past a multiple of the 1024-ring chunk: the last chunk's
    block carries a single live ring tile.  Kernel 3 against its plain
    version at l_max 256 with a padding row, identical bits on a rerun."""
    l_max = 256
    g = grids.make_grid("gl", l_max=rings - 1)
    assert g.n_rings == rings and rings % lc.ANAL_CHUNK["vpu"] == 1
    m_vals = np.insert(np.arange(l_max + 1), 5, -1)
    pmm, pms = kref.prepare_seeds(m_vals, g.sin_theta, legendre.log_mu(l_max))
    t = lambda v, dt: torch.as_tensor(v, dtype=dt, device=dev)
    gen = torch.Generator().manual_seed(rings)
    dw = (torch.rand((len(m_vals), 1, rings, 2), generator=gen) * 2
          - 1).to(dev)
    _anal_vpu_check(dw, t(m_vals, torch.int32), t(g.cos_theta, torch.float32),
                    t(pmm, torch.float32), t(pms, torch.int32), l_max, False)


# ---------------------------------------------------------------------------
# the mxu analysis template (csrc/mxu_anal.cuh): kernels 12 and 8 on the
# slot layout, kernel 4 on the plain one
# ---------------------------------------------------------------------------


def _mxu_template_check(dev, f, maps, x, pmm_pk, pms_pk, tab, lo, l_max,
                        spin):
    """Kernel 12 (with ``tab``) and kernel 8 (planes as given, no tables)
    on one set of operands: each within TOL of its plain version, dead
    positions exactly zero, the same bits on a rerun."""
    dead = torch.as_tensor(lo.a_row < 0, device=dev)
    kw = dict(l_max=l_max, s_len=lo.S, spin=spin)
    got = fused_cuda.anal_fused_mxu(f, maps, x, pmm_pk, pms_pk, tab, **kw)
    want = kref.anal_fused_ref(f, maps, x, pmm_pk, pms_pk, tab,
                               layout="mxu", **kw)
    assert rel(got, want) < TOL and bool((got[dead] == 0).all())
    assert torch.equal(fused_cuda.anal_fused_mxu(f, maps, x, pmm_pk, pms_pk,
                                                 tab, **kw), got)
    dk = f.reshape(lo.n_slots, -1, *f.shape[3:])
    got = fused_cuda.anal_packed_mxu(dk, maps, x, pmm_pk, pms_pk, **kw)
    want = kref.anal_packed_ref(dk, maps, x, pmm_pk, pms_pk, layout="mxu",
                                **kw)
    assert rel(got, want) < TOL and bool((got[dead] == 0).all())
    assert torch.equal(fused_cuda.anal_packed_mxu(dk, maps, x, pmm_pk,
                                                  pms_pk, **kw), got)


def _slot_operands(l_max, K, spin, fold, dev, seed):
    """A slot layout of the rows 0..l_max (spin: the 2M spin rows), its
    packed seeds, and random FFT rows (n_slots, 2, P, R, 2K)."""
    if spin:
        c = spin_operands(l_max, K, dev, seed=K)
        lo = pack.build_layout(c["m2"], l_max, mp_vals=c["mp2"])
        maps, x, pmm_pk, pms_pk = ops._prep(lo, c["x"], c["pmm"], c["pms"])
    else:
        lo, maps, x, pmm_pk, pms_pk, _, _, _ = fused_operands(
            l_max, K, fold, dev, seed=K)
    gen = torch.Generator().manual_seed(seed)
    P, R = (2 if fold else 1), x.shape[0]
    f = (torch.rand((lo.n_slots, 2, P, R, 2 * K), generator=gen) * 2
         - 1).to(dev)
    tab = (torch.rand((lo.n_slots, 2, P, 4, R), generator=gen) * 2
           - 1).to(dev)
    return lo, maps, x, pmm_pk, pms_pk, f, tab


@pytest.mark.parametrize("tables", ["random", "none"])
@pytest.mark.parametrize("K", [1, 3, 8, 9])
@pytest.mark.parametrize("spin,fold", [(0, False), (0, True), (2, False)])
def test_mxu_analysis_template_matches_plain_versions(dev, spin, fold, K,
                                                      tables):
    """Kernels 12 and 8 at l_max 256 against their plain versions, within
    TOL = 5e-5 x max|plain| (the same rounded recurrence, other sum
    orders): spin 0 with the fold off (32-l panels) and on (16-l panels),
    spin 2, map chunks of 1, 4 and 8 (K 3 leaves part of its chunk idle, K
    9 runs two chunks), random rotation tables and none; every row's last
    panel is short (257 - m rows); identical bits on a rerun."""
    l_max = 256
    lo, maps, x, pmm_pk, pms_pk, f, tab = _slot_operands(
        l_max, K, bool(spin), fold, dev, 10 * K + spin)
    _mxu_template_check(dev, f, maps, x, pmm_pk, pms_pk,
                        tab if tables == "random" else None, lo, l_max,
                        bool(spin))


@pytest.mark.parametrize("K", [3, 8])
def test_mxu_analysis_template_with_bucket_tables(dev, K):
    """Kernels 12 and 8 on a HEALPix nside 64 plan's own seeds, layout and
    bucket rotation tables (kernel 12 applies them in-kernel) against
    their plain versions within TOL; identical bits on a rerun."""
    plan = repro_torch.make_plan("healpix", nside=64, K=K, dtype="float32",
                                 mode="cuda_mxu")
    assert plan.layouts["anal"] == "fused"
    a = torch.zeros(plan._alm_shape, dtype=torch.complex64, device=dev)
    plan.map2alm(plan.alm2map(a))                # fills the plan's store
    _, kw, _ = plan._fused_parts("mxu", False)
    store = kw["store"]
    maps, x, pmm_pk, pms_pk = store["prep"]
    tab = store[("tables", "anal")]
    assert tab is not None
    gen = torch.Generator().manual_seed(K)
    f = (torch.rand((kw["lo"].n_slots, 2, 1, x.shape[0], 2 * K),
                    generator=gen) * 2 - 1).to(dev)
    _mxu_template_check(dev, f, maps, x, pmm_pk, pms_pk, tab, kw["lo"],
                        plan.l_max, False)


def _one_past_a_chunk(rings, dev):
    """Rows 0..256 with a padding row on a GL grid of ``rings`` rings, one
    ring past a multiple of the 512-ring mxu chunk: (m_vals, x, pmm,
    pms) as CUDA tensors."""
    l_max = 256
    g = grids.make_grid("gl", l_max=rings - 1)
    assert g.n_rings == rings and rings % lc.ANAL_CHUNK["mxu"] == 1
    m_vals = np.insert(np.arange(l_max + 1), 5, -1)
    pmm, pms = kref.prepare_seeds(m_vals, g.sin_theta, legendre.log_mu(l_max))
    t = lambda v, dt: torch.as_tensor(v, dtype=dt, device=dev)
    return (t(m_vals, torch.int32), t(g.cos_theta, torch.float32),
            t(pmm, torch.float32), t(pms, torch.int32))


@pytest.mark.parametrize("rings", [513, 1025])
def test_mxu_analysis_template_one_ring_past_a_chunk(dev, rings):
    """R one ring past a multiple of the 512-ring chunk: the last chunk's
    block builds a single ring quad.  Kernels 12 and 8 at K 8 against
    their plain versions within TOL at l_max 256 (random tables),
    identical bits on a rerun."""
    m_t, x, pmm, pms = _one_past_a_chunk(rings, dev)
    lo = pack.build_layout(m_t.cpu().numpy(), 256)
    maps, x, pmm_pk, pms_pk = ops._prep(lo, x, pmm, pms)
    gen = torch.Generator().manual_seed(rings)
    f = (torch.rand((lo.n_slots, 2, 1, rings, 16), generator=gen) * 2
         - 1).to(dev)
    tab = (torch.rand((lo.n_slots, 2, 1, 4, rings), generator=gen) * 2
           - 1).to(dev)
    _mxu_template_check(dev, f, maps, x, pmm_pk, pms_pk, tab, lo, 256,
                        False)


@pytest.mark.parametrize("spin,fold", [(0, False), (0, True), (2, False)])
def test_mxu_analysis_template_bf16(dev, spin, fold):
    """Kernel 12's bf16 instantiation on the template's panel at K 8, l_max
    256, random tables: within BF16_TOL = 1e-5 of its bf16 plain version
    (both form exact bf16 products; only the float32 sums' order
    differs), 0 < err < 1e-2 against the float32 kernel (the reference's
    gate), dead positions exactly zero, identical bits on a rerun."""
    l_max = 256
    lo, maps, x, pmm_pk, pms_pk, f, tab = _slot_operands(
        l_max, 8, bool(spin), fold, dev, 7 + spin)
    dead = torch.as_tensor(lo.a_row < 0, device=dev)
    kw = dict(l_max=l_max, s_len=lo.S, spin=bool(spin))
    got = fused_cuda.anal_fused_mxu(f, maps, x, pmm_pk, pms_pk, tab,
                                    bf16=True, **kw)
    want = kref.anal_fused_ref(f, maps, x, pmm_pk, pms_pk, tab, bf16=True,
                               **kw)
    assert rel(got, want) < BF16_TOL and bool((got[dead] == 0).all())
    f32 = fused_cuda.anal_fused_mxu(f, maps, x, pmm_pk, pms_pk, tab, **kw)
    assert 0 < rel(got, f32) < 1e-2
    assert torch.equal(fused_cuda.anal_fused_mxu(
        f, maps, x, pmm_pk, pms_pk, tab, bf16=True, **kw), got)


def _anal_mxu_check(dw, m_t, x, pmm, pms, l_max, fold, mp_t=None):
    """Kernel 4 through anal_reduce: within TOL of its plain version, the
    padding rows (m < 0) exact zeros, the same bits on a rerun."""
    kw = dict(l_max=l_max, fold=fold, mp_vals=mp_t)
    got = lc.anal_mxu(dw, m_t, x, pmm, pms, **kw)
    want = kref.anal_ref(dw, m_t, x, pmm, pms, **kw)
    assert rel(got, want) < TOL and bool((got[m_t < 0] == 0).all())
    assert torch.equal(lc.anal_mxu(dw, m_t, x, pmm, pms, **kw), got)
    return got


@pytest.mark.parametrize("K", [1, 3, 8, 9])
@pytest.mark.parametrize("spin,fold", [(0, False), (0, True), (2, False)])
def test_anal_mxu_template_matches_plain_version(dev, spin, fold, K):
    """Kernel 4 at l_max 256 on the plain layout against its plain version
    within TOL: spin 0 with the fold off and on, spin 2 (rows below l0
    exact zeros), channel chunks of 2, 8 and 16 (K 3 leaves part of its
    chunk idle, K 9 runs a chunk of 16 and one of 2)."""
    l_max = 256
    if spin:
        c = spin_operands(l_max, K, dev, seed=K)
        got = _anal_mxu_check(c["dw"], c["m"], c["x"], c["pmm"], c["pms"],
                              l_max, False, c["mp"])
        assert bool((got[c["below"]] == 0).all())
    else:
        m_t, x, pmm, pms, _, dw = operands(l_max, K, fold, dev, seed=K)
        _anal_mxu_check(dw, m_t, x, pmm, pms, l_max, fold)


@pytest.mark.parametrize("K", [3, 8])
def test_anal_mxu_template_on_a_healpix_plan(dev, K):
    """Kernel 4 on a plain-layout HEALPix nside 64 plan's own rows and seeds
    against its plain version within TOL; identical bits on a rerun."""
    plan = repro_torch.make_plan("healpix", nside=64, K=K, dtype="float32",
                                 mode="cuda_mxu", layout="plain")
    m_t, x, pmm, pms, _ = plan._row_seeds()
    P = 2 if plan.fold else 1
    gen = torch.Generator().manual_seed(K)
    dw = (torch.rand((m_t.shape[0], P, x.shape[0], 2 * K), generator=gen)
          * 2 - 1).to(dev)
    _anal_mxu_check(dw, m_t, x, pmm, pms, plan.l_max, plan.fold)


@pytest.mark.parametrize("rings", [513, 1025])
def test_anal_mxu_template_one_ring_past_a_chunk(dev, rings):
    """R one ring past a multiple of the 512-ring chunk: the last chunk's
    block builds a single ring quad.  Kernel 4 at K 8 against its plain
    version within TOL at l_max 256 with a padding row, identical bits on
    a rerun."""
    m_t, x, pmm, pms = _one_past_a_chunk(rings, dev)
    gen = torch.Generator().manual_seed(rings)
    dw = (torch.rand((m_t.shape[0], 1, rings, 16), generator=gen) * 2
          - 1).to(dev)
    _anal_mxu_check(dw, m_t, x, pmm, pms, 256, False)


# ---------------------------------------------------------------------------
# kernel 1 (synth_vpu) on the vpu synthesis template (csrc/recurrence.cuh)
# ---------------------------------------------------------------------------


def _synth_vpu_check(a, m_t, x, pmm, pms, l_max, fold, mp_t=None):
    """Kernel 1: within TOL of its plain version, the padding rows (m < 0)
    exact zeros, the same bits on a rerun."""
    kw = dict(l_max=l_max, fold=fold, mp_vals=mp_t)
    got = lc.synth_vpu(a, m_t, x, pmm, pms, **kw)
    want = kref.synth_ref(a, m_t, x, pmm, pms, **kw)
    assert rel(got, want) < TOL and bool((got[m_t < 0] == 0).all())
    assert torch.equal(lc.synth_vpu(a, m_t, x, pmm, pms, **kw), got)


@pytest.mark.parametrize("K", [1, 2, 3, 7])
@pytest.mark.parametrize("spin,fold", [(0, False), (0, True), (2, False)])
def test_synth_vpu_template_matches_plain_version(dev, spin, fold, K):
    """Kernel 1 at l_max 256 on the plain layout against its plain version:
    spin 0 with the fold off and on, spin 2, channel chunks of 2, 4, 8 and
    16 (4, 4, 2 and 1 rings a thread; K 3 and 7 leave part of the chunk
    idle), a padding row written as zeros."""
    l_max = 256
    if spin:
        c = spin_operands(l_max, K, dev, seed=K)
        _synth_vpu_check(c["a"], c["m"], c["x"], c["pmm"], c["pms"], l_max,
                         False, c["mp"])
    else:
        m_t, x, pmm, pms, a, _ = operands(l_max, K, fold, dev, seed=K)
        _synth_vpu_check(a, m_t, x, pmm, pms, l_max, fold)


@pytest.mark.parametrize("K,rings", [(1, 513), (2, 513), (3, 257),
                                     (7, 129)])
def test_synth_vpu_template_one_ring_past_a_block(dev, K, rings):
    """R one ring past a full ring block (128 x 4, 4, 2, 1 rings at channel
    chunks 2, 4, 8, 16): the last block carries a single live ring, the
    others run unguarded.  Kernel 1 against its plain version at l_max 256
    with a padding row, identical bits on a rerun."""
    l_max = 256
    g = grids.make_grid("gl", l_max=rings - 1)
    assert g.n_rings == rings and (rings - 1) % 128 == 0
    m_vals = np.insert(np.arange(l_max + 1), 5, -1)
    pmm, pms = kref.prepare_seeds(m_vals, g.sin_theta, legendre.log_mu(l_max))
    t = lambda v, dt: torch.as_tensor(v, dtype=dt, device=dev)
    gen = torch.Generator().manual_seed(rings + K)
    keep = torch.as_tensor(np.arange(l_max + 1)[None, :] >= m_vals[:, None])
    a = (torch.rand((len(m_vals), l_max + 1, 2 * K), generator=gen) * 2
         - 1) * keep[..., None]
    _synth_vpu_check(a.to(dev), t(m_vals, torch.int32),
                     t(g.cos_theta, torch.float32), t(pmm, torch.float32),
                     t(pms, torch.int32), l_max, False)


@pytest.mark.parametrize("K", [1, 3])
def test_synth_vpu_template_on_a_healpix_plan(dev, K):
    """Kernel 1 on a plain-layout HEALPix nside 64 plan's own rows and seeds
    (with its fold) against its plain version; identical bits on a
    rerun."""
    plan = repro_torch.make_plan("healpix", nside=64, K=K, dtype="float32",
                                 mode="cuda_vpu", layout="plain")
    m_t, x, pmm, pms, _ = plan._row_seeds()
    gen = torch.Generator().manual_seed(K)
    a = torch.rand((m_t.shape[0], plan.l_max + 1, 2 * K), generator=gen)
    m = m_t.cpu()
    keep = torch.arange(plan.l_max + 1)[None, :] >= m[:, None]
    a = ((a * 2 - 1) * keep[..., None]).to(dev)
    _synth_vpu_check(a, m_t, x, pmm, pms, plan.l_max, plan.fold)


# ---------------------------------------------------------------------------
# the mxu synthesis template (csrc/mxu_synth.cuh): kernels 10 and 6, and
# kernel 10's bf16 branch
# ---------------------------------------------------------------------------


def _slot_synth_operands(l_max, K, spin, fold, dev, seed):
    """A slot layout of the rows 0..l_max with a padding row (spin: the 2M
    spin rows), its packed seeds and coefficients, and random rotation
    tables (n_slots, 2, P, 4, R)."""
    if spin:
        c = spin_operands(l_max, K, dev, seed=K)
        lo = pack.build_layout(c["m2"], l_max, mp_vals=c["mp2"])
        maps, x, pmm_pk, pms_pk = ops._prep(lo, c["x"], c["pmm"], c["pms"])
        a_pk = ops._pack_a(c["a"], lo).contiguous()
    else:
        lo, maps, x, pmm_pk, pms_pk, a_pk, _, _ = fused_operands(
            l_max, K, fold, dev, seed=K)
    P, R = (2 if fold else 1), x.shape[0]
    gen = torch.Generator().manual_seed(seed)
    tab = (torch.rand((lo.n_slots, 2, P, 4, R), generator=gen) * 2
           - 1).to(dev)
    return lo, maps, x, pmm_pk, pms_pk, a_pk, tab


@pytest.mark.parametrize("tables", ["random", "none"])
@pytest.mark.parametrize("K", [1, 3, 8, 9])
@pytest.mark.parametrize("spin,fold", [(0, False), (0, True), (2, False)])
def test_mxu_synthesis_template_matches_plain_versions(dev, spin, fold, K,
                                                       tables):
    """Kernels 10 and 6 at l_max 256 against their plain versions within
    TOL: spin 0 with the fold off and on (both planes' sums in registers),
    spin 2, map chunks of 1, 4 and 8 (2 rings x all channels a thread at 1
    and 4, 4 rings x 8 channels at 8; K 3 leaves part of its chunk idle, K
    9 runs two chunks), random rotation tables and none; every row's last
    panel is short; identical bits on a rerun."""
    l_max = 256
    lo, maps, x, pmm_pk, pms_pk, a_pk, tab = _slot_synth_operands(
        l_max, K, bool(spin), fold, dev, 10 * K + spin + 3)
    _slot_synth_check(dev, a_pk, maps, x, pmm_pk, pms_pk,
                     tab if tables == "random" else None, lo, l_max, fold,
                     bool(spin), "mxu")


@pytest.mark.parametrize("K", [3, 8])
def test_mxu_synthesis_template_with_bucket_tables(dev, K):
    """Kernels 10 and 6 on a HEALPix nside 64 plan's own seeds, layout and
    bucket rotation tables (kernel 10 applies them in-kernel) against their
    plain versions within TOL; identical bits on a rerun."""
    plan = repro_torch.make_plan("healpix", nside=64, K=K, dtype="float32",
                                 mode="cuda_mxu")
    assert plan.layouts["synth"] == "fused"
    a = torch.zeros(plan._alm_shape, dtype=torch.complex64, device=dev)
    plan.map2alm(plan.alm2map(a))                # fills the plan's store
    _, kw, _ = plan._fused_parts("mxu", False)
    lo, store = kw["lo"], kw["store"]
    maps, x, pmm_pk, pms_pk = store["prep"]
    tab = store[("tables", "synth")]
    assert tab is not None
    _slot_synth_check(dev, _random_a_pk(lo, K, K + 5, dev), maps, x, pmm_pk,
                     pms_pk, tab, lo, plan.l_max, tab.shape[2] == 2, False,
                     "mxu")


@pytest.mark.parametrize("rings", [513, 2049])
def test_mxu_synthesis_template_one_ring_past_a_chunk(dev, rings):
    """R one ring past a multiple of the 512-ring chunk (2049: GL 2048's
    ring count): the last chunk's block builds and contracts a single ring
    quad.  Kernels 10 and 6 at K 8 against their plain versions within TOL
    at l_max 256 (random tables), identical bits on a rerun."""
    m_t, x, pmm, pms = _one_past_a_chunk(rings, dev)
    lo = pack.build_layout(m_t.cpu().numpy(), 256)
    maps, x, pmm_pk, pms_pk = ops._prep(lo, x, pmm, pms)
    gen = torch.Generator().manual_seed(rings + 1)
    tab = (torch.rand((lo.n_slots, 2, 1, 4, rings), generator=gen) * 2
           - 1).to(dev)
    _slot_synth_check(dev, _random_a_pk(lo, 8, rings, dev), maps, x, pmm_pk,
                     pms_pk, tab, lo, 256, False, False, "mxu")


@pytest.mark.parametrize("spin,fold", [(0, False), (0, True), (2, False)])
def test_mxu_synthesis_template_bf16(dev, spin, fold):
    """Kernel 10's bf16 instantiation on the template's panel at K 8, l_max
    256, random tables: within BF16_TOL = 1e-5 of its bf16 plain version
    (both form exact bf16 products; only the float32 sums' order
    differs), 0 < err < 1e-2 against the float32 kernel (the reference's
    gate), the empty segment's planes exactly zero, identical bits on a
    rerun."""
    l_max = 256
    lo, maps, x, pmm_pk, pms_pk, a_pk, tab = _slot_synth_operands(
        l_max, 8, bool(spin), fold, dev, 9 + spin)
    empty = torch.as_tensor(lo.slot_seed == lo.S, device=dev)
    kw = dict(l_max=l_max, fold=fold, spin=bool(spin))
    got = fused_cuda.synth_fused_mxu(a_pk, maps, x, pmm_pk, pms_pk, tab,
                                     bf16=True, **kw)
    want = kref.synth_fused_ref(a_pk, maps, x, pmm_pk, pms_pk, tab,
                                bf16=True, **kw)
    assert rel(got, want) < BF16_TOL and bool((got[empty, 1] == 0).all())
    f32 = fused_cuda.synth_fused_mxu(a_pk, maps, x, pmm_pk, pms_pk, tab, **kw)
    assert 0 < rel(got, f32) < 1e-2
    assert torch.equal(fused_cuda.synth_fused_mxu(
        a_pk, maps, x, pmm_pk, pms_pk, tab, bf16=True, **kw), got)


# ---------------------------------------------------------------------------
# kernel 2 (synth_mxu) on the mxu synthesis template (csrc/mxu_synth.cuh)
# ---------------------------------------------------------------------------


def _synth_mxu_operands(l_max, rings, K, fold, spin, dev, seed):
    """The rows 0..l_max (spin: the 2M spin rows) on a GL grid of ``rings``
    rings (its northern half with the fold), one row mid-table made a
    padding row (m = -1), their seeds, and random coefficient rows zero
    below l0 = max(m, |m'|): (a, m_vals, x, pmm, pms, mp_vals)."""
    g = grids.make_grid("gl", l_max=rings - 1)
    assert g.n_rings == rings
    if spin:
        m_vals, mp_vals = ops.spin_rows(np.arange(l_max + 1))
        m_vals[l_max // 2] = -1
        x = g.cos_theta
        pmm, pms = kref.prepare_seeds_spin(m_vals, mp_vals, x, g.sin_theta,
                                           m_max=l_max)
        l0 = np.maximum(m_vals, np.abs(mp_vals))
    else:
        m_vals, mp_vals = np.insert(np.arange(l_max + 1), l_max // 2, -1), None
        nh = (rings + 1) // 2
        sin = g.sin_theta[:nh] if fold else g.sin_theta
        x = g.cos_theta[:nh] if fold else g.cos_theta
        pmm, pms = kref.prepare_seeds(m_vals, sin, legendre.log_mu(l_max))
        l0 = m_vals
    L = l_max + 1
    keep = torch.as_tensor((np.arange(L)[None, :] >= l0[:, None])
                           & (m_vals >= 0)[:, None])
    gen = torch.Generator().manual_seed(seed)
    a = (torch.rand((len(m_vals), L, 2 * K), generator=gen) * 2 - 1) \
        * keep[..., None]
    t = lambda v, dt: torch.as_tensor(v, dtype=dt, device=dev)
    return (a.to(dev), t(m_vals, torch.int32), t(x, torch.float32),
            t(pmm, torch.float32), t(pms, torch.int32),
            None if mp_vals is None else t(mp_vals, torch.int32))


@pytest.mark.parametrize("rings", [1025, 2049])
@pytest.mark.parametrize("K", [1, 3, 8, 12])
@pytest.mark.parametrize("spin,fold", [(0, False), (0, True), (2, False)])
def test_synth_mxu_template_matches_plain_version(dev, spin, fold, K, rings):
    """Kernel 2 on the plain layout against its plain version within TOL,
    the padding row (m = -1, mid-table) exactly zero, identical bits on a
    rerun.  l_max 300 (spin 2: 258, the first l_max at which a spin row
    walks more than 256 multipoles; beyond it the spin rows' gap from the
    plain version's order of float32 sums nears TOL, whose band is stated
    for l_max 256): the rows of more than 256 multipoles cross a group of
    the template, so their sums wait in shared memory across the next
    table fill.  R one ring past a multiple
    of the 512-ring chunk (1025, 2049; with the fold their northern
    halves 513 and 1025).  K 1, 3, 8, 12: channel blocks of 2, 8 (6
    live), 16, and 16 + 8; the fold on and off and the spin branch."""
    l_max = 258 if spin else 300
    a, m_t, x, pmm, pms, mp_t = _synth_mxu_operands(
        l_max, rings, K, fold, bool(spin), dev, 100 * K + rings + spin)
    assert x.shape[0] % lc.ANAL_CHUNK["mxu"] == 1
    kw = dict(l_max=l_max, fold=fold, mp_vals=mp_t)
    got = lc.synth_mxu(a, m_t, x, pmm, pms, **kw)
    want = kref.synth_ref(a, m_t, x, pmm, pms, **kw)
    assert rel(got, want) < TOL and bool((got[m_t < 0] == 0).all())
    assert torch.equal(lc.synth_mxu(a, m_t, x, pmm, pms, **kw), got)


@pytest.mark.parametrize("spin", [0, 2])
def test_autotune_on_the_card(dev, spin, tmp_path):
    """make_plan(mode="auto") at GL 256/K8 on the card: every corner
    measured finite, the choice per direction the measured minimum
    (backend and layout), and a second build after clear_plan_cache()
    reads the decision back from disk and measures no corner."""
    from repro_torch.core import transform
    from repro_torch.roofline import chardb
    kw = dict(K=8, dtype="float32", mode="auto", spin=spin, cache="disk",
              cache_dir=str(tmp_path))
    transform.clear_plan_cache()
    chardb.clear()
    plan = repro_torch.make_plan("gl", 256, **kw)
    assert chardb.stats()["measured"] == 14
    ms = plan.measured_s
    for d in ("synth", "anal"):
        corners = {("torch", None): ms["torch"][d]}
        for b in transform.KERNEL_BACKENDS:
            corners.update({(b, lay): ms[b][f"{d}_{lay}"]
                            for lay in plan._kernel_layouts()})
        assert all(np.isfinite(v) for v in corners.values())
        assert (plan.backends[d], plan.layouts[d]) == min(corners,
                                                          key=corners.get)
    transform.clear_plan_cache()
    again = repro_torch.make_plan("gl", 256, **kw)
    assert again.cache_events["decision"] == "hit"
    assert chardb.stats()["measured"] == 14
    assert (again.backends, again.layouts) == (plan.backends, plan.layouts)
    transform.clear_plan_cache()


def test_autotune_propagates_a_kernel_error(dev, monkeypatch):
    """A corner whose kernel raises is not ranked last: the error of the
    wrapper (here a stand-in for the fused synthesis' launch) reaches the
    caller of make_plan."""
    from repro_torch.core import transform
    from repro_torch.roofline import chardb

    def broken(*args, **kwargs):
        raise RuntimeError("legendre kernel launch failed")

    monkeypatch.setattr(fused_cuda, "synth_fused_mxu", broken)
    monkeypatch.setattr(fused_cuda, "synth_fused_vpu", broken)
    transform.clear_plan_cache()
    chardb.clear()
    with pytest.raises(RuntimeError, match="launch failed"):
        repro_torch.make_plan("gl", 64, K=8, dtype="float32", mode="auto",
                              cache="off")
    transform.clear_plan_cache()


# -- the serving engine on the card -------------------------------------------


def _serve_traffic(l_max, seed):
    """Eight spin-0 alm2map payloads and three map2alm ones (maps from a
    K=1 plan), float32, numpy."""
    from repro_torch.launch.serve import random_alm
    rng = np.random.default_rng(seed)
    alms = [random_alm(rng, l_max, 0, np.float32) for _ in range(8)]
    plan = repro_torch.make_plan("gl", l_max, K=1, dtype="float32")
    maps = [plan.alm2map(a[..., None]).cpu().numpy()[..., 0]
            for a in alms[:3]]
    return [("alm2map", a) for a in alms] + [("map2alm", m) for m in maps]


@pytest.mark.parametrize("background", [False, True])
def test_engine_on_the_card(dev, background):
    """The engine at GL l_max 64 on the card, synchronous (``drain()``) and
    double-buffered (``with engine:``): every request served, no warm-up
    failed, each batch's results bit-equal to its pooled plan called
    directly on the stacked payload, and each result within TOL of a K=1
    plan of the batch's backend and layout."""
    from repro_torch.core import transform
    from repro_torch.serve import PlanSig, ShtEngine
    l_max = 64
    transform.clear_plan_cache()
    traffic = _serve_traffic(l_max, seed=5)
    eng = ShtEngine(max_k=8, warm_after=2)
    assert eng.device.type == "cuda"
    sig = dict(grid="gl", l_max=l_max, dtype="float32")

    def submit_all():
        return [eng.submit(direction=d, payload=p, **sig)
                for d, p in traffic]

    if background:
        with eng:
            futs = submit_all()
            for f in futs:
                f.result(timeout=300)
    else:
        futs = submit_all()
        eng.drain()
    s = eng.stats()
    assert s["requests"]["completed"] == len(traffic)
    assert s["requests"]["failed"] == 0 and s["warm_failures"] == []
    assert s["pool"]["warmups"] == 1
    for b in eng.batch_log:
        plan = eng.pool.get(PlanSig(**sig), b["k_plan"])
        d = "synth" if b["direction"] == "alm2map" else "anal"
        payloads = [traffic[rid][1] for rid in b["rids"]]
        pad = [np.zeros_like(payloads[0])] * (b["k_plan"] - len(payloads))
        stacked = np.stack(payloads + pad, -1)
        run = plan.alm2map if d == "synth" else plan.map2alm
        direct = run(stacked).cpu().numpy()
        ref = repro_torch.make_plan("gl", l_max, K=1, dtype="float32",
                                    mode=plan.backends[d],
                                    layout=plan.layouts[d])
        ref_run = ref.alm2map if d == "synth" else ref.map2alm
        for i, rid in enumerate(b["rids"]):
            got = futs[rid].result()
            assert np.array_equal(direct[..., i], got)
            want = ref_run(traffic[rid][1][..., None]).cpu().numpy()[..., 0]
            assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    transform.clear_plan_cache()


def test_engine_uploads_on_its_staging_stream(dev, monkeypatch):
    """A batch's pinned payload is copied to the card on the engine's
    staging stream, and its transform runs on the execute stream: two
    streams, neither the default one."""
    from repro_torch.serve import ShtEngine
    eng = ShtEngine(max_k=4)
    seen = {"upload": [], "exec": []}
    real_to = torch.Tensor.to

    def to(self, *args, **kwargs):
        if self.device.type == "cpu" and self.is_pinned():
            seen["upload"].append(torch.cuda.current_stream().cuda_stream)
        return real_to(self, *args, **kwargs)

    class Probe:
        def __init__(self, plan):
            self._plan = plan

        def __getattr__(self, name):
            return getattr(self._plan, name)

        def alm2map(self, x):
            seen["exec"].append(torch.cuda.current_stream().cuda_stream)
            return self._plan.alm2map(x)

    monkeypatch.setattr(torch.Tensor, "to", to)
    real_get = eng.pool.get
    eng.pool.get = lambda sig, k: Probe(real_get(sig, k))
    traffic = _serve_traffic(32, seed=6)[:3]
    with eng:
        futs = [eng.submit(direction=d, payload=p, grid="gl", l_max=32,
                           dtype="float32") for d, p in traffic]
        for f in futs:
            f.result(timeout=300)
    stage, execute = eng._stage_stream.cuda_stream, \
        eng._exec_stream.cuda_stream
    default = torch.cuda.default_stream().cuda_stream
    assert len({stage, execute, default}) == 3
    assert seen["upload"] and set(seen["upload"]) == {stage}
    assert seen["exec"] and set(seen["exec"]) == {execute}


@pytest.mark.parametrize("spin", [0, 2])
def test_plan_warmup_on_the_card(dev, spin):
    """``Plan.warmup`` at GL 64/K8 launches each direction's fused mxu
    kernel once (and the analysis' reduce) and leaves the stream idle."""
    from repro_torch.core import transform
    transform.clear_plan_cache()
    plan = repro_torch.make_plan("gl", 64, K=8, dtype="float32", spin=spin)
    lc.reset_launches()
    fused_cuda.reset_launches()
    assert plan.warmup() is plan
    s = "_spin" if spin else ""
    assert fused_cuda.launches[f"synth_fused_mxu{s}"] == 1
    assert fused_cuda.launches[f"anal_fused_mxu{s}"] == 1
    assert lc.launches["anal_reduce"] == 1
    assert sum(fused_cuda.launches.values()) == 2
    assert torch.cuda.current_stream().query()
    transform.clear_plan_cache()


# ---------------------------------------------------------------------------
# the distributed transform on the card: NCCL at world size 1, GL 64 K 2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_one():
    """A NCCL process group of one rank over a HashStore (no ports), kept for
    the module's dist tests and destroyed after them."""
    import torch.distributed as tdist
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if not tdist.is_initialized():
        tdist.init_process_group(
            "nccl", store=tdist.HashStore(), rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
    yield torch.device("cuda", torch.cuda.current_device())
    tdist.destroy_process_group()


def dist_alm(l_max, K, spin, dev, seed):
    rng = np.random.default_rng(seed)
    shape = ((2,) if spin else ()) + (l_max + 1, l_max + 1, K)
    a = (rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)).astype(
        np.complex64)
    from repro_torch.core import sht
    a *= sht.alm_mask(l_max, l_max, spin=spin)[..., None]
    a[..., 0, :, :] = a[..., 0, :, :].real
    return torch.as_tensor(a).to(dev)


def dist_synth(d, alm):
    """A DistSHT's synthesis of dense alm, in grid ring order."""
    sp = d.plan
    if alm.ndim == 4:
        qu = d.alm2map_spin(torch.stack([sp.pack_alm(alm[0]),
                                         sp.pack_alm(alm[1])]))
        return torch.stack([sp.scatter_map(qu[0]), sp.scatter_map(qu[1])])
    return sp.scatter_map(d.alm2map(sp.pack_alm(alm)))


def dist_anal(d, maps):
    sp = d.plan
    if maps.ndim == 4:
        eb = d.map2alm_spin(torch.stack([sp.gather_map(maps[0]),
                                         sp.gather_map(maps[1])]))
        return torch.stack([sp.unpack_alm(eb[0]), sp.unpack_alm(eb[1])])
    return sp.unpack_alm(d.map2alm(sp.gather_map(maps)))


@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_dist_path_matches_the_serial_kernel_plan(nccl_one, variant, spin):
    """DistSHT(stage1="cuda") at world size 1 against the serial plain plan
    of the same kernels: synthesis bit for bit (the same (m, ring)
    arithmetic, cuFFT at the same lengths), C 2 bit for bit against C 1,
    analysis within 1e-6 of max (its rings summed pair-interleaved)."""
    from repro_torch.core.dist_sht import DistSHT
    from repro_torch.core.plan import SHTPlan
    dev, l_max, K = nccl_one, 64, 2
    serial = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                                   mode=f"cuda_{variant}", layout="plain",
                                   spin=spin, device=dev)
    sp = SHTPlan(serial.grid, l_max, l_max, 1)
    alm = dist_alm(l_max, K, spin, dev, 64 + spin)
    want_s = serial.alm2map(alm)
    want_a = serial.map2alm(want_s)
    outs = {}
    for C in (1, 2):
        d = DistSHT(sp, device=dev, dtype="float32", stage1="cuda",
                    comm_chunks=C, variant=variant)
        lc.reset_launches()
        outs[C] = dist_synth(d, alm)
        torch.cuda.synchronize()
        assert lc.launches[f"synth_{variant}" + ("_spin" if spin else "")] \
            >= 1
        assert torch.equal(outs[C], want_s)
        assert rel(dist_anal(d, want_s), want_a) < 1e-6
    assert torch.equal(outs[2], outs[1])


@pytest.mark.parametrize("layout", ["plain", "packed"])
def test_dist_dealt_rows_match_the_full_run(nccl_one, layout):
    """SHTPlan(n_shards=4): each rank's dealt rows through the stage-1
    adapters (mxu: kernels 2 and 4 plain, 6 and 8 packed) against the
    matching rows of the one-rank run; padding rows exactly zero."""
    from repro_torch.core.plan import SHTPlan, _slot_of
    dev, l_max, K = nccl_one, 64, 2
    g = grids.make_grid("gl", l_max=l_max)
    sp1, sp4 = (SHTPlan(g, l_max, l_max, n) for n in (1, 4))
    log_mu = legendre.log_mu(l_max)
    alm = sp1.pack_alm(dist_alm(l_max, K, 0, dev, 65))
    full = ops.delta_from_alm_auto(alm.real, alm.imag, sp1.m_flat,
                                   sp1.ring_geometry, log_mu, l_max=l_max,
                                   variant="mxu")
    gen = torch.Generator().manual_seed(66)
    dw = [(torch.rand((alm.shape[0], sp1.r_pad, K), generator=gen) * 2 - 1)
          .to(dev) for _ in range(2)]
    full_a = ops.alm_from_delta_auto(*dw, sp1.m_flat, sp1.ring_geometry,
                                     log_mu, l_max=l_max, variant="mxu")
    slot = _slot_of(sp1.m_flat, l_max + 1)
    R1 = sp1.r_pad
    base = "" if layout == "plain" else "packed_"
    fused_cuda.reset_launches()
    lc.reset_launches()
    for r in range(4):
        rows = sp4.m_assignment[r]
        live = torch.as_tensor(rows >= 0, device=dev)
        idx = torch.as_tensor(slot[np.maximum(rows, 0)], device=dev)
        a = alm.index_select(0, idx) * live[:, None, None]
        got = ops.delta_from_alm_auto(
            a.real.contiguous(), a.imag.contiguous(), rows,
            sp4.ring_geometry, log_mu, l_max=l_max, variant="mxu",
            layout=layout)
        for g_, f_ in zip(got, full):
            want = f_.index_select(0, idx)
            if layout == "plain":
                assert torch.equal(g_[live][:, :R1], want[live])
            else:
                assert rel(g_[live][:, :R1], want[live]) < 1e-6
            assert not bool(g_[~live].any())
        pad = torch.zeros((len(rows), sp4.r_pad - R1, K), device=dev)
        w = [torch.cat([t.index_select(0, idx) * live[:, None, None], pad],
                       dim=1) for t in dw]
        got_a = ops.alm_from_delta_auto(*w, rows, sp4.ring_geometry, log_mu,
                                        l_max=l_max, variant="mxu",
                                        layout=layout)
        for g_, f_ in zip(got_a, full_a):
            assert rel(g_[live], f_.index_select(0, idx)[live]) < 1e-6
            assert not bool(g_[~live].any())
    counts = {**lc.launches, **fused_cuda.launches}
    assert counts[f"synth_{base}mxu"] == 4 and counts[f"anal_{base}mxu"] == 4


def test_dist_gradients_on_the_card(nccl_one):
    """<A x, y> against <x, A^T y> through autograd on the dist path; the
    backward of the synthesis launches the analysis kernel."""
    from repro_torch.core.dist_sht import DistSHT
    from repro_torch.core.plan import SHTPlan
    dev, l_max, K = nccl_one, 64, 8
    g = grids.make_grid("gl", l_max=l_max)
    d = DistSHT(SHTPlan(g, l_max, l_max, 1), device=dev, dtype="float32",
                stage1="cuda", comm_chunks=2)
    gen = torch.Generator().manual_seed(67)
    a = dist_alm(l_max, K, 0, dev, 67).requires_grad_(True)
    t = torch.randn((g.n_rings, g.max_n_phi, K), generator=gen).to(dev)
    lhs = (dist_synth(d, a) * t).sum()
    lc.reset_launches()
    (grad,) = torch.autograd.grad(lhs, a)
    torch.cuda.synchronize()
    assert lc.launches["anal_mxu"] == 2      # one a chunk of the k axis
    a = a.detach()
    rhs = float((a.real * grad.real + a.imag * grad.imag).sum())
    assert abs(lhs.item() - rhs) <= 2e-3 * abs(rhs)
    maps = torch.randn((g.n_rings, g.max_n_phi, K), generator=gen).to(dev)
    maps.requires_grad_(True)
    b = dist_alm(l_max, K, 0, dev, 68)
    out = dist_anal(d, maps)
    lhs = (out.real * b.real + out.imag * b.imag).sum()
    (grad,) = torch.autograd.grad(lhs, maps)
    rhs = float((maps.detach() * grad).sum())
    assert abs(lhs.item() - rhs) <= 2e-3 * abs(rhs)


# -- the dense decoders (repro_torch.models) --------------------------------------

MODEL_ARCHS = ["qwen2-0.5b", "qwen3-8b", "qwen1.5-32b", "h2o-danube-3-4b",
               "internvl2-1b"]


@pytest.mark.parametrize("name", MODEL_ARCHS)
def test_model_on_the_card_matches_the_cpu(dev, name):
    """A reduced float32 model, weights drawn on the card and copied to
    the host: the loss, the prefill logits (96 tokens on the
    sliding-window model, past its window of 64) and 4 decode steps' logits
    on the card against the CPU within 1e-4 x max|CPU|, TF32 off."""
    from repro_torch.configs import base, registry
    from repro_torch.models.model import make_bundle
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = base.reduced(registry.ARCHS[name])
    gpu, cpu = make_bundle(cfg), make_bundle(cfg, device="cpu")
    assert gpu.device.type == "cuda"
    model = gpu.init(3)
    host = cpu.from_state(model.state_dict())
    prompt = 96 if cfg.sliding_window else 16
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (2, prompt + 4), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.randn((2, 8, cfg.d_model),
                                            generator=gen)
    runs = []
    for b, m in ((gpu, model), (cpu, host)):
        on = {k: v.to(b.device) for k, v in batch.items()}
        with torch.no_grad():
            outs = [b.loss_fn(m, on).reshape(1)]
        t = on["tokens"]
        logits, c = b.prefill_fn(m, {"tokens": t[:, :prompt]},
                                 b.init_caches(2, 128))
        outs.append(logits)
        for i in range(prompt, prompt + 4):
            logits, c = b.decode_fn(m, t[:, i:i + 1], i, c)
            outs.append(logits)
        runs.append(outs)
    for got, want in zip(*runs):
        assert got.device.type == "cuda" and bool(torch.isfinite(got).all())
        assert rel(got.cpu(), want) < 1e-4
