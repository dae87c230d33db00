"""The CUDA kernels of the port on the card: each against its plain
version, determinism of the analysis reduction, and the launch counters
of a plan's main path.  Skipped without a CUDA device; run on the GPU with
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
    plan = repro_torch.make_plan("gl", 96, K=K, dtype="float32", mode=mode)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.core import sht
    alm = sht.random_alm(gen, 96, 96, K, dtype=torch.float32, device=dev)
    lc.reset_launches()
    back = plan.map2alm(plan.alm2map(alm))
    assert lc.launches[f"synth_{var}"] == 1
    assert lc.launches[f"anal_{var}"] == 1 and lc.launches["anal_reduce"] == 1
    assert back.device.type == "cuda"
    assert spectra.d_err(alm, back) < 1e-4
