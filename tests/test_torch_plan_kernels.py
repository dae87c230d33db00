"""The whole slice: the port's float32 kernel plans (``cuda_vpu`` /
``cuda_mxu`` on ``device="cpu"``, i.e. the kernels' plain versions plus
``torch.fft``) against the reference plan forced onto the same Pallas
kernels on the plain layout, run in interpret mode.

Tolerance 5e-5 x max|ref|, both directions: the same float32 schedule,
rounded differently by the two frameworks (see test_torch_ops.py).
"""

import numpy as np
import pytest

import repro
from repro.core import sht as rsht

import repro_torch

TOL = 5e-5


def rel(got, want) -> float:
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_kernel_plan_matches_reference_pallas_plan(variant, K, fold):
    l_max = 31 if fold else 24
    rng = np.random.default_rng(K + 10 * fold)
    shape = (l_max + 1, l_max + 1, K)
    alm = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    alm[0] = alm[0].real
    alm = (alm * rsht.alm_mask(l_max, l_max)[..., None]).astype(np.complex64)

    ref = repro.make_plan("gl", l_max, K=K, dtype="float32",
                          mode=f"pallas_{variant}", fold=fold)
    want_maps = np.array(ref._synth_fn(f"pallas_{variant}",
                                       layout="plain")(alm))
    want_alm = np.array(ref._anal_fn(f"pallas_{variant}",
                                     layout="plain")(want_maps))

    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                                 mode=f"cuda_{variant}", fold=fold,
                                 layout="plain", device="cpu")
    assert plan.backends == {"synth": f"cuda_{variant}",
                             "anal": f"cuda_{variant}"}
    assert plan.layouts == {"synth": "plain", "anal": "plain"}
    maps = plan.alm2map(alm)
    assert maps.shape == want_maps.shape and str(maps.dtype) == "torch.float32"
    assert rel(maps, want_maps) < TOL
    got_alm = plan.map2alm(want_maps)
    assert got_alm.shape == want_alm.shape
    assert rel(got_alm, want_alm) < TOL
