"""The port's configurations, mesh shapes and SHT dry-run cell against the
reference's.

``repro_torch.configs`` is a copy of ``repro.configs``: every dataclass
must be equal field for field (compared as dicts, the classes differ), and
the parameter counts equal exactly.  ``launch.mesh`` gives the reference's
mesh shapes and axis names (the reference's builders are run with
``jax.make_mesh`` stubbed to return its arguments: the production meshes
need 256 and 512 devices).  The SHT dry-run cell builds the port's
``SHTPlan`` at 256 and 512 shards for each ``SHT_SHAPES`` entry: its
arrays must equal the reference plan's, its counts the reference's
``_sht_corrected`` and ``lower_sht_cell`` formulas to 1e-12 relative (the
same float64 arithmetic; only the grids' n_rings and max_n_phi enter), and
its cost-model time, under the host model both packages carry, the
reference's ``predict_sht_time("dist")`` to 1e-12.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.configs import base as rbase
from repro.configs import registry as rregistry
from repro.configs import sht_cmb as rsht
from repro.core import grids as rgrids
from repro.core import plan as rplan
from repro.launch import mesh as rmesh
from repro.models import transformer as rT
from repro.roofline import analysis as rra
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as tregistry
from repro_torch.configs import sht_cmb as tsht
from repro_torch.launch import dryrun, mesh
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as ra

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(rregistry.ARCHS)


def as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_registry_names_and_lookup():
    assert sorted(tregistry.ARCHS) == ARCHS and len(ARCHS) == 10
    assert tregistry.get("qwen3-8b") is tregistry.ARCHS["qwen3-8b"]
    with pytest.raises(KeyError, match="unknown arch"):
        tregistry.get("gpt-5")


@pytest.mark.parametrize("name", ARCHS)
def test_arch_config_equals_the_reference(name):
    got, want = tregistry.ARCHS[name], rregistry.ARCHS[name]
    assert as_dict(got) == as_dict(want)
    assert got.hd == want.hd
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params()


@pytest.mark.parametrize("name", ARCHS)
def test_reduced_equals_the_reference(name):
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    for over in ({}, kw, dict(n_layers=3)):
        got = tbase.reduced(tregistry.ARCHS[name], **over)
        want = rbase.reduced(rregistry.ARCHS[name], **over)
        assert as_dict(got) == as_dict(want), over
        assert got.n_params() == want.n_params()
        assert got.n_active_params() == want.n_active_params()


def test_shapes_equal_the_reference():
    assert set(tbase.SHAPES) == set(rbase.SHAPES)
    for k in rbase.SHAPES:
        assert as_dict(tbase.SHAPES[k]) == as_dict(rbase.SHAPES[k])
    assert set(tsht.SHT_SHAPES) == set(rsht.SHT_SHAPES)
    for k in rsht.SHT_SHAPES:
        assert as_dict(tsht.SHT_SHAPES[k]) == as_dict(rsht.SHT_SHAPES[k])
    assert as_dict(tsht.CONFIG) == as_dict(rsht.CONFIG)


class _StubJax:
    """Stands in for ``jax`` inside ``repro.launch.mesh``: make_mesh
    returns its (shape, axes)."""

    @staticmethod
    def make_mesh(shape, axes):
        return tuple(shape), tuple(axes)


class _FakeMesh:
    """The two attributes ``make_rules`` and ``sht_axis_names`` read."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_equals_the_reference(monkeypatch, multi_pod):
    monkeypatch.setattr(rmesh, "jax", _StubJax)
    want = rmesh.make_production_mesh(multi_pod=multi_pod)
    assert mesh.production_mesh_shape(multi_pod=multi_pod) == want
    fake = _FakeMesh(*want)
    assert mesh.sht_axis_names(fake) == rmesh.sht_axis_names(fake)


@pytest.mark.parametrize("n,model", [(16, 16), (240, 16), (64, 8), (6, 3)])
def test_elastic_mesh_shape_equals_the_reference(monkeypatch, n, model):
    monkeypatch.setattr(rmesh, "jax", _StubJax)
    assert mesh.elastic_mesh_shape(n, model=model) == \
        rmesh.elastic_mesh(n, model=model)


def test_elastic_mesh_shape_rejects_a_ragged_count():
    for n, model in ((17, 16), (8, 16), (0, 16), (4, 0)):
        with pytest.raises(ValueError, match="multiple"):
            mesh.elastic_mesh_shape(n, model=model)


def test_meshes_need_a_process_group_of_their_size():
    """No group: a clear error; a gloo group of one rank: the 1 x 1
    elastic mesh as a DeviceMesh, and the production mesh refused."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="none is initialised"):
        mesh.make_production_mesh(device_type="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        m = mesh.elastic_mesh(1, model=1, device_type="cpu")
        assert tuple(m.mesh_dim_names) == ("data", "model")
        assert tuple(m.shape) == (1, 1)
        assert mesh.sht_axis_names(m) == ("data", "model")
        assert T.mesh_axes(m) == {"data": 1, "model": 1}
        with pytest.raises(RuntimeError, match="it has 1"):
            mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ARCHS)
def test_sharding_rules_equal_the_reference(name):
    """make_rules on no mesh, one pod and two pods, for every profile."""
    cfg = tregistry.ARCHS[name]
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model")),
                        (None, None)):
        fake = None if shape is None else _FakeMesh(shape, axes)
        for profile in ("tp", "small", "dp"):
            c = dataclasses.replace(cfg, tp_profile=profile)
            rc = dataclasses.replace(rregistry.ARCHS[name],
                                     tp_profile=profile)
            got = dataclasses.asdict(T.make_rules(c, fake))
            want = dataclasses.asdict(rT.make_rules(rc, fake))
            assert got == want, (shape, profile)
    assert T.build_groups(cfg) == rT.build_groups(rregistry.ARCHS[name])


# -- the SHT dry-run cell --------------------------------------------------------

PLAN_ARRAYS = ("m_assignment", "m_flat", "recurrence_steps_per_shard",
               "_pairs", "ring_order", "slot_fft_len", "north_order")


def _reference_counts(rdry, scfg, grid, n_dev):
    """The reference's corrected counts, and its ``lower_sht_cell``
    model_flops formula (that function lowers the sharded program, so
    its formula is repeated here)."""
    flops, bytes_ = rdry._sht_corrected(None, scfg, grid, n_dev, scfg.K)
    L1 = scfg.l_max + 1
    tri = grid.n_rings * L1 * (L1 + 1) / 2.0
    n = grid.max_n_phi
    model = tri * (6.0 + 8.0 * scfg.K) + \
        5.0 * grid.n_rings * n * np.log2(n) * scfg.K
    return flops, bytes_, model


@pytest.fixture(scope="module")
def reference_dryrun():
    """``repro.launch.dryrun`` sets XLA_FLAGS to 512 host devices when
    imported; import it with the variable restored afterwards."""
    before = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as rdry  # noqa: F401
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return rdry


def rel(a, b) -> float:
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", sorted(rsht.SHT_SHAPES))
def test_sht_cell_equals_the_reference(reference_dryrun, shape, multi_pod):
    cell = dryrun.sht_cell(shape, multi_pod)
    n_dev = 512 if multi_pod else 256
    assert cell["n_devices"] == n_dev
    scfg = rsht.SHT_SHAPES[shape]
    rg = rgrids.make_grid("gl", l_max=scfg.l_max)
    assert (cell["sht_grid"].n_rings, cell["sht_grid"].max_n_phi) == \
        (rg.n_rings, rg.max_n_phi)
    ref = rplan.SHTPlan(rg, scfg.l_max, scfg.l_max, n_dev)
    p = cell["plan"]
    for name in PLAN_ARRAYS:
        got, want = getattr(p, name), getattr(ref, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for name in ("m_local", "n_pairs_pad", "r_pad", "r_local"):
        assert getattr(p, name) == getattr(ref, name), name
    geo, rgeo = p.ring_geometry, ref.ring_geometry
    assert set(geo) == set(rgeo)
    assert all(np.array_equal(geo[k], rgeo[k]) for k in geo)
    assert p.describe() == ref.describe()
    flops, bytes_, model = _reference_counts(reference_dryrun, scfg, rg,
                                             n_dev)
    assert rel(cell["flops_per_device"], flops) < 1e-12
    assert rel(cell["bytes_per_device"], bytes_) < 1e-12
    assert rel(cell["model_flops"], model) < 1e-12
    # the cost model's dist time under the host model both packages have
    host = dryrun.sht_cell(shape, multi_pod, hw=ra.HW_HOST)["predicted_s"]
    want = rra.predict_sht_time(
        "dist", l_max=scfg.l_max, m_max=scfg.l_max, n_rings=rg.n_rings,
        n_phi=rg.max_n_phi, K=scfg.K, direction=scfg.direction,
        hw=rra.HW_HOST, n_devices=n_dev)
    assert rel(host, want) < 1e-12
    assert cell["hw"] == "h100-sxm" and cell["predicted_s"] > 0


@pytest.mark.parametrize("fold,comm_dtype", [(True, None),
                                             (False, "bfloat16")])
def test_sht_cell_options_equal_the_reference(reference_dryrun, fold,
                                              comm_dtype):
    cell = dryrun.sht_cell("synth_2k_k8", False, fold=fold,
                           comm_dtype=comm_dtype)
    scfg = dataclasses.replace(rsht.SHT_SHAPES["synth_2k_k8"], fold=fold,
                               comm_dtype=comm_dtype)
    assert as_dict(cell["sht_cfg"]) == as_dict(scfg)
    rg = rgrids.make_grid("gl", l_max=scfg.l_max)
    flops, bytes_, _ = _reference_counts(reference_dryrun, scfg, rg, 256)
    assert rel(cell["flops_per_device"], flops) < 1e-12
    assert rel(cell["bytes_per_device"], bytes_) < 1e-12


def _cli(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun"]
                          + args, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=120)


def test_dryrun_cli_writes_the_sht_cell(tmp_path, capsys):
    argv = ["--arch", "sht_cmb", "--shape", "synth_2k_k8", "--mesh", "multi",
            "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    rec = json.loads((tmp_path / "sht_cmb__synth_2k_k8__multi.json")
                     .read_text())
    cell = dryrun.sht_cell("synth_2k_k8", True)
    assert rec["status"] == "ok" and rec["n_devices"] == 512
    assert rec["mesh_axes"] == ["pod", "data", "model"]
    assert rec["roofline"]["flops_per_device"] == cell["flops_per_device"]
    assert rec["roofline"]["bytes_per_device"] == cell["bytes_per_device"]
    assert rec["model_flops"] == cell["model_flops"]
    assert set(rec["no_counterpart"]) == {"compile_s", "memory_analysis",
                                          "roofline_raw"}
    for k in rec["no_counterpart"]:
        assert k not in rec
    assert dryrun.main(argv) == 0 and "cached" in capsys.readouterr().out


def test_dryrun_cli_refuses_the_lm_cells(tmp_path):
    r = _cli(["--arch", "qwen3-8b", "--shape", "train_4k", "--out",
              str(tmp_path)])
    assert r.returncode != 0 and "no counterpart" in r.stderr
    assert not list(tmp_path.iterdir())
    with pytest.raises(NotImplementedError, match="12d"):
        dryrun.run_cell("qwen3-8b", "train_4k", "single", str(tmp_path))
