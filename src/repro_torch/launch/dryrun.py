"""Dry-run cell of the distributed SHT at production scale.

Counterpart of the SHT cell of ``repro.launch.dryrun``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch sht_cmb \\
        --shape synth_8k_k4 --mesh multi --out results/dryrun_torch

For one ``SHT_SHAPES`` entry and one production mesh (256 or 512 ranks,
``launch.mesh``) the cell builds the port's distribution plan
(``core.plan.SHTPlan`` on the Gauss-Legendre grid, one shard per rank)
and writes its work balance, the useful flops of the whole transform
(``model_flops``) and the analytic per-device flops and bytes, each
computed exactly as the reference computes them, and the cost model's
time of the distributed transform on ``HW_H100``.  It runs on the host
and needs no card: the plan is host arrays.

The reference cell also lowers and compiles the sharded step with XLA
over 512 host-platform devices and reads ``compile_s``,
``memory_analysis`` and the raw cost analysis (``roofline_raw``) from the
compiled program.  PyTorch has no ahead-of-time SPMD compile of that
kind, so those fields have no counterpart: the record names them under
``"no_counterpart"`` and nothing emulates them.  The LM cells of the
reference are such compiles as a whole, so every ``--arch`` but
``sht_cmb`` exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from repro_torch.configs.sht_cmb import SHT_SHAPES
from repro_torch.core import grids
from repro_torch.core.plan import SHTPlan
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.roofline.analysis import HW_H100, predict_sht_time

__all__ = ["sht_cell", "sht_model_flops", "sht_corrected", "run_cell"]

#: the reference record's fields that come from XLA's compiled program
NO_COUNTERPART = {
    "compile_s": "XLA ahead-of-time compile of the sharded step",
    "memory_analysis": "XLA compiled-program memory analysis",
    "roofline_raw": "XLA HloCostAnalysis of the compiled program",
}

LM_CELLS = ("the LM dry-run cells lower and compile each model's sharded "
            "step with XLA over 512 host-platform devices; PyTorch has no "
            "counterpart, so the port runs only --arch sht_cmb (ROADMAP "
            "item 12d)")


def sht_model_flops(scfg, grid) -> float:
    """Useful flops of one transform: recurrence (6) + complex accumulate
    (8K) per (l >= m, m, ring) triple, plus the batched FFT stage."""
    L1 = scfg.l_max + 1
    tri = grid.n_rings * L1 * (L1 + 1) / 2.0
    n = grid.max_n_phi
    fft = 5.0 * grid.n_rings * n * np.log2(n) * scfg.K
    return tri * (6.0 + 8.0 * scfg.K) + fft


def sht_corrected(scfg, grid, n_dev: int, K: int) -> tuple:
    """Analytic per-device ``(flops, bytes)`` of the distributed transform:
    the triangular recurrence work split over the devices (20 flops a step,
    10 with the fold on northern rings only, + 8K for the accumulate), the
    FFT stage on the device's rings; bytes as a_lm read once, Delta written,
    exchanged and read once, and the maps written once."""
    L1 = scfg.l_max + 1
    tri_steps = grid.n_rings * L1 * (L1 + 1) / 2.0 / n_dev
    rec_per_step = (10.0 if scfg.fold else 20.0) + 8.0 * K
    rec_flops = tri_steps * rec_per_step
    n = grid.max_n_phi
    fft_flops = 5.0 * (grid.n_rings / n_dev) * n * np.log2(n) * K
    flops = rec_flops + fft_flops
    dt = 4 if scfg.dtype == "float32" else 8
    bytes_ = (L1 * L1 / 2 / n_dev * 2 * K
              + 2 * grid.n_rings * L1 / n_dev * 2 * K
              + grid.n_rings * n / n_dev * K) * dt
    return flops, bytes_


def sht_cell(shape_name: str, multi_pod: bool, *, fold: bool = False,
             comm_dtype: str | None = None, hw=HW_H100) -> dict:
    """The cell's configuration, grid, plan and counts (host only), and
    the cost model's time of the distributed transform on ``hw``
    (``roofline.analysis.predict_sht_time("dist")``: a model, not a
    measurement)."""
    scfg = SHT_SHAPES[shape_name]
    if comm_dtype is not None or fold:
        scfg = dataclasses.replace(scfg, fold=fold, comm_dtype=comm_dtype)
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    n_dev = int(np.prod(shape))
    g = grids.make_grid(scfg.grid, l_max=scfg.l_max)
    plan = SHTPlan(g, scfg.l_max, scfg.l_max, n_dev)
    flops, bytes_ = sht_corrected(scfg, g, n_dev, scfg.K)
    predicted = predict_sht_time(
        "dist", l_max=scfg.l_max, m_max=scfg.l_max, n_rings=g.n_rings,
        n_phi=g.max_n_phi, K=scfg.K, direction=scfg.direction, hw=hw,
        n_devices=n_dev)
    return {"sht_cfg": scfg, "sht_grid": g, "plan": plan,
            "n_devices": n_dev, "mesh_shape": shape, "mesh_axes": axes,
            "model_flops": sht_model_flops(scfg, g),
            "flops_per_device": flops, "bytes_per_device": bytes_,
            "predicted_s": predicted, "hw": hw.name}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             skip_existing: bool = True, **sht_kw) -> dict:
    """Write one cell's JSON record to ``out_dir`` and return it."""
    if arch != "sht_cmb":
        raise NotImplementedError(LM_CELLS)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh_kind}"
    extras = "_".join(f"{k}-{v}" for k, v in sorted(sht_kw.items())
                      if v not in (None, False))
    if extras:
        tag += "__" + extras
    path = os.path.join(out_dir, tag + ".json")
    if skip_existing and os.path.exists(path):
        print(f"[dryrun] {tag}: cached")
        with open(path) as f:
            return json.load(f)
    t0 = time.time()
    out = sht_cell(shape_name, mesh_kind == "multi", **sht_kw)
    plan = out["plan"]
    steps = plan.recurrence_steps_per_shard
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
           "status": "ok", "sht_cfg": dataclasses.asdict(out["sht_cfg"]),
           "mesh_shape": list(out["mesh_shape"]),
           "mesh_axes": list(out["mesh_axes"]),
           "n_devices": out["n_devices"],
           "plan": {"describe": plan.describe(), "m_local": plan.m_local,
                    "r_pad": plan.r_pad, "r_local": plan.r_local,
                    "steps_min": int(steps.min()),
                    "steps_max": int(steps.max())},
           "model_flops": out["model_flops"],
           "roofline": {"flops_per_device": out["flops_per_device"],
                        "bytes_per_device": out["bytes_per_device"]},
           "cost_model": {"hw": out["hw"],
                          "predicted_s": out["predicted_s"]},
           "n_params": 0, "n_active_params": 0,
           "no_counterpart": NO_COUNTERPART}
    rec["wall_s"] = time.time() - t0
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] {tag}: ok ({rec['wall_s']:.1f}s, "
          f"{plan.describe()})")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fold", action="store_true")
    ap.add_argument("--comm-dtype", default=None)
    a = ap.parse_args(argv)
    if a.arch != "sht_cmb":
        print(f"dryrun: --arch {a.arch}: {LM_CELLS}", file=sys.stderr)
        return 2
    if a.shape not in SHT_SHAPES:
        print(f"dryrun: unknown --shape {a.shape!r}; have "
              f"{sorted(SHT_SHAPES)}", file=sys.stderr)
        return 2
    run_cell(a.arch, a.shape, a.mesh, a.out, skip_existing=not a.force,
             fold=a.fold, comm_dtype=a.comm_dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
