"""Fit the H100 backend efficiencies of ``repro_torch.roofline.analysis``.

    PYTHONPATH=src python3 scripts/fit_h100_model.py

The cost model predicts one direction as

    t = (recurrence x s + fft) / (P v) + accumulation x s / (P x) + bytes / B

(``predict_sht_time``; s the layout's step overhead, P = 67 TFLOP/s and
B = 3.35 TB/s the data-sheet figures of ``HW_H100``), times
``anal_penalty`` for an analysis.  Each backend's v (``vector_eff``), x
(``matrix_eff``) and penalty are solved from one measured pair of
directions on one H100 80GB HBM3 at 700 W, the PERF.md row named beside
each input below:

* ``cuda_vpu``: the fused GL 4096/K1 spin-0 pair (PERF.md §5), v from the
  synthesis, the penalty from the analysis over the synthesis;
* ``cuda_mxu``: the fused GL 2048/K8 spin-0 pair (PERF.md §5), v taken from
  ``cuda_vpu`` (both run ``csrc/recurrence.cuh``'s step), x from the rest
  of the synthesis;
* ``torch``: its GL 2048/K8 spin-0 float32 pair, timed by
  ``chip_smoke.py`` phase 6 (PERF.md §6, the phase 6 result).

Prints the fitted figures, to be copied into ``BACKEND_MODELS``, and the
model's prediction of each input against its measurement.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import grids  # noqa: E402
from repro_torch.roofline import analysis as ra  # noqa: E402

#: (backend, grid l_max, K, layout, synthesis s, analysis s, source)
MEASURED = (
    ("cuda_vpu", 4096, 1, "fused", 31.29e-3, 34.71e-3,
     "PERF.md §5, GL 4096 K 1 fused spin 0 row"),
    ("cuda_mxu", 2048, 8, "fused", 12.32e-3, 14.54e-3,
     "PERF.md §5, GL 2048 K 8 fused spin 0 row"),
    ("torch", 2048, 8, None, 3.280377, 2.468730,
     "chip_smoke.py phase 6: torch corners of GL 2048 K 8 spin 0 "
     "(PERF.md §6, the phase 6 result)"),
)


def terms(l_max: int, K: int, layout):
    """(vector work, accumulation work, bytes) of one GL direction: the
    flops already scaled by the layout's step overhead, as
    ``predict_sht_time`` scales them."""
    g = grids.make_grid("gl", l_max=l_max)
    w = ra.sht_work(l_max, l_max, g.n_rings, g.max_n_phi, K)
    s, byts = 1.0, w["bytes"]
    if layout is not None:
        pc = w["panels"]
        s = pc["packed"] * pc["lp_size"] / pc["ideal_steps"]
        if layout == "fused":
            byts -= 16.0 * (l_max + 1) * g.n_rings * K
    return (w["recurrence_flops"] * s + w["fft_flops"],
            w["accum_flops"] * s, byts, g)


def main() -> int:
    hw = ra.HW_H100
    fit = {}
    rows = [r for r in MEASURED if r[4] is not None]
    for backend, l_max, K, layout, t_s, t_a, src in rows:
        vec, acc, byts, g = terms(l_max, K, layout)
        left = t_s - byts / hw.hbm_bw
        if backend == "cuda_mxu":
            v = fit["cuda_vpu"][0]
            x = acc / (hw.peak_flops * (left - vec / (hw.peak_flops * v)))
        else:
            v, x = (vec + acc) / (hw.peak_flops * left), 0.0
        fit[backend] = (_sig(v), _sig(x), _sig(t_a / t_s))
        print(f"{backend}: vector_eff={_sig(v)} matrix_eff={_sig(x)} "
              f"anal_penalty={_sig(t_a / t_s)}  ({src})")
        if fit[backend] != _in_code(backend, hw):
            print(f"  note: BACKEND_MODELS[{hw.name!r}][{backend!r}] holds "
                  f"other figures")
    for backend, l_max, K, layout, t_s, t_a, _ in rows:
        g = grids.make_grid("gl", l_max=l_max)
        kw = dict(l_max=l_max, m_max=l_max, n_rings=g.n_rings,
                  n_phi=g.max_n_phi, K=K, hw=hw,
                  layout="packed" if layout == "fused" else layout,
                  pipeline="fused" if layout == "fused" else "staged")
        p_s = ra.predict_sht_time(backend, direction="synth", **kw)
        p_a = ra.predict_sht_time(backend, direction="anal", **kw)
        print(f"{backend} GL {l_max} K {K}: predicted {p_s * 1e3:.3f} | "
              f"{p_a * 1e3:.3f} ms, measured {t_s * 1e3:.3f} | "
              f"{t_a * 1e3:.3f} ms")
    return 0


def _sig(v: float) -> float:
    """``v`` to four significant digits, as BACKEND_MODELS holds it."""
    return float(f"{v:.4g}")


def _in_code(backend: str, hw) -> tuple:
    m = ra.BACKEND_MODELS[hw.name][backend]
    return (m.vector_eff, m.matrix_eff, m.anal_penalty)


if __name__ == "__main__":
    sys.exit(main())
