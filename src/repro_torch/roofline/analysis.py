"""The analytic SHT cost model behind ``make_plan(mode="model")``.

Counterpart of the cost-model part of ``repro.roofline.analysis``: the
operation counts of one transform direction (:func:`sht_work`), the
Legendre stage's plain-vs-packed grid accounting
(:func:`legendre_panel_counts`), and a per-backend effective-throughput
model (:class:`BackendModel`) that turns them into predicted seconds
(:func:`predict_sht_time`).  The backends are the port's: ``torch`` (the
reference's ``jnp``), ``cuda_vpu`` and ``cuda_mxu`` (``pallas_vpu``,
``pallas_mxu``).

Two machines are modelled.  :data:`HW_HOST` is the reference's crude
single-host CPU model, with the reference's backend efficiencies under the
port's names, so a CPU plan's decisions can be held against the
reference's.  :data:`HW_H100` carries NVIDIA's data-sheet figures of one
H100 SXM at 700 W, and its backend efficiencies are fitted to the port's
own times on that card (``scripts/fit_h100_model.py`` prints the fit and
names the PERF.md row of each input).

The ``dist`` backend (``core.dist_sht``) is modelled as the reference
does: the best local kernel's time over the device count plus one
all-to-all of the Delta block on the wire, or, with a chunked exchange,
the overlapped pipeline; :func:`predict_comm_chunks` picks its chunk
count.  Not ported: ``analyze_compiled``, ``parse_hlo_collectives`` and
``collective_bytes`` read XLA's compiled HLO, which PyTorch does not
produce.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Hardware", "HW_HOST", "HW_H100", "BackendModel",
           "BACKEND_MODELS", "sht_work", "legendre_panel_counts",
           "predict_sht_time", "predict_comm_chunks", "hardware_for"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float        # FLOP/s of the type the model counts
    hbm_bw: float            # device memory bytes/s
    link_bw: float           # bytes/s to a peer device, each way
    coll_latency: float = 1e-6   # launch latency per collective [s]


#: The reference's single-host CPU model, as it is: the absolute numbers
#: matter less than the per-backend ranking.
HW_HOST = Hardware("host-cpu", 2e11, 5e10, 1e10, coll_latency=1e-5)

#: One NVIDIA H100 SXM at 700 W, NVIDIA's data sheet: 67 TFLOP/s float32
#: outside the tensor cores (the kernels' float32 recurrence and sums),
#: 3.35 TB/s HBM3, NVLink 900 GB/s all to all (450 GB/s each way).
HW_H100 = Hardware("h100-sxm", 67e12, 3.35e12, 450e9)


@dataclasses.dataclass(frozen=True)
class BackendModel:
    """Effective-throughput model of one execution backend on one machine.

    ``vector_eff``/``matrix_eff`` are fractions of ``Hardware.peak_flops``
    reached on the recurrence (and FFT) work and on the accumulation;
    ``matrix_eff = 0`` puts the accumulation at ``vector_eff`` too.
    ``anal_penalty`` scales the analysis direction (the paper's
    direct/inverse dichotomy, §5: the ring reduction costs extra).
    """

    name: str
    vector_eff: float
    matrix_eff: float = 0.0
    anal_penalty: float = 1.0


#: Per machine, per backend.  ``host-cpu``: the reference's figures
#: (``repro/roofline/analysis.py`` ``BACKEND_MODELS``: jnp, pallas_vpu,
#: pallas_mxu) under the port's names.  ``h100-sxm``: fitted by
#: ``scripts/fit_h100_model.py`` to the port's times on one H100 80GB HBM3
#: at 700 W: ``cuda_vpu`` to the fused GL 4096/K1 spin-0 pair (PERF.md §5's
#: row: alm2map 31.29 ms, map2alm 34.71), ``cuda_mxu`` to the fused GL
#: 2048/K8 spin-0 pair (the same table: 12.32, 14.54 ms) with the vpu
#: recurrence rate (both run ``csrc/recurrence.cuh``'s step), ``torch`` to
#: its GL 2048/K8 spin-0 float32 pair timed by ``chip_smoke.py`` phase 6
#: (3280.4 | 2468.7 ms; PERF.md §6, the phase 6 result).  ``dist``: on
#: ``host-cpu`` the reference's figures; on ``h100-sxm`` the ``cuda_mxu``
#: efficiencies as they are (its ranks run the staged mxu kernels), not a
#: fit: no multi-card time of the port exists to fit them to.
BACKEND_MODELS = {
    "host-cpu": {
        "torch": BackendModel("torch", vector_eff=0.01, anal_penalty=1.0),
        "cuda_vpu": BackendModel("cuda_vpu", vector_eff=0.08,
                                 anal_penalty=1.3),
        "cuda_mxu": BackendModel("cuda_mxu", vector_eff=0.06,
                                 matrix_eff=0.4, anal_penalty=1.2),
        "dist": BackendModel("dist", vector_eff=0.06, matrix_eff=0.4,
                             anal_penalty=1.2),
    },
    "h100-sxm": {
        "torch": BackendModel("torch", vector_eff=0.0008408,
                              anal_penalty=0.7526),
        "cuda_vpu": BackendModel("cuda_vpu", vector_eff=0.2391,
                                 anal_penalty=1.109),
        "cuda_mxu": BackendModel("cuda_mxu", vector_eff=0.2391,
                                 matrix_eff=0.2454, anal_penalty=1.180),
        "dist": BackendModel("dist", vector_eff=0.2391, matrix_eff=0.2454,
                             anal_penalty=1.180),
    },
}


def hardware_for(device) -> Hardware:
    """The model of the machine a plan runs on: :data:`HW_H100` for a CUDA
    device, :data:`HW_HOST` for the CPU."""
    return HW_H100 if getattr(device, "type", device) == "cuda" else HW_HOST


def sht_work(l_max: int, m_max: int, n_rings: int, n_phi: int,
             K: int, fft_lengths=None, spin: int = 0) -> dict:
    """Operation counts of one transform direction (paper §3 complexity),
    as the reference counts them.

    ``recurrence_flops``: P_lm generation, ~10 flops per (l, m, ring) step,
    K-independent; ``accum_flops``: the a_lm / Delta_m contraction, 4K
    flops per (l, m, ring); ``fft_flops``: the ring FFTs, per bucketed ring
    with ``fft_lengths`` (a ragged grid's phase stage), else at one n_phi;
    ``bytes``: alm + maps + Delta traffic; ``panels``: the Legendre grid
    accounting (:func:`legendre_panel_counts`).  ``spin=2`` doubles every
    term (two Wigner-d recurrences per m, two components, two maps).
    """
    ncomp = 1 if spin == 0 else 2
    n_lm = (m_max + 1) * (l_max + 1) - m_max * (m_max + 1) // 2
    rec = 10.0 * n_lm * n_rings * ncomp
    acc = 4.0 * n_lm * n_rings * K * ncomp
    if fft_lengths is not None:
        fl = np.asarray(fft_lengths, dtype=np.float64)
        fft = 5.0 * float(np.sum(fl * np.log2(np.maximum(fl, 2.0)))) * K
        maps_elems = float(np.sum(fl)) * K
    else:
        fft = 5.0 * n_rings * n_phi * float(np.log2(max(n_phi, 2))) * K
        maps_elems = float(n_rings * n_phi) * K
    fft *= ncomp
    maps_elems *= ncomp
    byts = (16.0 * (m_max + 1) * (l_max + 1) * K * ncomp   # alm (complex)
            + 8.0 * maps_elems                             # maps
            + 16.0 * (m_max + 1) * n_rings * K * ncomp)    # Delta (complex)
    return {"n_lm": n_lm, "recurrence_flops": rec, "accum_flops": acc,
            "fft_flops": fft, "bytes": byts,
            "total_flops": rec + acc + fft,
            "panels": legendre_panel_counts(l_max, m_max, spin=spin)}


def legendre_panel_counts(l_max: int, m_max: int, *, lp_size: int = 128,
                          spin: int = 0) -> dict:
    """Grid-step accounting of the Legendre stage, plain vs packed, on the
    canonical row set (``m = 0..m_max``; the doubled m' = -2 | +2 rows for
    ``spin=2``): ``kernels.pack.panel_counts``, so the model and the
    layouts agree by construction."""
    from repro_torch.kernels import pack
    m = np.arange(m_max + 1)
    if spin:
        m2 = np.concatenate([m, m])
        mp2 = np.concatenate([np.full(m_max + 1, -2), np.full(m_max + 1, 2)])
        return pack.panel_counts(m2, l_max, lp_size=lp_size, mp_vals=mp2)
    return pack.panel_counts(m, l_max, lp_size=lp_size)


def predict_sht_time(backend: str, *, l_max: int, m_max: int, n_rings: int,
                     n_phi: int, K: int, direction: str = "synth",
                     hw: Hardware = HW_H100, n_devices: int = 1,
                     fft_lengths=None, spin: int = 0, layout: str = None,
                     pipeline: str = "staged", overlap: bool = False,
                     comm_chunks: int = 1) -> float:
    """Predicted seconds of one transform direction on ``backend``.

    compute = recurrence / vector rate + accumulation / (matrix or vector
    rate) + FFT / vector rate; memory = bytes / HBM rate; the terms add (the
    stages run one after another), times ``anal_penalty`` for
    ``direction="anal"``.  On the kernel backends ``layout`` (``"plain"`` |
    ``"packed"``) scales the Legendre terms by that grid's executed steps
    over the triangular ideal, and ``pipeline="fused"`` drops Delta's bytes
    (it never reaches device memory).

    ``dist`` on ``n_devices > 1``: the local time over ``n_devices`` plus
    one all-to-all of the (M, R, ncomp 2K) Delta block, its wire bytes over
    ``hw.link_bw``; with ``overlap=True`` and ``comm_chunks=C > 1`` the
    chunked pipeline instead,

        comp/C + comm_chunk + (C-1) * max(comp/C, comm_chunk),

    where ``comm_chunk = comm/C + hw.coll_latency`` (each chunk's exchange
    hides behind the adjacent chunk's compute, at one more collective
    latency a chunk).  ``C=1`` gives the serial sum.  The reference's
    formula.
    """
    models = BACKEND_MODELS[hw.name]
    if backend not in models:
        raise ValueError(f"unknown backend {backend!r}")
    if pipeline not in ("staged", "fused"):
        raise ValueError(f"unknown pipeline {pipeline!r}")
    m = models[backend]
    w = sht_work(l_max, m_max, n_rings, n_phi, K, fft_lengths=fft_lengths,
                 spin=spin)
    kernel = backend.startswith("cuda")
    ncomp = 1 if spin == 0 else 2
    byts = w["bytes"]
    if pipeline == "fused" and kernel:
        byts -= 16.0 * (m_max + 1) * n_rings * K * ncomp   # Delta stays on-chip
    leg_scale = 1.0
    if layout in ("plain", "packed") and kernel:
        pc = w["panels"]
        steps = (pc["plain_worked"] if layout == "plain" else pc["packed"]) \
            * pc["lp_size"]
        if pc["ideal_steps"] > 0:
            leg_scale = steps / pc["ideal_steps"]
    vec_rate = hw.peak_flops * m.vector_eff
    t = w["recurrence_flops"] * leg_scale / vec_rate \
        + w["fft_flops"] / vec_rate
    if m.matrix_eff > 0:
        t += w["accum_flops"] * leg_scale / (hw.peak_flops * m.matrix_eff)
    else:
        t += w["accum_flops"] * leg_scale / vec_rate
    t += byts / hw.hbm_bw
    if backend == "dist" and n_devices > 1:
        t /= n_devices
        # one all-to-all of the (M, R, ncomp 2K) Delta block
        wire = 16.0 * (m_max + 1) * n_rings * K * ncomp / n_devices \
            * (n_devices - 1) / n_devices
        comm = wire / hw.link_bw
        C = max(1, int(comm_chunks))
        if overlap and C > 1 and comm > 0.0:
            comp_c = t / C
            comm_c = comm / C + hw.coll_latency
            t = comp_c + comm_c + (C - 1) * max(comp_c, comm_c)
        else:
            t += comm
    if direction == "anal":
        t *= m.anal_penalty
    return float(t)


def predict_comm_chunks(*, l_max: int, m_max: int, n_rings: int, n_phi: int,
                        K: int, direction: str = "synth",
                        hw: Hardware = HW_H100, n_devices: int = 1,
                        fft_lengths=None, spin: int = 0,
                        max_chunks: int = 64) -> int:
    """The model's ``comm_chunks`` for the dist backend's chunked exchange:
    the argmin over powers of two of the overlapped
    :func:`predict_sht_time`, capped by what the plan can split (the K map
    axis, else the local m rows, as ``SHTPlan.chunk_schedule``)."""
    if n_devices <= 1:
        return 1
    m_local = max(1, -(-(m_max + 2) // (2 * max(1, n_devices))) * 2)
    cap = min(max_chunks, max(int(K), m_local))
    cands = [1]
    while cands[-1] * 2 <= cap:
        cands.append(cands[-1] * 2)
    t_of = {c: predict_sht_time(
        "dist", l_max=l_max, m_max=m_max, n_rings=n_rings, n_phi=n_phi,
        K=K, direction=direction, hw=hw, n_devices=n_devices,
        fft_lengths=fft_lengths, spin=spin, overlap=True, comm_chunks=c)
        for c in cands}
    return int(min(t_of, key=t_of.get))
