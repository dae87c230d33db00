"""Alpha-beta performance model of the parallel SHT (paper §4.1.2).

Counterpart of ``repro.core.comm_model``, pure math ported as it is.  It
reproduces the paper's analysis (eqs. 16-17 and Fig. 4): the one global
all-to-all that exchanges the Delta arrays, modelled by MPICH's algorithm
switch (Bruck's index algorithm for short messages, pairwise exchange for
long ones), against a gamma-per-flop model of the recurrence and FFT
stages.  Its constants are the paper's (``MPICH_CLUSTER``) and the
reference's TPU v5e ones (``TPU_V5E_ICI``): named inputs of the model, not
measurements of any card this port runs on.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CommParams", "MPICH_CLUSTER", "TPU_V5E_ICI", "sht_times",
           "sht_times_overlap", "best_chunks", "crossover_nproc"]


@dataclasses.dataclass(frozen=True)
class CommParams:
    """alpha: latency per message [s]; beta: inverse bandwidth [s/byte];
    gamma: seconds per flop of an MPI process / chip;
    bruck_cutoff: message size [bytes] below which the Bruck algorithm is
    assumed (paper: MPICH switches at 256 kB)."""
    alpha: float
    beta: float
    gamma: float
    bruck_cutoff: float = 256e3
    name: str = ""


# The paper's indicative constants (§4.1.2): alpha = 1e-5 s, beta = 1e-9 s/B,
# 10 Gflop/s effective per MPI process.
MPICH_CLUSTER = CommParams(alpha=1e-5, beta=1e-9, gamma=1e-10,
                           name="paper-cluster")

# TPU v5e ICI: ~50 GB/s per link, ~1 us effective collective latency,
# 197 Tflop/s bf16 peak with a realistic 40% recurrence efficiency.
TPU_V5E_ICI = CommParams(alpha=1e-6, beta=1.0 / 50e9,
                         gamma=1.0 / (0.4 * 197e12), name="tpu-v5e")


def message_size(r_n: int, m_max: int, n_proc: int, n_c: int = 16) -> float:
    """Paper eq. 16: bytes exchanged between each pair of processes."""
    return r_n * (m_max / n_proc) * n_c


def t_comm(r_n: int, m_max: int, n_proc: int, p: CommParams,
           n_c: int = 16) -> float:
    """Paper eq. 17: total all-to-all time."""
    if n_proc <= 1:
        return 0.0
    s = message_size(r_n, m_max, n_proc, n_c)
    if s <= p.bruck_cutoff:
        return p.alpha * np.log2(n_proc) + p.beta * s * (n_proc / 2.0) * np.log2(n_proc)
    return p.alpha * (n_proc - 1) + p.beta * s * (n_proc - 1)


def t_recurrence(r_n: int, l_max: int, m_max: int, n_proc: int,
                 p: CommParams, flops_per_step: float = 14.0,
                 fold: bool = False) -> float:
    """Legendre stage: O(R_N * l_max * m_max / n_proc) steps (paper Table 1).

    ``flops_per_step`` counts recurrence + rescale + accumulate per
    (ring, l, m) triple; the triangular l >= m structure contributes the 1/2.
    """
    steps = 0.5 * r_n * l_max * (m_max / n_proc)
    if fold:
        steps *= 0.75  # recurrence flops halve; accumulate flops unchanged
    return p.gamma * flops_per_step * steps


def t_fft(r_n: int, m_max: int, n_proc: int, p: CommParams,
          flops_per_point: float = 5.0) -> float:
    """FFT stage: O(R_N/n_proc * m_max log m_max) (paper Table 1)."""
    n = max(m_max, 2)
    return p.gamma * flops_per_point * (r_n / n_proc) * n * np.log2(n)


def t_precompute(m_max: int, p: CommParams) -> float:
    """Redundant seed precomputation, O(m_max) per process (paper Table 1)."""
    return p.gamma * 10.0 * m_max


def sht_times(n_side: int, n_proc: int, p: CommParams,
              l_max: int | None = None, fold: bool = False) -> dict:
    """Full model for a HEALPix-parameterised problem (paper Fig. 4 setup):
    l_max = m_max = 2 n_side, R_N = 4 n_side - 1."""
    l_max = 2 * n_side if l_max is None else l_max
    m_max = l_max
    r_n = 4 * n_side - 1
    comp = (t_recurrence(r_n, l_max, m_max, n_proc, p, fold=fold)
            + t_fft(r_n, m_max, n_proc, p) + t_precompute(m_max, p))
    comm = t_comm(r_n, m_max, n_proc, p)
    return {"compute": comp, "comm": comm, "total": comp + comm,
            "msg_bytes": message_size(r_n, m_max, n_proc)}


def sht_times_overlap(n_side: int, n_proc: int, p: CommParams,
                      chunks: int | None = None, l_max: int | None = None,
                      fold: bool = False, max_chunks: int = 256) -> dict:
    """Chunked-exchange pipeline model (the comm/compute-overlap analogue
    of the paper's eq. 16-17 serial sum).

    The Delta block is split into C chunks; chunk i's collective is
    issued while chunk i+1 computes, so the steady state advances at
    ``max(comp_chunk, comm_chunk)`` per chunk with one compute chunk of
    pipeline *fill* and one comm chunk of *drain*:

        t_overlap = comp/C + comm_chunk + (C-1) * max(comp/C, comm_chunk)
        comm_chunk = comm/C + alpha        (chunking splits the payload;
                                            every extra chunk pays one more
                                            collective-launch latency)

    ``chunks=None`` scans powers of two up to ``max_chunks`` and keeps the
    argmin.  ``hidden_frac`` reports the realised fraction of the
    *hideable* time ``min(comp, comm)`` -- the serial term a perfect
    pipeline removes from the critical path (in the communication-bound
    regime the paper's Fig. 4 predicts everywhere at scale, that is the
    whole compute stage disappearing behind the wire).
    """
    base = sht_times(n_side, n_proc, p, l_max=l_max, fold=fold)
    comp, comm = base["compute"], base["comm"]
    serial = comp + comm

    def total(c: int) -> float:
        if c <= 1 or n_proc <= 1 or comm <= 0.0:
            return serial
        comp_c = comp / c
        comm_c = comm / c + p.alpha
        return comp_c + comm_c + (c - 1) * max(comp_c, comm_c)

    if chunks is None:
        cands = [1 << k for k in range(0, 17) if (1 << k) <= max_chunks]
        chunks = min(cands, key=total)
    chunks = max(1, int(chunks))
    t = total(chunks)
    hideable = min(comp, comm)
    hidden = max(0.0, serial - t)
    return {**base, "chunks": chunks, "serial": serial, "overlap": t,
            "total": t, "hidden": hidden,
            "hidden_frac": hidden / hideable if hideable > 0 else 0.0}


def best_chunks(n_side: int, n_proc: int, p: CommParams,
                max_chunks: int = 256, l_max: int | None = None,
                fold: bool = False) -> int:
    """Model-optimal chunk count (argmin of `sht_times_overlap`)."""
    return int(sht_times_overlap(n_side, n_proc, p, chunks=None, l_max=l_max,
                                 fold=fold, max_chunks=max_chunks)["chunks"])


def crossover_nproc(n_side: int, p: CommParams, n_max: int = 1 << 16) -> int:
    """Smallest process count where comm >= compute (paper Fig. 4 right
    panel, the contour labelled 1.0)."""
    for k in range(0, 17):
        n = 1 << k
        if n > n_max:
            break
        t = sht_times(n_side, n, p)
        if t["comm"] >= t["compute"]:
            return n
    return n_max
