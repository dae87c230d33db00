"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout (one ``nvcc``
per source, started together), holds each against its plain PyTorch
version on the card, drives the port's main paths at the repo's full
widths (``make_plan("gl", ...)`` then ``alm2map`` then ``map2alm``, the
``sht_cmb`` shapes l_max 2048 K 8 and l_max 4096 K 1, on the fused layout
the plans pick by default and on the staged plain layout, and the packed
staged layout at l_max 1024), checks that every kernel of each path launched, prints a
digest of each kernel's output and holds the bits equal where two layouts
run the same code, times each kernel beside its bound, anchors every
kernel plan to the float64 ``torch`` plan, and takes gradients through
the plans on the card (dot identities on every layout, one full-width
step whose backward must run the other direction's kernels).  Every phase
runs twice: for the spin-0 transform pair and for the spin-2 one
(``make_plan(..., spin=2)``: (E, B) alm <-> (Q, U) maps), whose paths
launch the spin branch of every kernel.  The costliest checks (the GL
4096/K1 spin-2 paths, HEALPix 2048/K1, the HEALPix 1024/K8 spin-2 paths,
the vpu fold check, the bf16 spin-2 path) run their kernels at full depth
on every ring and hold them against their plain versions on every 8th
ring (``RING_STRIDE``), for the time limit.  The
ragged-grid paths follow
the GL ones: HEALPix (nside 1024, K 8, fused and plain, spin 0 and 2;
nside 2048, K 1, fused), ring-uniform HEALPix (nside 1024) and ECP (l_max
2048) through the ring-bucket or uniform phase stage, each synthesis and
analysis rerun for identical bits (as is the analysis of the GL vpu fused
and plain paths, whose template sums its rings in a fixed order of its
own), the vpu kernels (GL 4096/K1) and the mxu synthesis kernels (GL
2048/K8) held with the equator fold; then the bfloat16 branch of the
fused mxu kernels (``Plan._make_fused_synth/_make_fused_anal("mxu",
bf16=True)``) at GL 2048/K8 and HEALPix 1024/K8, held to the reference's
band against float32 and to its plain version.  Last, the cost model and
the measured autotune (``make_plan(mode="model")`` and ``mode="auto"``
with its decision cached on disk) at GL 2048/K8, spin 0 and 2: every
corner's prediction beside its measurement, the choice held to the
measured minimum, a second build that measures nothing, and the chosen
plan's round trip.  Then the serving engine (``repro_torch.serve``) at
GL 2048 float32, spin 0 and 2: a double-buffered engine serves 40 numpy
requests (alm2map and map2alm, K buckets 1 to 8 over the fused kernels
9 to 12, background warm-ups), its launches held to what its batch log
implies, each result to a K=1 plan of its batch's backend and layout, a
replayed batch to the engine's bits; a synchronous engine whose p99
target the H100 cost model caps at K 4; and ``python -m
repro_torch.launch.serve`` on the card.  Last, the distributed transform
(``core.dist_sht.DistSHT``) on a NCCL group of one rank at GL 2048/K8:
both directions, spin 0 and 2, one exchange and two chunks, against the
serial plain plan (synthesis bit for bit), each of 4 ranks' dealt rows
through the stage-1 adapters (plain and packed kernels), the vpu variant
at K 1, the bfloat16 exchange and a dot identity through autograd, with
kernels 1-8 counted on the dist path.  Last, the dense decoders' serving
path (``repro_torch.models``, no hand-written kernel on it): qwen3-8b at
its published widths and full depth in bfloat16, weights drawn on the
card from a seed, prefills B 4 x 512 tokens and decodes 32 steps through
``make_bundle(...).prefill_fn`` / ``decode_fn`` (times, tokens/s, peak
memory), holds its prefill to token-by-token decode and runs one loss
forward; then the same widths in float32 at two layers, card against
the CPU on the same weights.  The SHT shapes come from
``repro_torch.configs.sht_cmb.SHT_SHAPES``.  Each phase and each path
logs its wall seconds and the seconds of its plain-version calls,
gathered in a timeline at the end.
Prints the card's name and power limit, one JSON line of per-kernel
numbers, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, without a CUDA device or without the
rest of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import repro_torch  # noqa: E402
from repro_torch.core import sht, spectra  # noqa: E402
from repro_torch.kernels import build, fused, fused_cuda, ops, pack  # noqa: E402
from repro_torch.kernels import legendre_cuda as lc  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.core import grids, legendre  # noqa: E402
from repro_torch.configs import registry as model_registry  # noqa: E402
from repro_torch.configs.sht_cmb import SHT_SHAPES  # noqa: E402
from repro_torch.models.model import make_bundle  # noqa: E402

#: H100 SXM datasheet peaks (dense, 700 W): float32 on the CUDA cores, bf16
#: on the tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

#: kernel vs plain version on the card, relative to max|plain|: the limit
#: the CPU tests hold the plain version to against the reference.  Kernel
#: and plain version round every recurrence operation alike and differ
#: only in how the sums round, which stays far below it.
KERNEL_TOL = 5e-5
#: float32 round trip at the full widths (the reference's float32 plan grows
#: roughly linearly in l_max: 2.5e-5 at l_max 512)
ROUNDTRIP_TOL = 1e-3
#: float32 kernel plans vs the float64 torch plan at l_max 512
ANCHOR_TOL = 1e-3
#: float32 kernel plans vs the float64 torch plan on the ragged grids at
#: l_max 512: the max-norm error of the float32 scheme itself sits at the
#: GL limit there (the reference's own float32 plan: 0.98e-3 on HEALPix
#: nside 256 spin 0 and 1.04e-3 on GL l_max 512 for a uniform draw; the
#: port's float32 schedule 1.47e-3 and 1.29e-3, kernels' plain versions on
#: the CPU), so these anchors take twice the GL limit
RAGGED_ANCHOR_TOL = 2e-3
#: round trip with one Jacobi pass on the approximate-quadrature grids
#: (HEALPix, ring-uniform HEALPix, ECP), 10x the GL band: their theta
#: quadrature is approximate (float64 at nside 256, iters=1: ~5e-5), and a
#: broken kernel gives O(1)
QUAD_ROUNDTRIP_TOL = 1e-2
#: bf16 kernels vs their bf16 plain versions: both round the same float32
#: panel and rows to bfloat16 and form exact float32 products, so only the
#: order of the float32 sums differs
BF16_KERNEL_TOL = 1e-5
#: the reference's band for bf16 against float32 (tests/test_fused.py):
#: 0 < err < 1e-2; err > 0 catches a path that stays in float32
BF16_GATE = 1e-2
#: the sht_cmb shapes (``repro_torch.configs.sht_cmb.SHT_SHAPES``) the
#: main paths, the gradient step and phases 6-8 run at
SYNTH_2K = SHT_SHAPES["synth_2k_k8"]
SYNTH_4K = SHT_SHAPES["synth_4k_k1"]
#: l_max of the kernel checks (phase 2) and the dot identities (phase 5),
#: of the float64 anchor (phase 4), and (l_max, K) of the full-width
#: gradient step (phase 5): the sht_cmb main shape of the mxu variant
CHECK_L_MAX = 256
ANCHOR_L_MAX = 512
GRAD_SHAPE = (SYNTH_2K.l_max, SYNTH_2K.K)
#: the plan-level dot identity <A x, y> = <x, A^T y> through autograd in
#: float32: the reference's band (tests/test_adjoint.py)
DOT_TOL = 2e-3

TPU_KERNELS = {
    "synth_vpu": "src/repro/kernels/legendre_pallas.py:222",
    "synth_mxu": "src/repro/kernels/legendre_pallas.py:326",
    "anal_vpu": "src/repro/kernels/legendre_pallas.py:436",
    "anal_mxu": "src/repro/kernels/legendre_pallas.py:1042",
    "anal_reduce": "src/repro/kernels/legendre_pallas.py:430",
    "synth_fused_vpu": "src/repro/kernels/fused.py:222",
    "synth_fused_mxu": "src/repro/kernels/fused.py:385",
    "anal_fused_vpu": "src/repro/kernels/fused.py:526",
    "anal_fused_mxu": "src/repro/kernels/fused.py:666",
    "synth_fused_mxu_bf16": "src/repro/kernels/fused.py:385",
    "anal_fused_mxu_bf16": "src/repro/kernels/fused.py:666",
    "synth_packed_vpu": "src/repro/kernels/legendre_pallas.py:591",
    "synth_packed_mxu": "src/repro/kernels/legendre_pallas.py:698",
    "anal_packed_vpu": "src/repro/kernels/legendre_pallas.py:814",
    "anal_packed_mxu": "src/repro/kernels/legendre_pallas.py:937",
}
SOURCES = {name: ("src/repro_torch/kernels/csrc/fused.cu"
                  if "fused" in name or "packed" in name
                  else "src/repro_torch/kernels/csrc/legendre.cu")
           for name in TPU_KERNELS}
#: the spin branch of every kernel: `_f32_step_spin`, selected by `_step`
SPIN_STEP = "src/repro/kernels/legendre_pallas.py:116"


def base_name(name: str) -> str:
    """A kernel's name without the ``_spin`` of its spin branch's counter."""
    return name[:-len("_spin")] if name.endswith("_spin") else name


def tag(spin: bool) -> str:
    """The counter suffix of the spin branch."""
    return "_spin" if spin else ""


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


#: (label, wall s, plain-version s) of each stamped phase and path, in order
TIMELINE: list = []
#: the labels being stamped (outermost first), and their plain-version s
_ACTIVE: list = []
_PLAIN_S: dict = {}


@contextlib.contextmanager
def stamped(label: str):
    """Stamp a phase or path: its wall seconds and the seconds its
    plain-version calls took (nested stamps count in each) go to TIMELINE,
    and the seconds are logged as the stamp closes."""
    _ACTIVE.append(label)
    _PLAIN_S[label] = 0.0
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _ACTIVE.pop()
        wall = time.perf_counter() - t0
        TIMELINE.append((label, wall, _PLAIN_S.pop(label)))
        log(f"  {elapsed()} [{label}] {wall:.1f} s, plain versions "
            f"{TIMELINE[-1][2]:.1f} s")


def count_plain_seconds() -> None:
    """Wrap each plain version of ``kernels.ref`` (the ``*_ref``
    functions) so that its calls, synchronised on both sides, add their
    wall seconds to every stamp open."""
    for name in kref.__all__:
        if not name.endswith("_ref"):
            continue

        def timed(*args, _fn=getattr(kref, name), **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            for label in _ACTIVE:
                _PLAIN_S[label] += time.perf_counter() - t0
            return out

        setattr(kref, name, timed)


def elapsed() -> str:
    """Seconds since the script started, for the log's landmarks."""
    return f"[{time.perf_counter() - _T0:.1f} s]"


def cuda_time_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 3) -> float:
    """Mean wall time of ``fn()`` ending in a device synchronise, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def seeds_for(l_max: int, m_vals, fold: bool, dev, mp_vals=None):
    """(m_vals, x, pmm, pms) kernel operands on ``dev`` for a GL grid; with
    ``mp_vals`` the spin seeds of the (m, m') rows (fold off)."""
    g = grids.make_grid("gl", l_max=l_max)
    nh = (g.n_rings + 1) // 2
    sin = g.sin_theta[:nh] if fold else g.sin_theta
    x = g.cos_theta[:nh] if fold else g.cos_theta
    if mp_vals is None:
        pmm, pms = kref.prepare_seeds(m_vals, sin, legendre.log_mu(l_max))
    else:
        pmm, pms = kref.prepare_seeds_spin(m_vals, mp_vals, x, sin,
                                           m_max=l_max)
    return (torch.as_tensor(np.asarray(m_vals), dtype=torch.int32, device=dev),
            torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(pmm, device=dev), torch.as_tensor(pms, device=dev))


def row_start(m_vals, mp_vals=None) -> np.ndarray:
    """Each row's first multipole: m, or max(m, |m'|) for the spin rows."""
    m = np.asarray(m_vals)
    return m if mp_vals is None else np.maximum(m, np.abs(mp_vals))


def random_a(gen, m_vals, L, K2, dev, mp_vals=None):
    """(Mp, L, 2K) f32 coefficients, zero where l < l0 (m, or max(m, |m'|)
    with ``mp_vals``) and on padding rows."""
    m = torch.as_tensor(np.asarray(m_vals))[:, None]
    l0 = torch.as_tensor(row_start(m_vals, mp_vals))[:, None]
    a = torch.rand((len(m_vals), L, K2), generator=gen) * 2 - 1
    keep = (m >= 0) & (torch.arange(L)[None, :] >= l0)
    return (a * keep[..., None]).to(dev)


def spin_test_rows(l_max: int) -> tuple:
    """The 2M spin rows of l_max, one of them made a padding row (m = -1),
    so the live row count is odd: (m_vals, mp_vals) numpy."""
    m2, mp2 = ops.spin_rows(np.arange(l_max + 1))
    m2[17] = -1
    return m2, mp2


def legendre_work(m_vals, l_end: int, rings: int, K2: int,
                  mp_vals=None) -> tuple:
    """(triples, flops) of one Legendre pass: each (row, l >= l0, ring)
    triple costs 4 float32 operations of recurrence (5 for the spin rows,
    ``mp_vals`` given: (a x + b) p - c q) and 2 per channel."""
    l0 = row_start(m_vals, mp_vals)
    live = np.asarray(m_vals) >= 0
    triples = int(np.sum(np.clip(l_end - l0[live], 0, None))) * rings
    return triples, triples * ((4 if mp_vals is None else 5) + 2 * K2)


def bound_ms(flops: float, nbytes: float, bf16_flops: float = 0.0) -> tuple:
    """The larger of the operations time (float32 ``flops`` on the CUDA
    cores plus ``bf16_flops`` on the tensor cores) and the bytes time."""
    t_ops = (flops / PEAK_F32_FLOPS + bf16_flops / PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts if t is not None))


def rotation_ops(tab, K: int) -> int:
    """Float32 operations of the in-kernel rotation: 8 per (row, plane,
    ring) and map where tables are applied."""
    return 0 if tab is None else tab.shape[0] * 2 * tab.shape[2] \
        * tab.shape[4] * 8 * K


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version at l_max 256
# ---------------------------------------------------------------------------


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def held(name: str, got: torch.Tensor, want: torch.Tensor, what: str,
         pad=None, tol: float = KERNEL_TOL) -> float:
    """Hold a kernel's output against its plain version's at ``tol``
    (relative to max|plain|), padding rows exactly zero; log the gap and
    both outputs' digests, and return max|difference|."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    zero_pad = pad is None or bool((got[pad] == 0).all())
    log(f"  {name:15s} {what}: max|d|/max|plain| = {rel:.3e}"
        + ("" if pad is None else f"  padding zero: {zero_pad}")
        + f"  digest {digest(got)} (plain {digest(want)})")
    if not (rel < tol and zero_pad):
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({what})")
    return err


def below_zero(name: str, out: torch.Tensor, m_vals, mp_vals) -> None:
    """The analysis rows l < max(m, |m'|) of live spin rows must be exact
    zeros (nothing exists below a row's first multipole)."""
    l0 = torch.as_tensor(row_start(m_vals, mp_vals), device=out.device)
    l = torch.arange(out.shape[1], device=out.device)
    below = (torch.as_tensor(np.asarray(m_vals) >= 0, device=out.device)
             [:, None] & (l[None, :] < l0[:, None]))
    ok = bool((out[below] == 0).all())
    log(f"  {name:15s} rows l < max(m, |m'|) exactly zero: {ok} "
        f"({int(below.sum())} rows)")
    if not ok:
        raise AssertionError(f"{name}: nonzero rows below l0")


def check_rows(l_max: int, spin: bool) -> tuple:
    """(m_vals, mp_vals) of the staged-kernel checks: every m of l_max with
    plan padding (-1 rows, which must come out exactly zero) among the real
    ones, or with ``spin`` the 2M spin rows."""
    if spin:
        return spin_test_rows(l_max)
    m_vals = np.concatenate([np.arange(l_max + 1), [-1, -1]])
    return np.insert(m_vals, 17, -1), None


def check_gen(spin: bool) -> torch.Generator:
    """The generator of :func:`check_kernels`' random operands."""
    return torch.Generator().manual_seed(2 + 100 * spin)


def check_cases(dev, spin: bool, gen: torch.Generator):
    """:func:`check_kernels`' operands at l_max CHECK_L_MAX, drawn from
    ``gen`` in its order: per fold (off only with ``spin``) and K in (1, 8),
    (fold, K, seeds (m_t, x, pmm, pms), keyword arguments, coefficient rows
    a, Delta rows dw)."""
    l_max = CHECK_L_MAX
    m_vals, mp_vals = check_rows(l_max, spin)
    mp_t = None if mp_vals is None else torch.as_tensor(
        mp_vals, dtype=torch.int32, device=dev)
    for fold in ((False,) if spin else (False, True)):
        seeds = seeds_for(l_max, m_vals, fold, dev, mp_vals)
        R, P = seeds[1].shape[0], (2 if fold else 1)
        kw = dict(l_max=l_max, fold=fold, mp_vals=mp_t)
        for K in (1, 8):
            a = random_a(gen, m_vals, l_max + 1, 2 * K, dev, mp_vals)
            dw = (torch.rand((len(m_vals), P, R, 2 * K), generator=gen) * 2
                  - 1).to(dev)
            yield fold, K, seeds, kw, a, dw


def check_kernels(dev, spin: bool = False) -> None:
    """Hold each kernel against its plain version at l_max 256, K 1 and 8,
    fold off and on, with padding rows among the real ones; log kernel and
    plain times with fold off at each variant's main-path K (1 for vpu, 8
    for mxu).  With ``spin`` the kernels' spin branch on the 2M spin rows
    (fold off), whose analysis rows below l0 = max(m, |m'|) and reduce
    output there must be exact zeros."""
    l_max = CHECK_L_MAX
    gen = check_gen(spin)
    m_vals, mp_vals = check_rows(l_max, spin)
    pad = np.flatnonzero(m_vals < 0)
    mp_t = None if mp_vals is None else torch.as_tensor(
        mp_vals, dtype=torch.int32, device=dev)
    L, sfx = l_max + 1, tag(spin)
    for fold, K, (m_t, x, pmm, pms), kw, a, dw in check_cases(dev, spin, gen):
        want = {}
        want["synth"], plain_s = plain_ms(lambda: kref.synth_ref(
            a, m_t, x, pmm, pms, **kw))
        want["anal"], plain_a = plain_ms(lambda: kref.anal_ref(
            dw, m_t, x, pmm, pms, **kw))
        plain = {"synth": plain_s, "anal": plain_a}
        what = f"l_max {l_max} fold={fold!s:5s} K={K}"
        for var in ("vpu", "mxu"):
            for d, op in (("synth", a), ("anal", dw)):
                fn = getattr(lc, f"{d}_{var}")
                out = fn(op, m_t, x, pmm, pms, **kw)
                held(f"{d}_{var}{sfx}", out, want[d], what, pad)
                if spin and d == "anal":
                    below_zero(f"{d}_{var}{sfx}", out, m_vals, mp_vals)
                if not fold and K == (1 if var == "vpu" else 8):
                    k_ms = cuda_time_ms(lambda: fn(op, m_t, x, pmm, pms,
                                                   **kw))
                    log(f"  {d + '_' + var + sfx:15s} {what}: kernel "
                        f"{k_ms:.3f} ms, plain version {plain[d]:.1f} ms")
    part = torch.rand((len(m_vals), 3, L, 16), generator=gen).to(dev)
    m_t = torch.as_tensor(m_vals, dtype=torch.int32, device=dev)
    out = lc.anal_reduce(part, m_t, l_max=l_max, mp_vals=mp_t)
    held("anal_reduce", out,
         kref.anal_reduce_ref(part, m_t, l_max=l_max, mp_vals=mp_t),
         f"l_max {l_max}, 3 chunks, K 8" + (", spin rows" if spin else ""),
         pad)
    if spin:
        below_zero("anal_reduce", out, m_vals, mp_vals)


def test_layout(l_max: int, spin: bool) -> tuple:
    """(m_vals, mp_vals, layout) of the slot-kernel checks: every m of
    l_max and one padding row (the 2M spin rows, one made padding, with
    ``spin``), so the live row count is odd and one slot has an empty
    segment 1."""
    if spin:
        m_vals, mp_vals = spin_test_rows(l_max)
    else:
        m_vals, mp_vals = np.insert(np.arange(l_max + 1), 17, -1), None
    lo = pack.build_layout(m_vals, l_max, mp_vals=mp_vals)
    if not (lo.slot_seed == lo.S).any():
        raise AssertionError("the check layout has no empty segment")
    return m_vals, mp_vals, lo


def check_fused_kernels(dev, spin: bool = False) -> None:
    """Hold each fused kernel against its plain version at l_max 256, K 1
    and 8, fold off and on, with random (non-identity) rotation tables and
    without tables (identity tables are skipped, as on the GL main path).
    A padding row makes the row count odd, so one slot has an empty
    segment 1, whose synthesis rows must come out exactly zero, as must
    every dead position of the analysis stream.  Logs kernel and plain
    times with fold off at each variant's main-path K.  With ``spin`` the
    spin branch on the spin slot layout (segments start at max(m, |m'|)),
    fold off."""
    l_max = CHECK_L_MAX
    gen = torch.Generator().manual_seed(3 + 100 * spin)
    m_vals, mp_vals, lo = test_layout(l_max, spin)
    empty = torch.as_tensor(lo.slot_seed == lo.S, device=dev)
    dead = torch.as_tensor(lo.a_row < 0, device=dev)
    sfx = tag(spin)
    for fold in ((False,) if spin else (False, True)):
        _, x, pmm, pms = seeds_for(l_max, m_vals, fold, dev, mp_vals)
        maps, x, pmm_pk, pms_pk = ops._prep(lo, x, pmm, pms)
        R, P = x.shape[0], (2 if fold else 1)
        for K in (1, 8):
            K2 = 2 * K
            a_pk = ops._pack_a(random_a(gen, m_vals, l_max + 1, K2, dev,
                                        mp_vals), lo).contiguous()
            f = (torch.rand((lo.n_slots, 2, P, R, K2), generator=gen) * 2
                 - 1).to(dev)
            tab = (torch.rand((lo.n_slots, 2, P, 4, R), generator=gen) * 2
                   - 1).to(dev)
            for var in ("vpu", "mxu"):
                fk = f.movedim(-1, 3).contiguous() if var == "vpu" else f
                synth = getattr(fused_cuda, f"synth_fused_{var}")
                anal = getattr(fused_cuda, f"anal_fused_{var}")
                for t, tname in ((tab, "random tables"), (None, "no tables")):
                    what = f"l_max {l_max} fold={fold!s:5s} K={K} {tname}"
                    want_s, plain_s = plain_ms(lambda: kref.synth_fused_ref(
                        a_pk, maps, x, pmm_pk, pms_pk, t, l_max=l_max,
                        fold=fold, layout=var, spin=spin))
                    want_a, plain_a = plain_ms(lambda: kref.anal_fused_ref(
                        fk, maps, x, pmm_pk, pms_pk, t, l_max=l_max,
                        s_len=lo.S, layout=var, spin=spin))

                    def run_s():
                        return synth(a_pk, maps, x, pmm_pk, pms_pk, t,
                                     l_max=l_max, fold=fold, spin=spin)

                    def run_a():
                        return anal(fk, maps, x, pmm_pk, pms_pk, t,
                                    l_max=l_max, s_len=lo.S, spin=spin)

                    held(f"synth_fused_{var}{sfx}", run_s(), want_s, what,
                         (empty, 1))
                    held(f"anal_fused_{var}{sfx}", run_a(), want_a, what,
                         dead)
                    if not fold and K == (1 if var == "vpu" else 8) \
                            and t is tab:
                        for d, fn, pl in (("synth", run_s, plain_s),
                                          ("anal", run_a, plain_a)):
                            log(f"  {d + '_fused_' + var + sfx:15s} {what}: "
                                f"kernel {cuda_time_ms(fn):.3f} ms, plain "
                                f"version {pl:.1f} ms")


def same_bits(what: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Hold two outputs that run the same code on the same inputs equal
    bit for bit; log the gap if they are not."""
    torch.cuda.synchronize()
    equal = torch.equal(a, b)
    log(f"  {what}: bit-equal {equal}, digests {digest(a)} / {digest(b)}"
        + ("" if equal else f", max|d| = {float((a - b).abs().max()):.3e}"))
    if not equal:
        raise AssertionError(f"{what}: not bit-equal")


def check_packed_kernels(dev, spin: bool = False) -> None:
    """Hold each packed kernel against its plain version at l_max 256, K 1
    and 8, fold off and on.  A padding row makes the row count odd, so one
    slot has an empty segment 1, whose synthesis planes must come out
    exactly zero, as must every dead position of the analysis stream.
    With the fold off the packed synthesis and analysis run the fused
    kernels' code with no tables, so they must equal the fused kernels bit
    for bit.  Logs kernel and plain times with fold off at each variant's
    main-path K.  With ``spin`` the spin branch on the spin slot layout,
    fold off."""
    l_max = CHECK_L_MAX
    gen = torch.Generator().manual_seed(4 + 100 * spin)
    m_vals, mp_vals, lo = test_layout(l_max, spin)
    empty = torch.as_tensor(lo.slot_seed == lo.S, device=dev)
    dead = torch.as_tensor(lo.a_row < 0, device=dev)
    sfx = tag(spin)
    for fold in ((False,) if spin else (False, True)):
        _, x, pmm, pms = seeds_for(l_max, m_vals, fold, dev, mp_vals)
        maps, x, pmm_pk, pms_pk = ops._prep(lo, x, pmm, pms)
        R, P = x.shape[0], (2 if fold else 1)
        for K in (1, 8):
            K2 = 2 * K
            a_pk = ops._pack_a(random_a(gen, m_vals, l_max + 1, K2, dev,
                                        mp_vals), lo).contiguous()
            dw = (torch.rand((lo.n_slots, 2 * P, R, K2), generator=gen) * 2
                  - 1).to(dev)
            what = f"l_max {l_max} fold={fold!s:5s} K={K}"
            for var in ("vpu", "mxu"):
                dk = dw.movedim(-1, 2).contiguous() if var == "vpu" else dw
                synth = getattr(fused_cuda, f"synth_packed_{var}")
                anal = getattr(fused_cuda, f"anal_packed_{var}")
                want_s, plain_s = plain_ms(lambda: kref.synth_packed_ref(
                    a_pk, maps, x, pmm_pk, pms_pk, l_max=l_max, fold=fold,
                    layout=var, spin=spin))
                want_a, plain_a = plain_ms(lambda: kref.anal_packed_ref(
                    dk, maps, x, pmm_pk, pms_pk, l_max=l_max, s_len=lo.S,
                    layout=var, spin=spin))

                def run_s():
                    return synth(a_pk, maps, x, pmm_pk, pms_pk, l_max=l_max,
                                 fold=fold, spin=spin)

                def run_a():
                    return anal(dk, maps, x, pmm_pk, pms_pk, l_max=l_max,
                                s_len=lo.S, spin=spin)

                out_s, out_a = run_s(), run_a()
                # planes of segment 1 of an empty slot: q = P .. 2P - 1
                held(f"synth_packed_{var}{sfx}", out_s, want_s, what,
                     (empty, slice(P, 2 * P)))
                held(f"anal_packed_{var}{sfx}", out_a, want_a, what, dead)
                if fold:
                    continue
                fs = getattr(fused_cuda, f"synth_fused_{var}")(
                    a_pk, maps, x, pmm_pk, pms_pk, None, l_max=l_max,
                    spin=spin)
                same_bits(f"synth_packed_{var}{sfx} = synth_fused_{var}{sfx} "
                          f"(no tables), {what}", out_s, fs.reshape(
                              out_s.shape))
                fa = getattr(fused_cuda, f"anal_fused_{var}")(
                    dk.reshape(lo.n_slots, 2, 1, *dk.shape[2:]), maps, x,
                    pmm_pk, pms_pk, None, l_max=l_max, s_len=lo.S, spin=spin)
                same_bits(f"anal_packed_{var}{sfx} = anal_fused_{var}{sfx} "
                          f"(no tables), {what}", out_a, fa)
                if K == (1 if var == "vpu" else 8):
                    for d, fn, pl in (("synth", run_s, plain_s),
                                      ("anal", run_a, plain_a)):
                        log(f"  {d + '_packed_' + var + sfx:15s} {what}: "
                            f"kernel {cuda_time_ms(fn):.3f} ms, plain "
                            f"version {pl:.1f} ms")


def check_bf16_kernels(dev, spin: bool = False) -> None:
    """Hold the bfloat16 branch of kernels 10 and 12 against its bf16 plain
    version at l_max 256, K 1 and 8, fold off and on (spin: off), with
    random tables and without, at BF16_KERNEL_TOL; the empty segment and
    dead positions exactly zero; each differs from the float32 kernel
    within the reference's band.  Logs kernel and plain times at K 8,
    fold off, random tables, beside the float32 kernel's."""
    l_max = CHECK_L_MAX
    gen = torch.Generator().manual_seed(5 + 100 * spin)
    m_vals, mp_vals, lo = test_layout(l_max, spin)
    empty = torch.as_tensor(lo.slot_seed == lo.S, device=dev)
    dead = torch.as_tensor(lo.a_row < 0, device=dev)
    sfx = tag(spin)
    for fold in ((False,) if spin else (False, True)):
        _, x, pmm, pms = seeds_for(l_max, m_vals, fold, dev, mp_vals)
        maps, x, pmm_pk, pms_pk = ops._prep(lo, x, pmm, pms)
        R, P = x.shape[0], (2 if fold else 1)
        for K in (1, 8):
            K2 = 2 * K
            a_pk = ops._pack_a(random_a(gen, m_vals, l_max + 1, K2, dev,
                                        mp_vals), lo).contiguous()
            f = (torch.rand((lo.n_slots, 2, P, R, K2), generator=gen) * 2
                 - 1).to(dev)
            tab = (torch.rand((lo.n_slots, 2, P, 4, R), generator=gen) * 2
                   - 1).to(dev)
            for t, tname in ((tab, "random tables"), (None, "no tables")):
                what = f"l_max {l_max} fold={fold!s:5s} K={K} {tname}"
                want_s, plain_s = plain_ms(lambda: kref.synth_fused_ref(
                    a_pk, maps, x, pmm_pk, pms_pk, t, l_max=l_max, fold=fold,
                    spin=spin, bf16=True))
                want_a, plain_a = plain_ms(lambda: kref.anal_fused_ref(
                    f, maps, x, pmm_pk, pms_pk, t, l_max=l_max, s_len=lo.S,
                    spin=spin, bf16=True))

                def run_s(bf16=True):
                    return fused_cuda.synth_fused_mxu(
                        a_pk, maps, x, pmm_pk, pms_pk, t, l_max=l_max,
                        fold=fold, spin=spin, bf16=bf16)

                def run_a(bf16=True):
                    return fused_cuda.anal_fused_mxu(
                        f, maps, x, pmm_pk, pms_pk, t, l_max=l_max,
                        s_len=lo.S, spin=spin, bf16=bf16)

                for d, run, want, pad in (("synth", run_s, want_s,
                                           (empty, 1)),
                                          ("anal", run_a, want_a, dead)):
                    out = run()
                    held(f"{d}_fused_mxu_bf16{sfx}", out, want, what, pad,
                         tol=BF16_KERNEL_TOL)
                    f32 = run(False)
                    gap = float((out - f32).abs().max() / f32.abs().max())
                    log(f"  {d}_fused_mxu_bf16{sfx} vs float32 kernel: "
                        f"{gap:.3e} (band (0, {BF16_GATE:g}))")
                    if not 0 < gap < BF16_GATE:
                        raise AssertionError(f"{d}_fused_mxu_bf16{sfx}: "
                                             f"{gap} against float32")
                if not fold and K == 8 and t is tab:
                    for d, fn, pl in (("synth", run_s, plain_s),
                                      ("anal", run_a, plain_a)):
                        log(f"  {d}_fused_mxu_bf16{sfx} {what}: kernel "
                            f"{cuda_time_ms(fn):.3f} ms (float32 "
                            f"{cuda_time_ms(lambda: fn(False)):.3f} ms), "
                            f"plain version {pl:.1f} ms")


#: (nside, K, mode) of the fused bucket chains against their plain versions
BUCKET_CHECKS = ((64, 8, "cuda_mxu"), (64, 1, "cuda_vpu"))


def check_bucket_chains(dev, spin: int = 0) -> None:
    """The fused bucket chains of a small HEALPix plan on the card (bucket
    tables through the fused kernels, the bucket FFTs and the order-fixed
    alias fold) against the same plan on the CPU, which runs the kernels'
    plain versions, both directions, at KERNEL_TOL; each direction rerun
    for identical bits."""
    for nside, K, mode in BUCKET_CHECKS:
        kw = dict(nside=nside, K=K, dtype="float32", mode=mode, spin=spin)
        plan = repro_torch.make_plan("healpix", **kw)
        cpu = repro_torch.make_plan("healpix", device="cpu", **kw)
        if plan.layouts != {"synth": "fused", "anal": "fused"}:
            raise AssertionError(f"healpix {nside}: layouts {plan.layouts}")
        gen = torch.Generator().manual_seed(21 + spin)
        alm = random_alm_for(gen, plan, torch.float32, torch.device("cpu"))
        maps = plan.alm2map(alm.to(dev))
        back = plan.map2alm(maps)
        what = (f"healpix nside {nside} K {K} {mode} spin {spin}, "
                f"{plan.phase.layout.n_buckets} buckets")
        held(f"fused bucket synthesis", maps.cpu(), cpu.alm2map(alm), what)
        held(f"fused bucket analysis", back.cpu(), cpu.map2alm(maps.cpu()),
             what)
        rerun_same("bucket synthesis", digest(maps),
                   lambda: plan.alm2map(alm.to(dev)))
        rerun_same("bucket analysis", digest(back),
                   lambda: plan.map2alm(maps))


# ---------------------------------------------------------------------------
# phase 3: the main paths at full width, then each kernel at its shapes
# ---------------------------------------------------------------------------

#: (mode, l_max, K, layout): the sht_cmb shapes, first on the fused layout
#: the plans pick by default, then on the staged plain layout, and the
#: packed layout at l_max 1024 (cut from the sht_cmb depth to keep the
#: script's time in bounds once the ragged paths joined); each runs as the
#: spin-0 pair and as the spin-2 (E, B) <-> (Q, U) pair
MAIN_PATH = (("cuda_mxu", SYNTH_2K.l_max, SYNTH_2K.K, "fused"),
             ("cuda_vpu", SYNTH_4K.l_max, SYNTH_4K.K, "fused"),
             ("cuda_mxu", SYNTH_2K.l_max, SYNTH_2K.K, "plain"),
             ("cuda_vpu", SYNTH_4K.l_max, SYNTH_4K.K, "plain"),
             ("cuda_mxu", 1024, SYNTH_2K.K, "packed"),
             ("cuda_vpu", 1024, SYNTH_4K.K, "packed"))
SPINS = (0, 2)
#: the ring stride of the plain versions on the costliest checks: there the
#: kernels run on every ring of the full-depth shape (the analyses on their
#: inputs with the other rings set to zero) and are held against their
#: plain versions on every RING_STRIDE-th ring only.  The plain versions'
#: cost grows with the rings, while the error growth that matters grows
#: with l, which keeps its full depth.
RING_STRIDE = 8
#: (grid, size, layout, spin) of the paths held on a ring subset: the GL
#: 4096/K1 spin-2 paths (the spin branch of kernels 9, 11, 1 and 3), whose
#: plain versions contract the spin update through an emulated FMA
#: (``kref.fma_f32``), and the ragged paths whose plain versions cost the
#: most (HEALPix 2048/K1; HEALPix 1024/K8 spin 2, fused and plain)
RING_SUBSET_PATHS = {("gl", SYNTH_4K.l_max, "fused", 2),
                     ("gl", SYNTH_4K.l_max, "plain", 2),
                     ("healpix", 2048, "fused", 0),
                     ("healpix", 1024, "fused", 2),
                     ("healpix", 1024, "plain", 2)}
#: l_max of the vpu templates' fold check (GL, K 1), the main shape; held
#: on a ring subset
FOLD_VPU_L_MAX = SYNTH_4K.l_max
#: (grid, size, mode, K, layout, spins): the ragged-grid paths at full width
#: (size: nside of the HEALPix family, l_max of ECP; l_max = 2 nside)
RAGGED_PATHS = (
    ("healpix", 1024, "cuda_mxu", 8, "fused", (0, 2)),
    ("healpix", 1024, "cuda_mxu", 8, "plain", (0, 2)),
    ("healpix", 2048, "cuda_vpu", 1, "fused", (0,)),
    ("healpix_ring", 1024, "cuda_mxu", 8, "fused", (0,)),
    ("ecp", 2048, "cuda_mxu", 8, "fused", (0,)),
)
#: (grid, size, K, spin, ring stride of the plain versions) of the bf16
#: paths (mxu, the fused default layout)
BF16_PATHS = (("gl", 2048, 8, 0, 1), ("gl", 2048, 8, 2, RING_STRIDE),
              ("healpix", 1024, 8, 0, 1))

#: the kernels each layout's path must launch, for a variant and spin (the
#: spin-2 paths launch each kernel's spin branch, and anal_reduce)
PATH_KERNELS = {
    "fused": lambda v, s="": (f"synth_fused_{v}{s}", f"anal_fused_{v}{s}",
                              "anal_reduce"),
    "plain": lambda v, s="": (f"synth_{v}{s}", f"anal_{v}{s}",
                              "anal_reduce"),
    "packed": lambda v, s="": (f"synth_packed_{v}{s}", f"anal_packed_{v}{s}",
                               "anal_reduce"),
}


def reset_launches() -> None:
    lc.reset_launches()
    fused_cuda.reset_launches()


def read_launches() -> dict:
    return {**lc.launches, **fused_cuda.launches}


def make_grid_plan(grid: str, size: int, **kw):
    """make_plan on ``grid``: ``size`` is l_max for gl/ecp, nside for the
    HEALPix family (l_max = 2 nside)."""
    if grid in ("gl", "ecp"):
        return repro_torch.make_plan(grid, size, **kw)
    return repro_torch.make_plan(grid, nside=size, **kw)


def run_main_path(dev, mode: str, l_max: int, K: int, layout: str,
                  spin: int = 0, grid: str = "gl") -> tuple:
    """One full-width round trip through make_plan/alm2map/map2alm (spin 2:
    (E, B) alm -> (Q, U) maps -> (E, B) alm).  ``l_max`` is the grid's
    size (nside on the HEALPix family); the approximate-quadrature grids
    take one Jacobi pass (``map2alm(iters=1)``)."""
    t0 = time.perf_counter()
    # the fused paths are the plans' default layout: called as a user would
    plan = make_grid_plan(grid, l_max, K=K, dtype="float32", mode=mode,
                          spin=spin,
                          layout=None if layout == "fused" else layout)
    if plan.layouts != {"synth": layout, "anal": layout}:
        raise AssertionError(f"{mode}: layouts {plan.layouts}")
    L = plan.l_max
    gen = torch.Generator().manual_seed(
        l_max + K + spin + (0 if grid == "gl" else 7))
    if spin:
        alm = sht.random_alm_spin(gen, L, L, K, dtype=torch.float32,
                                  device=dev)
    else:
        alm = sht.random_alm(gen, L, L, K, dtype=torch.float32, device=dev)
    iters, tol = (0, ROUNDTRIP_TOL) if grid == "gl" else \
        (1, QUAD_ROUNDTRIP_TOL)
    maps = plan.alm2map(alm)
    alm2 = plan.map2alm(maps, iters=iters)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    g = plan.grid
    want = (g.n_rings, g.max_n_phi, K)
    if tuple(maps.shape) != ((2,) + want if spin else want) or \
            tuple(alm2.shape) != tuple(alm.shape) or \
            not bool(torch.isfinite(maps).all()) or \
            not bool(torch.isfinite(torch.view_as_real(alm2)).all()):
        raise AssertionError(f"{mode}: non-finite or misshapen output")
    err = spectra.d_err(alm, alm2)
    log(f"  {mode} [{layout}] spin {spin} {where(plan)} K={K}: maps "
        f"{tuple(maps.shape)}, round-trip d_err = {err:.3e} (iters={iters}, "
        f"limit {tol:g}), {secs:.2f} s with plan build")
    if not err < tol:
        raise AssertionError(f"{mode} spin {spin} round trip d_err {err}")
    return plan, alm, maps


def where(plan) -> str:
    """The grid and shape of a plan, for the log."""
    g = plan.grid
    size = f"nside={g.nside} " if g.nside else ""
    return (f"{g.name} {size}l_max={plan.l_max} ({g.n_rings} rings"
            + (f", {plan.phase.layout.n_buckets} buckets"
               if plan.phase.kind == "bucket" else "") + ")")


def path_rows(plan, alm, maps) -> tuple:
    """The Legendre-stage operands of a staged main path at its own inputs:
    (a (Mr, L, 2K) f32 coefficient rows, dw (Mr, 1, R, 2K) f32 weighted
    Delta rows); on a spin-2 plan the 2M a^{+-} and Delta^{+-} rows."""
    K = plan.K
    if plan.spin:
        a = plan._eb_rows(alm)
        dwc = plan.phase.anal(torch.cat([maps[0], maps[1]], dim=-1))
        d_re, d_im = legendre.spin_pack_delta(
            dwc[..., :K].real, dwc[..., :K].imag, dwc[..., K:].real,
            dwc[..., K:].imag)
        dw = torch.cat([d_re, d_im], dim=-1)
    else:
        a = torch.cat([alm.real, alm.imag], dim=-1).to(torch.float32)
        dwc = plan.phase.anal(maps)
        dw = torch.cat([dwc.real, dwc.imag], dim=-1)
    return a, dw[:, None].contiguous()


def path_maps(plan, maps) -> torch.Tensor:
    """A main path's maps as the phase stage takes them: (R, n, K), or the
    (Q, U) pair as (R, n, 2K) channels on a spin-2 plan."""
    return torch.cat([maps[0], maps[1]], dim=-1) if plan.spin else maps


def plain_ms(fn) -> tuple:
    """(output, wall ms) of one call of a plain version, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def ring_subset(R: int, stride: int, dev):
    """The ring indices the plain versions run on: every ``stride``-th of
    ``R`` (None with stride 1: every ring)."""
    return None if stride == 1 else torch.arange(0, R, stride, device=dev)


def on_rings(idx, t, axis: int = -1):
    """``t``'s rings ``idx`` along ``axis`` (``t`` itself where ``idx`` or
    ``t`` is None)."""
    if idx is None or t is None:
        return t
    return t.index_select(axis % t.dim(), idx).contiguous()


def rings_only(idx, t, axis: int):
    """``t`` with every ring outside ``idx`` (along ``axis``) set to zero,
    the analysis input whose kernel output the plain version on those
    rings gives (``t`` itself where ``idx`` is None)."""
    if idx is None:
        return t
    keep = torch.zeros(t.shape[axis], dtype=t.dtype, device=t.device)
    keep[idx] = 1
    shape = [1] * t.dim()
    shape[axis] = -1
    return (t * keep.view(shape)).contiguous()


def subset_note(stride: int) -> str:
    return "" if stride == 1 else f", plain version on every {stride}th ring"


def time_kernels(mode: str, l_max: int, K: int, run: tuple,
                 stride: int = 1) -> dict:
    """Each kernel of one main path at the shapes that path gave it: held
    against its plain version on the same inputs (every ``stride``-th ring:
    :data:`RING_STRIDE`), then kernel time, plain version time, bound, and
    the library call where one exists."""
    var = mode[5:]
    plan, alm, maps = run
    l_max = plan.l_max
    m_t, x, pmm, pms, mp_t = plan._row_seeds()
    sfx = tag(plan.spin)
    a, dw = path_rows(plan, alm, maps)
    K2, R, L = 2 * K, x.shape[0], l_max + 1
    what = f"l_max {l_max}, K {K} (main path{subset_note(stride)})"
    idx = ring_subset(R, stride, x.device)
    x_c, pmm_c, pms_c = (on_rings(idx, t) for t in (x, pmm, pms))
    mp_np = None if mp_t is None else mp_t.cpu().numpy()
    triples, flops = legendre_work(m_t.cpu().numpy(), L, R, K2, mp_np)
    synth = getattr(lc, f"synth_{var}")
    rkw = dict(l_max=l_max, mp_vals=mp_t)

    def run_s():
        return synth(a, m_t, x, pmm, pms, **rkw)

    def run_a():
        return lc.anal_partials(var, dw, m_t, x, pmm, pms, **rkw)

    out_s, part = run_s(), run_a()
    out_a = lc.anal_reduce(part, m_t, **rkw)
    # on a ring subset: the synthesis's rings, the analysis of the input
    # with the other rings zero
    out_c = out_a if idx is None else lc.anal_reduce(
        lc.anal_partials(var, rings_only(idx, dw, 2), m_t, x, pmm, pms,
                         **rkw), m_t, **rkw)
    want_s, plain_s = plain_ms(lambda: kref.synth_ref(
        a, m_t, x_c, pmm_c, pms_c, **rkw))
    want_a, plain_a = plain_ms(lambda: kref.anal_ref(
        on_rings(idx, dw, 2), m_t, x_c, pmm_c, pms_c, **rkw))
    want_r, plain_r = plain_ms(lambda: kref.anal_reduce_ref(part, m_t,
                                                            **rkw))
    err_s = held(f"synth_{var}{sfx}", on_rings(idx, out_s, 2), want_s, what)
    err_a = held(f"anal_{var}{sfx}", out_c, want_a, what)
    err_r = held("anal_reduce", out_a, want_r, what)
    if plan.spin:
        below_zero(f"anal_{var}{sfx}", out_a, m_t.cpu().numpy(), mp_np)
    dig_a = digest(out_a)
    del want_s, want_a, want_r, out_s, out_a, out_c
    ms_s, ms_a = cuda_time_ms(run_s), cuda_time_ms(run_a)
    ms_r = cuda_time_ms(lambda: lc.anal_reduce(part, m_t, **rkw))
    rerun_same(f"anal_{var}{sfx}", dig_a,
               lambda: lc.anal_reduce(run_a(), m_t, **rkw))
    lib_r = cuda_time_ms(lambda: part.sum(dim=1))
    seeds = nbytes(m_t, x, pmm, pms, mp_t)
    shape = f"l_max {l_max}, K {K}" + (", 2M spin rows" if plan.spin else "")
    # the second pass reads the l >= m rows of every chunk and writes the
    # full output
    n_ch = part.shape[1]
    red_bytes = triples // R * n_ch * K2 * 4 + m_t.numel() * L * K2 * 4
    red_ops = triples // R * (n_ch - 1) * K2
    return {
        f"synth_{var}{sfx}": dict(
            ms=ms_s, plain_ms=plain_s, library_ms=None, err=err_s,
            shape=shape, bound=bound_ms(flops, nbytes(a) + seeds
                                        + m_t.numel() * R * K2 * 4)),
        f"anal_{var}{sfx}": dict(
            ms=ms_a, plain_ms=plain_a, library_ms=None, err=err_a,
            shape=shape, bound=bound_ms(flops, nbytes(dw, part) + seeds)),
        "anal_reduce": dict(
            ms=ms_r, plain_ms=plain_r, library_ms=lib_r, err=err_r,
            shape=f"{shape}, {n_ch} chunks",
            bound=bound_ms(red_ops, red_bytes)),
    }


def identity_tables(var: str, out_a, want_a, f_pk, prep, l_max: int,
                    S: int, what: str, spin: bool, idx=None) -> None:
    """The fused analysis with explicit identity tables against the skipped
    tables of the main path: the kernel must give the same bits (1 re +
    0 im == re), while the plain version, which then contracts a rotated
    copy instead of a view of the rows, may round its ring sums in another
    order.  Logs both, so a change in the gap between runs is seen to come
    from the plain version or from the kernel.  With ring indices ``idx``
    ``f_pk`` holds zeros off them and the plain version runs on them."""
    n_slots, _, P = f_pk.shape[:3]
    R = prep[1].shape[0]
    ident = torch.zeros((n_slots, 2, P, 4, R), device=f_pk.device)
    ident[:, :, :, 0] = 1.0
    ident[:, :, :, 3] = 1.0
    kernel = getattr(fused_cuda, f"anal_fused_{var}")(
        f_pk, *prep, ident, l_max=l_max, s_len=S, spin=spin)
    sfx = tag(spin)
    same_bits(f"anal_fused_{var}{sfx} with identity tables = without, "
              f"{what}", kernel, out_a)
    pmaps, x, pmm_pk, pms_pk = prep
    plain = kref.anal_fused_ref(
        on_rings(idx, f_pk, -1 if var == "vpu" else -2), pmaps,
        *(on_rings(idx, t) for t in (x, pmm_pk, pms_pk, ident)),
        l_max=l_max, s_len=S, layout=var, spin=spin)
    gap = float((out_a - plain).abs().max() / plain.abs().max())
    log(f"  anal_fused_{var}{sfx} plain version with identity tables: digest "
        f"{digest(plain)} (without: {digest(want_a)}), kernel vs it "
        f"{gap:.3e}")


def time_fused_kernels(mode: str, l_max: int, K: int, run: tuple,
                       bf16: bool = False, stride: int = 1) -> dict:
    """Each kernel of one fused main path at the shapes that path gave it
    (the plan's own packed seeds and tables), as :func:`time_kernels`
    (``stride`` too);
    ``bf16`` the bfloat16 branch of the mxu kernels, held at
    BF16_KERNEL_TOL, its bound the contraction at the tensor cores' rate
    plus the float32 recurrence."""
    var = mode[5:]
    plan, alm, maps = run
    l_max = plan.l_max
    spin = bool(plan.spin)
    sfx = tag(spin)
    bf = "_bf16" if bf16 else ""
    bkw = {"bf16": True} if bf16 else {}
    tol = BF16_KERNEL_TOL if bf16 else KERNEL_TOL
    _, kw, _ = plan._fused_parts(var, bf16)
    lo, store = kw["lo"], kw["store"]
    rows, mp_rows = plan._rows
    pmaps, x, pmm_pk, pms_pk = store["prep"]
    tab_s = store[("tables", "synth")]
    tab_a = store[("tables", "anal")]
    a_rows = plan._eb_rows(alm) if spin else \
        torch.cat([alm.real, alm.imag], dim=-1)
    a_pk = ops._pack_a(a_rows, lo).contiguous()
    w = torch.as_tensor(plan.grid.weights, dtype=torch.float32, device=x.device)
    fp = fused._anal_rows(path_maps(plan, maps) * w[:, None, None], rows,
                          n=getattr(plan.phase, "n", None), fold_rings=None,
                          n_half=x.shape[0], spin=spin,
                          bucket=getattr(plan.phase, "index", None))
    f_pk = ops._pack_rows(fp, lo)
    f_pk = (f_pk.movedim(-1, 3) if var == "vpu" else f_pk).contiguous()
    del fp
    K2, R, L, S = 2 * K, x.shape[0], l_max + 1, lo.S
    what = (f"{where(plan)}, K {K} (fused main path"
            + (", bf16" if bf16 else "") + subset_note(stride) + ")")
    idx = ring_subset(R, stride, x.device)
    rax = -1 if var == "vpu" else -2          # the ring axis of f and out
    x_c, pmm_c, pms_c, tab_s_c, tab_a_c = (
        on_rings(idx, t) for t in (x, pmm_pk, pms_pk, tab_s, tab_a))
    triples, flops = legendre_work(rows, L, R, K2, mp_rows)
    synth = getattr(fused_cuda, f"synth_fused_{var}")

    def run_s():
        return synth(a_pk, pmaps, x, pmm_pk, pms_pk, tab_s, l_max=l_max,
                     spin=spin, **bkw)

    def run_a():
        return fused_cuda.anal_fused_partials(var, f_pk, pmaps, x, pmm_pk,
                                              pms_pk, tab_a, l_max=l_max,
                                              s_len=S, spin=spin, **bkw)

    sm = fused_cuda.slot_maps(pmaps, spin)

    def reduce(p):
        return lc.anal_reduce(p, None, l_max=l_max, slot_maps=sm)

    out_s, part = run_s(), run_a()
    out_a = reduce(part)
    # on a ring subset: the synthesis's rings, the analysis of the rows
    # with the other rings zero
    f_c = rings_only(idx, f_pk, rax)
    out_c = out_a if idx is None else reduce(fused_cuda.anal_fused_partials(
        var, f_c, pmaps, x, pmm_pk, pms_pk, tab_a, l_max=l_max, s_len=S,
        spin=spin, **bkw))
    want_s, plain_s = plain_ms(lambda: kref.synth_fused_ref(
        a_pk, pmaps, x_c, pmm_c, pms_c, tab_s_c, l_max=l_max, layout=var,
        spin=spin, bf16=bf16))
    want_a, plain_a = plain_ms(lambda: kref.anal_fused_ref(
        on_rings(idx, f_pk, rax), pmaps, x_c, pmm_c, pms_c, tab_a_c,
        l_max=l_max, s_len=S, layout=var, spin=spin, bf16=bf16))
    want_r, plain_r = plain_ms(lambda: kref.anal_reduce_ref(
        part, None, l_max=l_max, slot_maps=sm))
    empty = torch.as_tensor(lo.slot_seed == S, device=x.device)
    dead = torch.as_tensor(lo.a_row < 0, device=x.device)
    err_s = held(f"synth_fused_{var}{bf}{sfx}", on_rings(idx, out_s, rax),
                 want_s, what, (empty, 1), tol=tol)
    err_a = held(f"anal_fused_{var}{bf}{sfx}", out_c, want_a, what, dead,
                 tol=tol)
    err_r = held("anal_reduce", out_a, want_r, what)
    dig_a = digest(out_a)
    if tab_a is None and not bf16:
        identity_tables(var, out_c, want_a, f_c, (pmaps, x, pmm_pk, pms_pk),
                        l_max, S, what, spin, idx)
    del want_s, want_a, want_r, out_s, out_a, out_c, f_c
    ms_s, ms_a = cuda_time_ms(run_s), cuda_time_ms(run_a)
    ms_r = cuda_time_ms(lambda: reduce(part))
    rerun_same(f"anal_fused_{var}{bf}{sfx}", dig_a, lambda: reduce(run_a()))
    lib_r = cuda_time_ms(lambda: part.sum(dim=1))
    seeds = nbytes(x, pmm_pk, pms_pk, *pmaps)
    shape = (f"{where(plan)}, K {K}, {lo.n_slots} slots x S {S}"
             + (", 2M spin rows" if spin else ""))
    # rows: one (slot, segment) each; the reduce reads the live positions
    # of every chunk and writes the full packed output
    live = triples // R
    n_ch = part.shape[1]
    red_bytes = live * n_ch * K2 * 4 + lo.n_slots * S * K2 * 4
    red_ops = live * (n_ch - 1) * K2
    # bf16: the contraction's 2 operations per channel run on the tensor
    # cores, the recurrence (4, spin 5, per triple) on the CUDA cores
    tc_ops = triples * 2 * K2 if bf16 else 0
    return {
        f"synth_fused_{var}{bf}{sfx}": dict(
            ms=ms_s, plain_ms=plain_s, library_ms=None, err=err_s,
            shape=shape, tables=tab_s is not None,
            bound=bound_ms(flops - tc_ops + rotation_ops(tab_s, K),
                           nbytes(a_pk, tab_s) + seeds
                           + lo.n_slots * 2 * R * K2 * 4, tc_ops)),
        f"anal_fused_{var}{bf}{sfx}": dict(
            ms=ms_a, plain_ms=plain_a, library_ms=None, err=err_a,
            shape=shape, tables=tab_a is not None,
            bound=bound_ms(flops - tc_ops + rotation_ops(tab_a, K),
                           nbytes(f_pk, tab_a, part) + seeds, tc_ops)),
        "anal_reduce": dict(
            ms=ms_r, plain_ms=plain_r, library_ms=lib_r, err=err_r,
            shape=f"{shape}, {n_ch} chunks",
            bound=bound_ms(red_ops, red_bytes)),
    }


def rerun_same(name: str, dig: str, fn) -> None:
    """Run an analysis kernel and its reduce again after its timing runs:
    its output must repeat bit for bit (chunk-order sums, no atomics)."""
    again = digest(fn())
    log(f"  {name:15s} rerun digest {again}: "
        f"{'same bits' if again == dig else 'CHANGED from ' + dig}")
    if again != dig:
        raise AssertionError(f"{name}: output bits changed between runs")


def time_packed_kernels(mode: str, l_max: int, K: int, run: tuple) -> dict:
    """Each kernel of one packed main path at the shapes that path gave it
    (the plan's own packed layout and seeds), as :func:`time_kernels`; the
    packed synthesis and analysis are also held bit-equal to the fused
    kernels' code (no tables, fold off) on the same inputs."""
    var = mode[5:]
    plan, alm, maps = run
    l_max = plan.l_max
    spin = bool(plan.spin)
    sfx = tag(spin)
    store = plan._fused_store
    lo = store["layout"]
    rows, mp_rows = plan._rows
    pmaps, x, pmm_pk, pms_pk = store["prep"]
    a_rows, dw = path_rows(plan, alm, maps)
    a_pk = ops._pack_a(a_rows, lo).contiguous()
    del a_rows
    K2, R, L, S = 2 * K, x.shape[0], l_max + 1, lo.S
    dk = ops._pack_rows(dw, lo).reshape(lo.n_slots, 2, R, K2)
    del dw
    dk = (dk.movedim(-1, 2) if var == "vpu" else dk).contiguous()
    what = f"l_max {l_max}, K {K} (packed main path)"
    triples, flops = legendre_work(rows, L, R, K2, mp_rows)
    synth = getattr(fused_cuda, f"synth_packed_{var}")

    def run_s():
        return synth(a_pk, pmaps, x, pmm_pk, pms_pk, l_max=l_max, spin=spin)

    def run_a():
        return fused_cuda.anal_packed_partials(var, dk, pmaps, x, pmm_pk,
                                               pms_pk, l_max=l_max, s_len=S,
                                               spin=spin)

    sm = fused_cuda.slot_maps(pmaps, spin)

    def reduce(p):
        return lc.anal_reduce(p, None, l_max=l_max, slot_maps=sm)

    out_s, part = run_s(), run_a()
    out_a = reduce(part)
    want_s, plain_s = plain_ms(lambda: kref.synth_packed_ref(
        a_pk, pmaps, x, pmm_pk, pms_pk, l_max=l_max, layout=var, spin=spin))
    want_a, plain_a = plain_ms(lambda: kref.anal_packed_ref(
        dk, pmaps, x, pmm_pk, pms_pk, l_max=l_max, s_len=S, layout=var,
        spin=spin))
    want_r, plain_r = plain_ms(lambda: kref.anal_reduce_ref(
        part, None, l_max=l_max, slot_maps=sm))
    empty = torch.as_tensor(lo.slot_seed == S, device=x.device)
    dead = torch.as_tensor(lo.a_row < 0, device=x.device)
    err_s = held(f"synth_packed_{var}{sfx}", out_s, want_s, what, (empty, 1))
    err_a = held(f"anal_packed_{var}{sfx}", out_a, want_a, what, dead)
    err_r = held("anal_reduce", out_a, want_r, what)
    del want_s, want_a, want_r
    fused_s = getattr(fused_cuda, f"synth_fused_{var}")(
        a_pk, pmaps, x, pmm_pk, pms_pk, None, l_max=l_max, spin=spin)
    same_bits(f"synth_packed_{var}{sfx} = synth_fused_{var}{sfx} (no "
              f"tables), {what}", out_s, fused_s.reshape(out_s.shape))
    del fused_s, out_s
    fused_part = fused_cuda.anal_fused_partials(
        var, dk.reshape(lo.n_slots, 2, 1, *dk.shape[2:]), pmaps, x, pmm_pk,
        pms_pk, None, l_max=l_max, s_len=S, spin=spin)
    same_bits(f"anal_packed_{var}{sfx} = anal_fused_{var}{sfx} (no "
              f"tables), {what}", part, fused_part)
    dig_a = digest(out_a)
    del fused_part, out_a
    ms_s, ms_a = cuda_time_ms(run_s), cuda_time_ms(run_a)
    ms_r = cuda_time_ms(lambda: reduce(part))
    lib_r = cuda_time_ms(lambda: part.sum(dim=1))
    rerun_same(f"anal_packed_{var}{sfx}", dig_a, lambda: reduce(run_a()))
    seeds = nbytes(x, pmm_pk, pms_pk, *pmaps)
    shape = f"l_max {l_max}, K {K}, {lo.n_slots} slots x S {S}"
    live = triples // R
    n_ch = part.shape[1]
    red_bytes = live * n_ch * K2 * 4 + lo.n_slots * S * K2 * 4
    red_ops = live * (n_ch - 1) * K2
    return {
        f"synth_packed_{var}{sfx}": dict(
            ms=ms_s, plain_ms=plain_s, library_ms=None, err=err_s,
            shape=shape, bound=bound_ms(flops, nbytes(a_pk) + seeds
                                        + lo.n_slots * 2 * R * K2 * 4)),
        f"anal_packed_{var}{sfx}": dict(
            ms=ms_a, plain_ms=plain_a, library_ms=None, err=err_a,
            shape=shape, bound=bound_ms(flops, nbytes(dk, part) + seeds)),
        "anal_reduce": dict(
            ms=ms_r, plain_ms=plain_r, library_ms=lib_r, err=err_r,
            shape=f"{shape}, {n_ch} chunks",
            bound=bound_ms(red_ops, red_bytes)),
    }


def bucket_fft_ms(bidx, C: int, dev) -> tuple:
    """(inverse, forward) device ms of the bucket FFTs alone: one
    ``torch.fft`` call per bucket over its rows, as the bucket phase runs
    them."""
    spec = torch.zeros((bidx.total, C), dtype=torch.complex64, device=dev)
    views = [(o, len(sl), B) for B, sl, o in
             zip(bidx.layout.lengths, bidx.layout.slots,
                 bidx.offsets.tolist()) if len(sl)]

    def run(fn):
        for o, rb, B in views:
            fn(spec[o:o + rb * B].view(rb, B, C), dim=1)

    return (cuda_time_ms(lambda: run(torch.fft.ifft)),
            cuda_time_ms(lambda: run(torch.fft.fft)))


def time_round_trip(mode: str, l_max: int, K: int, layout: str, run: tuple,
                    kernel_ms: dict) -> None:
    """Steady-state time of each direction of one main path (one analysis,
    no Jacobi pass), with its Legendre (or fused) kernel time and its FFT
    time: the phase stage on the staged layouts (on a ragged grid the
    bucket phase, phase factors included), the FFT alone on the fused
    layout (on a ragged grid the bucket phase: alias fold, one FFT per
    bucket and the bin gather, the FFTs' share given apart); the rest is
    the layout glue (re|im split, packing, scatter/gather)."""
    plan, alm, maps = run
    syn = host_ms(lambda: plan.alm2map(alm))
    ana = host_ms(lambda: plan.map2alm(maps))
    g, ph = plan.grid, plan.phase
    pmaps = path_maps(plan, maps)            # Q|U as 2K channels on spin 2
    C = pmaps.shape[-1]
    extra = ""
    if layout in ("plain", "packed"):
        delta = ph.anal(pmaps)
        fft_s = cuda_time_ms(lambda: ph.synth(delta))
        fft_a = cuda_time_ms(lambda: ph.anal(pmaps))
        what = "phase stage" if ph.kind == "uniform" else "bucket phase"
    elif ph.kind == "uniform":
        n = ph.n
        H = torch.zeros((g.n_rings, n // 2 + 1, C), dtype=torch.complex64,
                        device=maps.device)
        fft_s = cuda_time_ms(lambda: torch.fft.irfft(H, n=n, dim=1))
        fft_a = cuda_time_ms(lambda: torch.fft.rfft(pmaps, dim=1))
        what = "FFT"
    else:
        from repro_torch.core import phase as cphase
        hc = torch.zeros((plan.m_max + 1, g.n_rings, C),
                         dtype=torch.complex64, device=maps.device)
        fft_s = cuda_time_ms(lambda: cphase.bucket_scatter(hc, ph.index))
        fft_a = cuda_time_ms(lambda: cphase.bucket_gather(pmaps, ph.index))
        what = "bucket phase"
    if ph.kind == "bucket":
        ffts, fftf = bucket_fft_ms(ph.index, C, maps.device)
        extra = (f"; bucket FFTs alone {ffts:.2f} / {fftf:.2f} ms, "
                 f"{ph.layout.n_buckets} buckets")
    var = mode[5:]
    names = PATH_KERNELS[layout](var, tag(plan.spin))
    k_s = kernel_ms[names[0]]
    k_a = kernel_ms[names[1]] + kernel_ms["anal_reduce"]
    log(f"  {mode} [{layout}] spin {plan.spin} {where(plan)} K={K}: "
        f"alm2map {syn:.2f} ms "
        f"(kernel {k_s:.2f}, {what} {fft_s:.2f}, rest "
        f"{syn - k_s - fft_s:.2f}), map2alm {ana:.2f} ms (kernels "
        f"{k_a:.2f}, {what} {fft_a:.2f}, rest {ana - k_a - fft_a:.2f})"
        + extra)


# ---------------------------------------------------------------------------
# phase 4: float64 anchor
# ---------------------------------------------------------------------------


def random_alm_for(gen, plan, dtype, dev) -> torch.Tensor:
    """Random alm of a plan's shape: an (E, B) pair on a spin-2 plan."""
    draw = sht.random_alm_spin if plan.spin else sht.random_alm
    return draw(gen, plan.l_max, plan.m_max, plan.K, dtype=dtype, device=dev)


def f64_anchor(dev, spin: int = 0, grid: str = "gl", size: int = None,
               layouts=("fused", "plain", "packed")) -> None:
    """Every float32 kernel plan (both variants; the given layouts) against
    the float64 torch plan of the same grid and spin, K 2: GL at l_max
    512, or a ragged grid (``size`` its nside, or ECP's l_max), whose
    float64 round trip with one Jacobi pass is logged beside it."""
    size = ANCHOR_L_MAX if size is None else size
    tol = ANCHOR_TOL if grid == "gl" else RAGGED_ANCHOR_TOL
    K = 2
    gen = torch.Generator().manual_seed(7 + spin + (0 if grid == "gl" else 50))
    p64 = make_grid_plan(grid, size, K=K, dtype="float64", mode="torch",
                         spin=spin)
    alm = random_alm_for(gen, p64, torch.float64, dev)
    maps64 = p64.alm2map(alm)
    alm64 = p64.map2alm(maps64)
    if grid != "gl":
        log(f"  torch float64 {where(p64)} spin {spin}: round trip d_err "
            f"{spectra.d_err(alm, alm64):.3e} (iters=0), "
            f"{spectra.d_err(alm, p64.map2alm(maps64, iters=1)):.3e} "
            f"(iters=1)")
    for mode in ("cuda_vpu", "cuda_mxu"):
        for layout in layouts:
            p32 = make_grid_plan(grid, size, K=K, dtype="float32", mode=mode,
                                 layout=layout, spin=spin)
            maps32 = p32.alm2map(alm.to(torch.complex64))
            alm32 = p32.map2alm(maps64.to(torch.float32))
            rel_s = float((maps32 - maps64).abs().max() / maps64.abs().max())
            rel_a = float((alm32 - alm64).abs().max() / alm64.abs().max())
            log(f"  {mode} [{layout}] spin {spin} vs torch float64, "
                f"{where(p32)} K={K}: synthesis {rel_s:.3e}, analysis "
                f"{rel_a:.3e} (limit {tol:g})")
            if not max(rel_s, rel_a) < tol:
                raise AssertionError(f"{mode} [{layout}] spin {spin} strays "
                                     "from the float64 plan")


# ---------------------------------------------------------------------------
# phase 5: gradients on the card
# ---------------------------------------------------------------------------


def dot_identity_err(plan, seed: int) -> float:
    """Both directions of a plan through torch.autograd: the gradient of
    <A x, y> in x is A^T y, so <A x, y> = <x, grad>; the larger relative
    gap of the two directions."""
    dev = plan.device
    gen = torch.Generator().manual_seed(seed)
    errs = []
    a = random_alm_for(gen, plan, torch.float32, dev).requires_grad_(True)
    t = torch.randn(plan._maps_shape, generator=gen).to(dev)
    lhs = (plan.alm2map(a) * t).sum()
    (g,) = torch.autograd.grad(lhs, a)
    a = a.detach()
    errs.append((lhs.item(), float((a.real * g.real + a.imag * g.imag).sum())))
    maps = torch.randn(plan._maps_shape, generator=gen).to(dev)
    maps.requires_grad_(True)
    b = random_alm_for(gen, plan, torch.float32, dev)
    out = plan.map2alm(maps)
    lhs = (out.real * b.real + out.imag * b.imag).sum()
    (g,) = torch.autograd.grad(lhs, maps)
    errs.append((lhs.item(), float((maps.detach() * g).sum())))
    return max(abs(p - q) / max(abs(p), abs(q), 1e-30) for p, q in errs)


def launched_exactly(what: str, counts: dict, wanted: dict) -> None:
    """Every kernel launched exactly as often as ``wanted`` says, and no
    other kernel at all."""
    got = {k: c for k, c in counts.items() if c}
    log(f"  launches in {what}: {got}")
    if got != wanted:
        raise AssertionError(f"{what}: launched {got}, expected {wanted}")


def check_gradients(dev, spin: int = 0) -> None:
    """The dot identity through autograd on every layout at l_max 256, then
    one full-width gradient step per direction on the default plan at
    l_max 2048, K 8: the backward of alm2map must launch the fused
    analysis and anal_reduce once each, that of map2alm the fused
    synthesis once, and nothing else (on a spin-2 plan: their spin
    branches)."""
    for mode, K in (("cuda_vpu", 1), ("cuda_mxu", 8)):
        for layout in ("plain", "packed", "fused"):
            plan = repro_torch.make_plan("gl", CHECK_L_MAX, K=K,
                                         dtype="float32", mode=mode,
                                         layout=layout, spin=spin)
            err = dot_identity_err(plan, 11 + spin)
            log(f"  {mode} [{layout}] spin {spin} l_max {CHECK_L_MAX} K {K}: "
                f"<A x, y> vs <x, A^T y> through autograd, rel. gap "
                f"{err:.3e} (limit {DOT_TOL:g})")
            if not err < DOT_TOL:
                raise AssertionError(f"{mode} [{layout}] spin {spin}: dot "
                                     f"identity {err}")
    l_max, K = GRAD_SHAPE
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float32", spin=spin)
    if plan.backends["synth"] != "cuda_mxu" or plan.layouts["synth"] != \
            "fused":
        raise AssertionError(f"default plan at {l_max}/K{K} spin {spin}: "
                             f"{plan.backends} {plan.layouts}")
    gen = torch.Generator().manual_seed(13 + spin)
    a0 = random_alm_for(gen, plan, torch.float32, dev)
    d = torch.randn(plan._maps_shape, generator=gen).to(dev)
    b = random_alm_for(gen, plan, torch.float32, dev)

    def synth_step():
        a = a0.clone().requires_grad_(True)
        loss = (plan.alm2map(a) - d).pow(2).sum()
        loss.backward()
        return a.grad

    def anal_step():
        m = d.clone().requires_grad_(True)
        loss = (plan.map2alm(m) - b).abs().pow(2).sum()
        loss.backward()
        return m.grad

    synth_step()                                   # warm-up, plan tables
    anal_step()
    fused = {f"synth_fused_mxu{tag(spin)}": 1}
    anal = {f"anal_fused_mxu{tag(spin)}": 1, "anal_reduce": 1}
    for what, step, fwd_k, bwd_k in (
            ("sum |alm2map(a) - d|^2", synth_step, fused, anal),
            ("sum |map2alm(m) - b|^2", anal_step, anal, fused)):
        synth = step is synth_step
        leaf = (a0 if synth else d).clone().requires_grad_(True)
        reset_launches()
        loss = ((plan.alm2map(leaf) - d).pow(2).sum() if synth
                else (plan.map2alm(leaf) - b).abs().pow(2).sum())
        torch.cuda.synchronize()
        launched_exactly(f"the forward of {what}", read_launches(), fwd_k)
        reset_launches()
        loss.backward()
        torch.cuda.synchronize()
        launched_exactly(f"the backward of {what}", read_launches(), bwd_k)
        grad = torch.view_as_real(leaf.grad) if synth else leaf.grad
        if tuple(leaf.grad.shape) != tuple(leaf.shape) or \
                not bool(torch.isfinite(grad).all()):
            raise AssertionError(f"{what}: non-finite or misshapen gradient")
        del loss, grad, leaf
        ms = host_ms(step)
        with torch.no_grad():
            fwd_ms = host_ms(lambda: plan.alm2map(a0) if synth
                             else plan.map2alm(d))
        log(f"  {what}, spin {spin} l_max {l_max} K {K} [fused, cuda_mxu]: "
            f"forward + backward {ms:.2f} ms (forward alone {fwd_ms:.2f} "
            "ms)")


def main_path(dev, mode: str, l_max: int, K: int, layout: str,
              spin: int, grid: str = "gl", stride: int = 1) -> list:
    """Drive one main path with the launch counters set to 0 just before it
    and read just after; fail if a kernel of the path never launched or
    one outside it did.  Then hold and time each of its kernels at the
    path's own inputs (the plain versions on every ``stride``-th ring),
    and time both directions.  Returns the path's entries of the
    ``kernels`` JSON line."""
    reset_launches()
    run = run_main_path(dev, mode, l_max, K, layout, spin, grid)
    torch.cuda.synchronize()
    counts = read_launches()
    log(f"  {elapsed()} launches on the {mode} [{layout}] spin {spin} "
        "path: "
        f"{ {k: c for k, c in counts.items() if c} }")
    var = mode[5:]
    wanted = PATH_KERNELS[layout](var, tag(spin))
    missing = [k for k in wanted if counts[k] == 0]
    stray = [k for k, c in counts.items() if c and k not in wanted]
    if missing or stray:
        raise AssertionError(f"{mode} [{layout}] spin {spin} path: never "
                             f"launched {missing}, launched outside it "
                             f"{stray}")
    plan, alm, maps = run
    if grid != "gl":
        # the order-fixed bucket fold and the chunk-order reduce: the same
        # bits on every call
        rerun_same("synthesis", digest(maps), lambda: plan.alm2map(alm))
    if grid != "gl" or (layout in ("fused", "plain") and var == "vpu"):
        # (GL: the vpu analysis template's full-width runs, kernels 11 and
        # 3) the fixed-order ring reduction and the chunk-order reduce
        rerun_same("analysis", digest(plan.map2alm(maps)),
                   lambda: plan.map2alm(maps))
    if layout == "packed":
        timed = time_packed_kernels(mode, l_max, K, run)
    else:
        timed = {"fused": time_fused_kernels, "plain": time_kernels}[layout](
            mode, l_max, K, run, stride=stride)
    out = []
    for name, r in timed.items():
        bms, by = r["bound"]
        log(f"  {name:15s} {r['shape']}: {r['ms']:.3f} ms, bound "
            f"{bms:.3f} ms ({by}), plain {r['plain_ms']:.1f} ms, "
            f"library {r['library_ms']}, launches {counts[name]}"
            + ("" if "tables" not in r else
               f", tables {'applied' if r['tables'] else 'skipped'}"))
        base = base_name(name)
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[base],
            "replaces": TPU_KERNELS[base], "spin": spin,
            "branch": SPIN_STEP if spin and base != name else None,
            "path": f"{grid} {mode} {layout} spin {spin}",
            "shape": r["shape"],
            "launches": counts[name], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bms,
            "bound_by": by, "library_ms": r["library_ms"]})
    time_round_trip(mode, l_max, K, layout, run,
                    {k: r["ms"] for k, r in timed.items()})
    del run
    torch.cuda.empty_cache()
    return out


def check_vpu_fold_full_width(dev) -> None:
    """The vpu templates with the equator fold, which no main path runs: on
    a fold plan's own seeds, slot layout and fold tables (GL l_max
    FOLD_VPU_L_MAX, K 1) kernels 9 and 5 (random coefficients) and 11 and 7
    (random FFT rows), and on a plain-layout fold plan's rows and seeds
    kernel 3 (random Delta rows) and kernel 1 (random coefficient rows);
    each held against its plain version at KERNEL_TOL on every
    RING_STRIDE-th ring (the analyses' inputs zero on the other rings;
    empty segments, dead positions and padding rows exactly zero) and
    rerun for identical bits."""
    plan = repro_torch.make_plan("gl", FOLD_VPU_L_MAX, K=1, dtype="float32",
                                 mode="cuda_vpu", fold=True)
    gen = torch.Generator().manual_seed(41)
    alm = random_alm_for(gen, plan, torch.float32, dev)
    plan.map2alm(plan.alm2map(alm))               # fills the plan's store
    _, kw, _ = plan._fused_parts("vpu", False)
    lo, store = kw["lo"], kw["store"]
    prep = store["prep"]
    R, S = prep[1].shape[0], lo.S
    idx = ring_subset(R, RING_STRIDE, dev)
    what = f"{where(plan)} fold, K 1{subset_note(RING_STRIDE)}, "
    dead = torch.as_tensor(lo.a_row < 0, device=dev)
    empty = torch.as_tensor(lo.slot_seed == S, device=dev)
    # the FFT rows first, so the analysis digests stay comparable across
    # versions of this check
    f = (torch.rand((lo.n_slots, 2, 2, 2, R), generator=gen) * 2 - 1).to(dev)
    a_pk = torch.rand((lo.n_slots, S, 2), generator=gen) * 2 - 1
    a_pk = a_pk.masked_fill_(torch.as_tensor(lo.a_row < 0)[..., None],
                             0.0).to(dev)
    tab = store[("tables", "synth")]
    pmaps, seeds = prep[0], prep[1:]
    seeds_c = tuple(on_rings(idx, t) for t in seeds)
    for kind, args, pad in (("fused", (a_pk, *prep, tab), (empty, 1)),
                            ("packed", (a_pk, *prep), (empty, slice(2, 4)))):
        synth = getattr(fused_cuda, f"synth_{kind}_vpu")
        skw = dict(l_max=plan.l_max, fold=True)
        out = synth(*args, **skw)
        args_c = (a_pk, pmaps, *seeds_c) + (
            (on_rings(idx, tab),) if kind == "fused" else ())
        want = getattr(kref, f"synth_{kind}_ref")(*args_c, layout="vpu",
                                                  **skw)
        held(f"synth_{kind}_vpu", on_rings(idx, out), want, what
             + ("fold tables" if kind == "fused" and tab is not None
                else "no tables"), pad)
        rerun_same(f"synth_{kind}_vpu", digest(out),
                   lambda: synth(*args, **skw))
        del out, want
    tab = store[("tables", "anal")]
    kw = dict(l_max=plan.l_max, s_len=S)
    f = rings_only(idx, f, -1)
    for kind, f_k, tabs in (
            ("fused", f, (tab, on_rings(idx, tab))),
            ("packed", f.reshape(lo.n_slots, 4, 2, R), ())):
        anal = getattr(fused_cuda, f"anal_{kind}_vpu")
        args = (f_k, *prep, *tabs[:1])
        out = anal(*args, **kw)
        want = getattr(kref, f"anal_{kind}_ref")(
            on_rings(idx, f_k), pmaps, *seeds_c, *tabs[1:], layout="vpu",
            **kw)
        held(f"anal_{kind}_vpu", out, want, what
             + ("fold tables" if kind == "fused" and tab is not None
                else "no tables"), dead)
        rerun_same(f"anal_{kind}_vpu", digest(out),
                   lambda: anal(*args, **kw))
        del out, want
    del plan, prep, a_pk, f
    plan = repro_torch.make_plan("gl", FOLD_VPU_L_MAX, K=1, dtype="float32",
                                 mode="cuda_vpu", fold=True, layout="plain")
    m_t, x, pmm, pms, _ = plan._row_seeds()
    seeds_c = tuple(on_rings(idx, t) for t in (x, pmm, pms))
    dw = (torch.rand((m_t.shape[0], 2, x.shape[0], 2), generator=gen) * 2
          - 1).to(dev)
    dw = rings_only(idx, dw, 2)
    args = (dw, m_t, x, pmm, pms)
    akw = dict(l_max=plan.l_max, fold=True)
    out = lc.anal_vpu(*args, **akw)
    held("anal_vpu", out, kref.anal_ref(on_rings(idx, dw, 2), m_t, *seeds_c,
                                        **akw),
         f"{where(plan)} fold, K 1, plain layout{subset_note(RING_STRIDE)}",
         m_t < 0)
    rerun_same("anal_vpu", digest(out), lambda: lc.anal_vpu(*args, **akw))
    del out, dw, args
    L = plan.l_max + 1
    keep = (torch.arange(L, device=dev)[None, :] >= m_t[:, None])
    a = ((torch.rand((m_t.shape[0], L, 2), generator=gen) * 2 - 1).to(dev)
         * keep[..., None])
    args = (a, m_t, x, pmm, pms)
    out = lc.synth_vpu(*args, **akw)
    held("synth_vpu", on_rings(idx, out, 2),
         kref.synth_ref(a, m_t, *seeds_c, **akw),
         f"{where(plan)} fold, K 1, plain layout{subset_note(RING_STRIDE)}",
         m_t < 0)
    rerun_same("synth_vpu", digest(out), lambda: lc.synth_vpu(*args, **akw))
    del out, a, args
    torch.cuda.empty_cache()


def check_mxu_synth_fold_full_width(dev) -> None:
    """The mxu synthesis template at full width with the equator fold, which
    no main path runs (both planes' sums in registers, the fold combine on
    them): on a fold plan's own seeds, slot layout and fold tables (GL
    l_max 2048, K 8; 1025 rings, so the last 512-ring chunk holds one)
    kernels 10 and 6 (random coefficients), and on a plain-layout fold
    plan's rows and seeds kernel 2 (random coefficient rows); each held
    against its plain version at KERNEL_TOL (empty segments and padding
    rows exactly zero) and rerun for identical bits."""
    plan = repro_torch.make_plan("gl", 2048, K=8, dtype="float32",
                                 mode="cuda_mxu", fold=True)
    gen = torch.Generator().manual_seed(43)
    alm = random_alm_for(gen, plan, torch.float32, dev)
    plan.map2alm(plan.alm2map(alm))               # fills the plan's store
    _, kw, _ = plan._fused_parts("mxu", False)
    lo, store = kw["lo"], kw["store"]
    prep = store["prep"]
    S = lo.S
    empty = torch.as_tensor(lo.slot_seed == S, device=dev)
    a_pk = torch.rand((lo.n_slots, S, 16), generator=gen) * 2 - 1
    a_pk = a_pk.masked_fill_(torch.as_tensor(lo.a_row < 0)[..., None],
                             0.0).to(dev)
    tab = store[("tables", "synth")]
    what = f"{where(plan)} fold, K 8, "
    for kind, args, pad in (("fused", (a_pk, *prep, tab), (empty, 1)),
                            ("packed", (a_pk, *prep), (empty, slice(2, 4)))):
        synth = getattr(fused_cuda, f"synth_{kind}_mxu")
        skw = dict(l_max=plan.l_max, fold=True)
        out = synth(*args, **skw)
        want = getattr(kref, f"synth_{kind}_ref")(*args, layout="mxu", **skw)
        held(f"synth_{kind}_mxu", out, want, what
             + ("fold tables" if kind == "fused" and tab is not None
                else "no tables"), pad)
        rerun_same(f"synth_{kind}_mxu", digest(out),
                   lambda: synth(*args, **skw))
        del out, want
    del plan, prep, a_pk
    plan = repro_torch.make_plan("gl", 2048, K=8, dtype="float32",
                                 mode="cuda_mxu", fold=True, layout="plain")
    m_t, x, pmm, pms, _ = plan._row_seeds()
    L = plan.l_max + 1
    keep = (torch.arange(L, device=dev)[None, :] >= m_t[:, None])
    a = ((torch.rand((m_t.shape[0], L, 16), generator=gen) * 2 - 1).to(dev)
         * keep[..., None])
    args = (a, m_t, x, pmm, pms)
    akw = dict(l_max=plan.l_max, fold=True)
    out = lc.synth_mxu(*args, **akw)
    held("synth_mxu", out, kref.synth_ref(*args, **akw),
         f"{where(plan)} fold, K 8, plain layout", m_t < 0)
    rerun_same("synth_mxu", digest(out), lambda: lc.synth_mxu(*args, **akw))
    del out, a, args, plan
    torch.cuda.empty_cache()


def bf16_path(dev, grid: str, size: int, K: int, spin: int,
              stride: int = 1) -> list:
    """The bfloat16 branch of kernels 10 and 12 as the reference reaches it,
    ``Plan._make_fused_synth/_make_fused_anal("mxu", bf16=True)`` on the
    default (fused, mxu) plan: the counters set to 0 just before one
    synthesis and one analysis and read just after (the bf16 kernels and
    anal_reduce once each, nothing else); each direction against float32
    within the reference's band; times beside float32; each bf16 kernel
    held against its bf16 plain version at the path's own inputs (on every
    ``stride``-th ring).
    Returns the path's entries of the ``kernels`` JSON line."""
    plan = make_grid_plan(grid, size, K=K, dtype="float32", spin=spin)
    if plan.backends["synth"] != "cuda_mxu" or plan.layouts["synth"] != \
            "fused":
        raise AssertionError(f"bf16 path {grid} {size}: {plan.backends} "
                             f"{plan.layouts}")
    gen = torch.Generator().manual_seed(31 + spin)
    alm = random_alm_for(gen, plan, torch.float32, dev)
    m32 = plan.alm2map(alm)
    a32 = plan.map2alm(m32)
    s16 = plan._make_fused_synth("mxu", bf16=True)
    an16 = plan._make_fused_anal("mxu", bf16=True)
    sfx = tag(spin)
    reset_launches()
    m16 = s16(alm)
    a16 = an16(m32)
    torch.cuda.synchronize()
    counts = read_launches()
    launched_exactly(f"the bf16 path, {where(plan)} K {K} spin {spin}",
                     counts, {f"synth_fused_mxu_bf16{sfx}": 1,
                              f"anal_fused_mxu_bf16{sfx}": 1,
                              "anal_reduce": 1})
    e_s = float((m16 - m32).abs().max() / m32.abs().max())
    e_a = float((a16 - a32).abs().max() / a32.abs().max())
    rt = spectra.d_err(alm, an16(m16))
    t = [host_ms(fn) for fn in (lambda: s16(alm), lambda: plan.alm2map(alm),
                                lambda: an16(m32), lambda: plan.map2alm(m32))]
    log(f"  bf16 {where(plan)} K {K} spin {spin}: against float32 "
        f"synthesis {e_s:.3e}, analysis {e_a:.3e} (band (0, {BF16_GATE:g})); "
        f"bf16 round trip d_err {rt:.3e}; alm2map {t[0]:.2f} ms (float32 "
        f"{t[1]:.2f}), map2alm {t[2]:.2f} ms (float32 {t[3]:.2f})")
    if not (0 < e_s < BF16_GATE and 0 < e_a < BF16_GATE):
        raise AssertionError(f"bf16 {grid} spin {spin}: {e_s}, {e_a}")
    del m16, a16
    timed = time_fused_kernels("cuda_mxu", size, K, (plan, alm, m32),
                               bf16=True, stride=stride)
    out = []
    for name, r in timed.items():
        if "bf16" not in name:
            continue                   # anal_reduce: timed on every path
        bms, by = r["bound"]
        log(f"  {name:15s} {r['shape']}: {r['ms']:.3f} ms, bound "
            f"{bms:.3f} ms ({by}), plain {r['plain_ms']:.1f} ms, "
            f"launches {counts[name]}")
        base = base_name(name)
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[base],
            "replaces": TPU_KERNELS[base], "spin": spin,
            "branch": SPIN_STEP if spin else None,
            "path": f"{grid} cuda_mxu fused bf16 spin {spin}",
            "shape": r["shape"], "launches": counts[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bms, "bound_by": by, "library_ms": None})
    torch.cuda.empty_cache()
    return out


#: (grid, size, spins, layouts) of the float64 anchors on the ragged grids
#: (size: nside, or l_max for ECP; l_max 512 each), both variants
RAGGED_ANCHORS = (("healpix", 256, (0, 2), ("fused", "plain", "packed")),
                  ("healpix_ring", 256, (0,), ("fused",)),
                  ("ecp", 512, (0,), ("fused",)))
#: nside of the HEALPix dot identities (l_max 256, the GL checks' band)
DOT_NSIDE = 128
#: (grid, l_max, K) of phase 6, the cost model and the measured autotune:
#: the sht_cmb synth_2k_k8 shape, and phase 6's budget in seconds
AUTOTUNE_SHAPE = (SYNTH_2K.grid, SYNTH_2K.l_max, SYNTH_2K.K)
AUTOTUNE_BUDGET_S = 90.0


def autotune_path(spin: int) -> None:
    """Phase 6 at one spin: ``make_plan(mode="model")`` (each corner's
    predicted time and the choice), then ``mode="auto"`` with its decision
    on disk in a fresh directory (each corner's measured time beside its
    prediction; every corner finite; the choice per direction the measured
    minimum, backend and layout), then ``clear_plan_cache()`` and a second
    build, which must read the decision back and measure no corner, then
    the chosen plan's round trip."""
    from repro_torch.core import transform
    from repro_torch.roofline import chardb
    grid, l_max, K = AUTOTUNE_SHAPE
    kw = dict(K=K, dtype="float32", spin=spin)
    model = repro_torch.make_plan(grid, l_max, mode="model", **kw)
    directory = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    try:
        before = chardb.stats()["measured"]
        t0 = time.perf_counter()
        plan = repro_torch.make_plan(grid, l_max, mode="auto", cache="disk",
                                     cache_dir=directory, **kw)
        t_auto = time.perf_counter() - t0
        n = chardb.stats()["measured"] - before
        pred, meas = model.predicted_s, plan.measured_s
        log(f"  spin {spin} {where(plan)} K {K}: {n} corners measured in "
            f"{t_auto:.1f} s (decision {plan.cache_events['decision']})")
        for b in plan.candidates:
            lays = plan._kernel_layouts() if b in transform.KERNEL_BACKENDS \
                else (None,)
            for d in ("synth", "anal"):
                for lay in lays:
                    key = d if lay is None else f"{d}_{lay}"
                    p_s, m_s = pred[b][key], meas[b][key]
                    log(f"    {b:8s} {(lay or '-'):6s} {d:5s}: predicted "
                        f"{p_s * 1e3:9.3f} ms, measured {m_s * 1e3:9.3f} ms "
                        f"(measured / predicted {m_s / p_s:.3f})")
                    if not np.isfinite(m_s):
                        raise AssertionError(f"autotune spin {spin}: corner "
                                             f"{b} {lay} {d} not finite")
        for d in ("synth", "anal"):
            corners = {(b, lay): meas[b][d if lay is None else f"{d}_{lay}"]
                       for b in plan.candidates
                       for lay in (plan._kernel_layouts()
                                   if b in transform.KERNEL_BACKENDS
                                   else (None,))}
            best = min(corners, key=corners.get)
            chosen = (plan.backends[d], plan.layouts[d])
            log(f"  spin {spin} {d}: model chose {model.backends[d]} "
                f"[{model.layouts[d]}], autotune chose {chosen[0]} "
                f"[{chosen[1]}], measured minimum {best[0]} [{best[1]}]")
            if chosen != best:
                raise AssertionError(f"autotune spin {spin} {d}: chose "
                                     f"{chosen}, measured minimum {best}")
        transform.clear_plan_cache()
        before = chardb.stats()["measured"]
        again = repro_torch.make_plan(grid, l_max, mode="auto",
                                      cache="disk", cache_dir=directory, **kw)
        n2 = chardb.stats()["measured"] - before
        log(f"  spin {spin} second build: decision "
            f"{again.cache_events.get('decision')}, {n2} corners measured")
        if again.cache_events.get("decision") != "hit" or n2 != 0:
            raise AssertionError(f"autotune spin {spin}: second build "
                                 f"{again.cache_events}, measured {n2}")
        if (again.backends, again.layouts) != (plan.backends, plan.layouts):
            raise AssertionError(f"autotune spin {spin}: cached decision "
                                 "differs from the measured one")
        gen = torch.Generator().manual_seed(29 + spin)
        alm = random_alm_for(gen, again, torch.float32, again.device).to(
            torch.complex64)
        err = spectra.d_err(alm, again.map2alm(again.alm2map(alm)))
        log(f"  spin {spin} chosen plan {again.backends} {again.layouts}: "
            f"round-trip d_err {err:.3e} (limit {ROUNDTRIP_TOL:g})")
        if not err < ROUNDTRIP_TOL:
            raise AssertionError(f"autotune spin {spin}: round trip {err}")
        log("  " + again.report().replace("\n", "\n  "))
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        transform.clear_plan_cache()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: the serving engine on the card
# ---------------------------------------------------------------------------

#: l_max of phase 7 (GL, float32): the sht_cmb synth_2k_k8 signature at
#: spin 0 and 2; engine A's requests, in this interleaved order, as
#: (direction, spin) blocks of 5 repeated SERVE_BLOCKS times (24 alm2map
#: spin 0, 8 alm2map spin 2, 8 map2alm spin 0); engine B's requests; and
#: phase 7's budget in seconds
SERVE_L_MAX = SYNTH_2K.l_max
SERVE_BLOCK = (("alm2map", 0), ("alm2map", 0), ("alm2map", 0),
               ("alm2map", 2), ("map2alm", 0))
SERVE_BLOCKS = 8
SERVE_B_REQUESTS = 16
SERVE_BUDGET_S = 90.0


def serve_payloads(dev) -> list:
    """Engine A's requests in submission order, ``(direction, spin,
    payload)``: numpy alm drawn in float32 from a fixed seed (complex64;
    (E, B) pairs at spin 2), the map2alm maps synthesised from the first
    spin-0 alm by a K=1 plan on the card."""
    from repro_torch.launch.serve import random_alm
    rng = np.random.default_rng(24)
    reqs = [(d, s) for _ in range(SERVE_BLOCKS) for d, s in SERVE_BLOCK]
    alms = {0: [], 2: []}
    for d, s in reqs:
        if d == "alm2map":
            alms[s].append(random_alm(rng, SERVE_L_MAX, s, np.float32))
    plan = repro_torch.make_plan("gl", SERVE_L_MAX, K=1, dtype="float32")
    maps = [plan.alm2map(torch.as_tensor(a[..., None], device=dev))
            .cpu().numpy()[..., 0] for a in alms[0][:SERVE_BLOCKS]]
    it = {(d, s): iter(alms[s] if d == "alm2map" else maps)
          for d, s in set(reqs)}
    return [(d, s, next(it[(d, s)])) for d, s in reqs]


def serve_kernel(direction: str, plan, spin: int) -> str:
    """The counter name of the fused kernel a pooled plan runs for one
    request direction."""
    d = "synth" if direction == "alm2map" else "anal"
    if plan.layouts[d] != "fused":
        raise AssertionError(f"serving: {d} layout {plan.layouts[d]}, "
                             "expected the fused default")
    return f"{d}_fused_{plan.backends[d][5:]}{tag(spin)}"


def serve_engine_a(dev, reqs: list) -> None:
    """Engine A, double-buffered: one request of each group alone (so each
    group runs a K=1 batch, the vpu kernels 9 and 11), then the others in
    one interleaved burst (the buckets the queue forms; K 8 runs the mxu
    kernels 10 and 12); background warm-ups of each signature's K=8 plan.
    The launch counters are set to 0 just before and read just after, and
    must equal what the batch log and the warm-ups imply.  Each result is
    held against a K=1 plan of its batch's backend and layout (KERNEL_TOL),
    and one batch replayed through its pooled plan must give the engine's
    bits."""
    from repro_torch.serve import PlanSig, ShtEngine
    sigs = {s: dict(grid="gl", l_max=SERVE_L_MAX, dtype="float32", spin=s)
            for s in (0, 2)}
    firsts = sorted({(d, s): i for i, (d, s, _) in
                     reversed(list(enumerate(reqs)))}.values())
    reset_launches()
    t0 = time.perf_counter()
    eng = ShtEngine(max_k=8, warm_after=2, mode=None)
    futs = {}
    with eng:
        for i in firsts:
            d, s, p = reqs[i]
            futs[i] = eng.submit(direction=d, payload=p, **sigs[s])
        for i in firsts:
            futs[i].result(timeout=600)
        for i, (d, s, p) in enumerate(reqs):
            if i not in futs:
                futs[i] = eng.submit(direction=d, payload=p, **sigs[s])
        for f in futs.values():
            f.result(timeout=600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = read_launches()
    # the engine's request ids, in submission order, to indices of reqs
    index = {f.rid: i for i, f in futs.items()}
    st = eng.stats()
    log("  " + eng.report().replace("\n", "\n  "))
    r = st["requests"]
    log(f"  engine A: {r['completed']}/{len(reqs)} completed, "
        f"{r['failed']} failed, {r['timed_out']} timed out in {wall:.2f} s "
        f"(throughput {st['throughput_rps']:.2f} req/s); warm-ups "
        f"{st['pool']['warmups']}, warm-up failures {st['warm_failures']}")
    if r["completed"] != len(reqs) or r["failed"] or r["timed_out"]:
        raise AssertionError(f"serving: engine A requests {r}")
    warmed = [s for s in (0, 2)
              if st["signatures"][PlanSig(**sigs[s]).label()] >= 2]
    if st["pool"]["warmups"] != len(warmed) or st["warm_failures"]:
        raise AssertionError(f"serving: warm-ups {st['pool']['warmups']} "
                             f"of {len(warmed)}, failures "
                             f"{st['warm_failures']}")
    lat = st["latency"]
    log("  latency ms p50 | p95 | p99: " + "; ".join(
        f"{k} {lat[k]['p50_s'] * 1e3:.2f} | {lat[k]['p95_s'] * 1e3:.2f} | "
        f"{lat[k]['p99_s'] * 1e3:.2f}" for k in ("queue", "compute",
                                                 "total")))
    co = st["coalescing"]
    log(f"  coalescing: {co['requests_per_batch']:.3f} requests and K "
        f"{co['k_per_batch']:.3f} a batch, occupancy {co['k_occupancy']:.3f}"
        f", {co['batches']} batches; pool {st['pool']['hits']} hits, "
        f"{st['pool']['misses']} misses")

    # the kernels the batches and the warm-ups imply, and their counts
    expected: dict = {}
    plans = {}
    for b in eng.batch_log:
        spin = 2 if "spin2" in b["signature"] else 0
        plan = eng.pool.get(PlanSig(**sigs[spin]), b["k_plan"])
        plans[(spin, b["k_plan"])] = plan
        name = serve_kernel(b["direction"], plan, spin)
        expected[name] = expected.get(name, 0) + 1
        if b["direction"] == "map2alm":
            expected["anal_reduce"] = expected.get("anal_reduce", 0) + 1
    for spin in warmed:
        plan = eng.pool.get(PlanSig(**sigs[spin]), eng.max_k)
        for d in ("alm2map", "map2alm"):
            name = serve_kernel(d, plan, spin)
            expected[name] = expected.get(name, 0) + 1
        expected["anal_reduce"] = expected.get("anal_reduce", 0) + 1
    launched = {k: c for k, c in counts.items() if c}
    log(f"  launches: {launched}; implied by the batches and warm-ups: "
        f"{expected}")
    if launched != expected:
        raise AssertionError(f"serving: launches {launched}, expected "
                             f"{expected}")
    for k in ("synth_fused_vpu", "synth_fused_mxu", "anal_fused_vpu",
              "anal_fused_mxu"):
        if not launched.get(k):
            raise AssertionError(f"serving: {k} never launched")
    buckets = sorted({(b["direction"], b["signature"], b["k_plan"])
                      for b in eng.batch_log})
    log("  batches (direction, signature, K bucket): "
        + ", ".join(f"{d} {s} K {k}" for d, s, k in buckets))

    # each result against a K=1 plan of its batch's backend and layout
    held_by: dict = {}
    for b in eng.batch_log:
        spin = 2 if "spin2" in b["signature"] else 0
        plan = plans[(spin, b["k_plan"])]
        d = "synth" if b["direction"] == "alm2map" else "anal"
        ref = repro_torch.make_plan("gl", SERVE_L_MAX, K=1, dtype="float32",
                                    spin=spin, mode=plan.backends[d],
                                    layout=plan.layouts[d])
        run = ref.alm2map if d == "synth" else ref.map2alm
        key = (b["direction"], spin, b["k_plan"], plan.backends[d])
        n, same, gap = held_by.get(key, (0, 0, 0.0))
        for rid in b["rids"]:
            got = futs[index[rid]].result()
            want = run(torch.as_tensor(reqs[index[rid]][2][..., None],
                                       device=dev)).cpu().numpy()[..., 0]
            n += 1
            same += bool(np.array_equal(got, want))
            gap = max(gap, float(np.abs(got - want).max()
                                 / np.abs(want).max()))
        held_by[key] = (n, same, gap)
    for (d, spin, k, backend), (n, same, gap) in sorted(held_by.items()):
        log(f"  {d} spin {spin} K bucket {k} ({backend} [fused]): {n} "
            f"results against a K=1 plan, {same} bit-equal, largest gap "
            f"{gap:.3e} of max|ref| (limit {KERNEL_TOL:g})")
        if not gap <= KERNEL_TOL:
            raise AssertionError(f"serving: {d} spin {spin} K {k} gap {gap}")

    # one batch replayed through its pooled plan: the stacking and slicing
    b = max((b for b in eng.batch_log if b["direction"] == "alm2map"
             and "spin0" in b["signature"]), key=lambda b: b["k_plan"])
    plan = plans[(0, b["k_plan"])]
    parts = [reqs[index[rid]][2] for rid in b["rids"]]
    parts += [np.zeros_like(parts[0])] * (b["k_plan"] - len(parts))
    replay = plan.alm2map(torch.as_tensor(np.stack(parts, -1), device=dev)
                          ).cpu().numpy()
    same = [bool(np.array_equal(replay[..., i], futs[index[rid]].result()))
            for i, rid in enumerate(b["rids"])]
    log(f"  replay of a K {b['k_plan']} batch ({len(b['rids'])} requests) "
        f"through its pooled plan: {sum(same)}/{len(same)} bit-equal")
    if not all(same):
        raise AssertionError("serving: the replayed batch differs")
    per_batch = [futs[index[b["rids"][0]]].timing for b in eng.batch_log]
    form = np.mean([t["form_s"] for t in per_batch])
    comp = np.mean([t["compute_s"] for t in per_batch])
    log(f"  mean a batch: form {form * 1e3:.2f} ms (host stacking, pinned "
        f"copy, upload), compute {comp * 1e3:.2f} ms (transform to the "
        "execute stream's synchronisation)")
    del eng, futs, plans
    torch.cuda.empty_cache()


def serve_engine_b(dev, reqs: list) -> None:
    """Engine B, synchronous: admission at a p99 target of 2 x the H100
    model's K=4 time x 1.05, which must cap the GL 2048 spin-0 synthesis
    group at K 4; every batch within the cap and the calibration ratio
    (measured / predicted compute) finite and positive."""
    from repro_torch.roofline import HW_H100, k_caps_for_target
    from repro_torch.serve import ShtEngine
    g = repro_torch.make_plan("gl", SERVE_L_MAX, K=1, dtype="float32").grid
    by_k = k_caps_for_target(
        l_max=SERVE_L_MAX, n_rings=g.n_rings, n_phi=g.max_n_phi, max_k=8,
        p99_target_s=1.0, backend="cuda_mxu", hw=HW_H100)["predicted_s_by_k"]
    target = 2.0 * by_k[4] * 1.05
    log("  H100 model (cuda_mxu) ms by K: " + ", ".join(
        f"{k} {t * 1e3:.4f}" for k, t in by_k.items())
        + f"; p99 target {target * 1e3:.4f} ms")
    eng = ShtEngine(max_k=8, p99_target_s=target)
    eng.prewarm(grid="gl", l_max=SERVE_L_MAX, dtype="float32", k=4)
    alms = [p for d, s, p in reqs if d == "alm2map" and s == 0]
    futs = [eng.submit(direction="alm2map", payload=a, grid="gl",
                       l_max=SERVE_L_MAX, dtype="float32")
            for a in alms[:SERVE_B_REQUESTS]]
    eng.drain()
    st = eng.stats()
    log("  " + eng.report().replace("\n", "\n  "))
    (group,) = st["admission"]["groups"].values()
    cal = st["admission"]["calibration"]
    k_plans = [b["k_plan"] for b in eng.batch_log]
    comp = [f.timing["compute_s"] * 1e3 for f in futs]
    log(f"  engine B: k_cap {group['k_cap']}, batches at K {k_plans}, "
        f"compute ms {sorted(set(round(c, 3) for c in comp))}; calibration "
        f"measured / predicted {cal['ratio']:.3f} over {cal['count']} "
        f"batches ({cal['measured_s'] * 1e3:.3f} / "
        f"{cal['predicted_s'] * 1e3:.3f} ms)")
    if st["requests"]["completed"] != len(futs) or st["requests"]["failed"]:
        raise AssertionError(f"serving: engine B {st['requests']}")
    if group["k_cap"] != 4 or max(k_plans) > 4:
        raise AssertionError(f"serving: admission k_cap {group['k_cap']}, "
                             f"batches {k_plans}")
    if not (np.isfinite(cal["ratio"]) and cal["ratio"] > 0):
        raise AssertionError(f"serving: calibration {cal}")


def serve_cli() -> None:
    """``python -m repro_torch.launch.serve`` on the card, as a user would
    call it (no ``--device``): it must complete every request."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--lmax",
           str(SERVE_L_MAX), "--max-k", "8", "--requests", "8", "--mode",
           "cuda_mxu"]
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (src, os.environ.get("PYTHONPATH")))))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)
    log(f"  {' '.join(cmd[1:])}: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in proc.stdout.splitlines():
        log(f"    {line}")
    if proc.returncode != 0 or "completed 8/8 requests" not in proc.stdout:
        raise AssertionError(f"serving CLI: exit {proc.returncode}\n"
                             f"{proc.stderr[-4000:]}")


# ---------------------------------------------------------------------------
# phase 8: the distributed transform on the card (NCCL, world size 1)
# ---------------------------------------------------------------------------

#: (grid, l_max, K) of phase 8: the sht_cmb synth_2k_k8 shape; its
#: process-group backend and its stage 1; its budget in seconds
DIST_SHAPE = (SYNTH_2K.grid, SYNTH_2K.l_max, SYNTH_2K.K)
DIST_BACKEND = "nccl"
DIST_STAGE1 = "cuda"
DIST_BUDGET_S = 45.0
#: the dist path against the serial plain plan of its shape, relative to
#: max|serial|: the synthesis runs the same (m, ring) arithmetic and cuFFT
#: lengths and should be bit-equal, so a gap names the stage that moved;
#: the analysis sums its rings pair-interleaved over R_pad, another order
DIST_TOL = 1e-6
#: the bfloat16 exchange against the float32 one: the reference's band
#: (tests/helpers/dist_sht_check.py)
DIST_BF16_BAND = 2e-2
#: the shard count of the dealing check (b)
DIST_DEAL_SHARDS = 4
#: the kernels phase 8 must launch: 1-8, the spin branches of (a)'s
#: kernels, and the analyses' reduce
DIST_KERNELS = ("synth_vpu", "synth_mxu", "anal_vpu", "anal_mxu",
                "synth_packed_vpu", "synth_packed_mxu", "anal_packed_vpu",
                "anal_packed_mxu", "synth_mxu_spin", "anal_mxu_spin",
                "anal_reduce")


@contextlib.contextmanager
def world_of_one(dev):
    """A process group of one rank on the card (a HashStore, no ports),
    destroyed on the way out.  A NCCL that cannot start raises."""
    import torch.distributed as tdist
    kw = {}
    if DIST_BACKEND == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    tdist.init_process_group(DIST_BACKEND, store=tdist.HashStore(), rank=0,
                             world_size=1, **kw)
    try:
        yield
    finally:
        tdist.destroy_process_group()


#: launches phase 8 made on the dist path (its engines and stage-1
#: adapters; not the serial plans it is held against)
DIST_COUNTS: dict = {}


@contextlib.contextmanager
def on_dist_path():
    """Add the kernel launches made inside to DIST_COUNTS."""
    torch.cuda.synchronize()
    before = read_launches()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        for k, c in read_launches().items():
            DIST_COUNTS[k] = DIST_COUNTS.get(k, 0) + c - before.get(k, 0)


def numpy_alm(rng, l_max: int, K: int, spin: int, dev) -> torch.Tensor:
    """Random float32 alm (an (E, B) pair at spin 2) from numpy, zero where
    l < max(m, spin), m = 0 real, on ``dev``."""
    shape = ((2,) if spin else ()) + (l_max + 1, l_max + 1, K)
    a = (rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)).astype(
        np.complex64)
    a *= sht.alm_mask(l_max, l_max, spin=spin)[..., None]
    a[..., 0, :, :] = a[..., 0, :, :].real
    return torch.as_tensor(a).to(dev)


def dist_calls(d):
    """(synthesis, analysis) of a DistSHT on dense alm / grid-order maps,
    the plan's whole-array calls: pack, the engine's collective transform,
    scatter back."""
    sp = d.plan

    def synth(alm):
        if alm.ndim == 4:
            qu = d.alm2map_spin(torch.stack([sp.pack_alm(alm[0]),
                                             sp.pack_alm(alm[1])]))
            return torch.stack([sp.scatter_map(qu[0]),
                                sp.scatter_map(qu[1])])
        return sp.scatter_map(d.alm2map(sp.pack_alm(alm)))

    def anal(maps):
        if maps.ndim == 4:
            eb = d.map2alm_spin(torch.stack([sp.gather_map(maps[0]),
                                             sp.gather_map(maps[1])]))
            return torch.stack([sp.unpack_alm(eb[0]), sp.unpack_alm(eb[1])])
        return sp.unpack_alm(d.map2alm(sp.gather_map(maps)))

    return synth, anal


def rel_gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def held_dist(what: str, got, want, *, bits: bool = False) -> bool:
    """Log a dist output against its serial counterpart (bit equality and
    the gap relative to max|want|), hold it to DIST_TOL, or to the bit
    with ``bits``; returns the bit equality."""
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    gap = rel_gap(got, want)
    log(f"  {what}: bit-equal {equal}, max|d| / max|serial| {gap:.3e} "
        f"(limit {'the bit' if bits else f'{DIST_TOL:g}'})")
    if (bits and not equal) or not gap <= DIST_TOL:
        raise AssertionError(f"{what}: {gap} (bit-equal {equal})")
    return equal


def serial_delta(serial, alm) -> torch.Tensor:
    """The serial plain plan's Delta (M, R, C), channels [re | im] (spin 2:
    [Q re | U re | Q im | U im]): its staged synthesis up to the phase
    stage."""
    K = serial.K
    m_t, x32, pmm, pms, mp_t = serial._row_seeds()
    a = serial._eb_rows(alm) if serial.spin else \
        torch.cat([alm.real, alm.imag], dim=-1).to(torch.float32)
    out = ops.synth(a, m_t, x32, pmm, pms, l_max=serial.l_max,
                    variant=ops.pick_variant(2 * K), layout="plain",
                    mp_vals=mp_t)[:, 0]
    if not serial.spin:
        return out
    dq_re, dq_im, du_re, du_im = legendre.spin_unpack_delta(out[..., :K],
                                                            out[..., K:])
    return torch.cat([dq_re, du_re, dq_im, du_im], dim=-1)


def which_stage_moved(d, serial, alm) -> str:
    """Stage 1's Delta of the dist engine (rows and rings put back in the
    serial order) against the serial plan's: equal means the phase stage
    moved."""
    from repro_torch.core.plan import _slot_of
    sp = d.plan
    a_loc = torch.stack([sp.pack_alm(alm[0]), sp.pack_alm(alm[1])]) \
        if serial.spin else sp.pack_alm(alm)
    got = d.delta_local(a_loc)
    dev = got.device
    rows = torch.as_tensor(_slot_of(sp.m_flat, sp.m_max + 1), device=dev)
    rings = torch.as_tensor(_slot_of(sp.ring_order, sp.grid.n_rings),
                            device=dev)
    got = got.index_select(0, rows).index_select(1, rings)
    want = serial_delta(serial, alm)
    if torch.equal(got, want):
        return "stage 1 bit-equal: the phase stage moved"
    return f"stage 1 moved ({rel_gap(got, want):.3e})"


def dist_exchange_ms(d, C: int, dev, to_rings: bool) -> tuple:
    """(ms, bytes, GB/s) of one exchange alone on the Delta block of one
    chunk, C channels (to the rings: (m_local, R_pad, C); back: (Mp,
    r_local, C)), CUDA events."""
    sp = d.plan
    shape = (sp.m_local, sp.r_pad, C) if to_rings else \
        (sp.n_shards * sp.m_local, sp.r_local, C)
    blk = torch.rand(shape, device=dev)

    def once():
        pending = []
        raw = d._exchange(blk, to_rings=to_rings, pending=pending)
        d._wait(pending)
        return raw

    ms = cuda_time_ms(once)
    nb = blk.numel() * blk.element_size()
    return ms, nb, nb / ms / 1e6


def dist_full_width(dev, spin: int) -> dict:
    """(a) at DIST_SHAPE: DistSHT (the kernels' stage 1, plain layout) at C
    1 and 2 against the serial plain cuda_mxu plan on the same numpy
    inputs; both directions held, timed (host clock, mean of 3 after a
    warm-up, beside the serial plan's), the exchange timed alone, the
    round trip checked.  Returns what (b), (d) and (e) reuse."""
    from repro_torch.core.dist_sht import DistSHT
    from repro_torch.core.plan import SHTPlan
    grid, l_max, K = DIST_SHAPE
    serial = repro_torch.make_plan(grid, l_max, K=K, dtype="float32",
                                   mode="cuda_mxu", layout="plain", spin=spin)
    sp = SHTPlan(serial.grid, l_max, l_max, 1)
    alm = numpy_alm(np.random.default_rng(80 + spin), l_max, K, spin, dev)
    want_s = serial.alm2map(alm)
    want_a = serial.map2alm(want_s)
    t_s = host_ms(lambda: serial.alm2map(alm))
    t_a = host_ms(lambda: serial.map2alm(want_s))
    log(f"  spin {spin} serial cuda_mxu [plain] {where(serial)} K {K}: "
        f"alm2map {t_s:.2f} ms, map2alm {t_a:.2f} ms")
    engines, outs = {}, {}
    for C in (1, 2):
        d = engines[C] = DistSHT(sp, device=dev, dtype="float32",
                                 stage1=DIST_STAGE1, comm_chunks=C,
                                 layout="plain")
        synth, anal = dist_calls(d)
        with on_dist_path():
            got_s, got_a = synth(alm), anal(want_s)
        axis = sp.chunk_schedule(K, 1 + (spin > 0), C)[0]
        what = f"spin {spin} C {C} " + (
            "(one exchange)" if axis == "none" else f"({axis} axis)")
        if not held_dist(f"dist alm2map {what}", got_s, want_s):
            log(f"    {which_stage_moved(d, serial, alm)}")
        held_dist(f"dist map2alm {what}", got_a, want_a)
        with on_dist_path():
            err = spectra.d_err(alm, anal(got_s))
            ms_s = host_ms(lambda: synth(alm))
            ms_a = host_ms(lambda: anal(want_s))
        log(f"  dist {what}: alm2map {ms_s:.2f} ms, map2alm {ms_a:.2f} ms "
            f"(serial {t_s:.2f}, {t_a:.2f}); round trip d_err {err:.3e} "
            f"(limit {ROUNDTRIP_TOL:g})")
        if not err < ROUNDTRIP_TOL:
            raise AssertionError(f"dist {what}: round trip {err}")
        outs[C] = got_s
    same_bits(f"dist alm2map spin {spin} C 2 = C 1", outs[2], outs[1])
    for C in (1, 2):
        for to_rings in (True, False):
            ms, nb, rate = dist_exchange_ms(
                engines[C], 2 * (1 + (spin > 0)) * K // C, dev, to_rings)
            log(f"  exchange alone, spin {spin} C {C} "
                f"{'to the rings' if to_rings else 'back to the m rows'}: "
                f"{ms:.3f} ms a chunk, {nb / 1e6:.1f} MB, {rate:.1f} GB/s "
                "(world size 1: a copy to itself)")
    return {"serial": serial, "engines": engines, "alm": alm,
            "maps": want_s, "synth": outs[1]}


def dist_dealt_rows(dev, run: dict) -> None:
    """(b) SHTPlan(n_shards=DIST_DEAL_SHARDS) at (a)'s shape: each rank's
    dealt rows through the stage-1 adapters on the plain (kernels 2, 4)
    and packed (6, 8) layouts; the synthesis bit for bit against the
    matching rows of (a)'s exchanged Delta (both kernels compute each
    (m, ring) alike), padding rows exactly zero; the analysis, on (a)'s
    weighted Delta rows, against (a)'s analysis of them."""
    from repro_torch.core.plan import SHTPlan, _slot_of
    d1 = run["engines"][1]
    sp1 = d1.plan
    grid, l_max, K = DIST_SHAPE
    sp = SHTPlan(sp1.grid, l_max, l_max, DIST_DEAL_SHARDS)
    geo, log_mu = sp.ring_geometry, legendre.log_mu(l_max)
    delta1 = d1.delta_local(sp1.pack_alm(run["alm"]))       # (M, R1, 2K)
    dw_re, dw_im = d1._anal_fft(sp1.gather_map(run["maps"]))
    a1 = ops.alm_from_delta_auto(dw_re, dw_im, sp1.m_flat, sp1.ring_geometry,
                                 log_mu, l_max=l_max, variant="mxu")
    slot = _slot_of(sp1.m_flat, l_max + 1)
    R1, a_pk = sp1.r_pad, sp1.pack_alm(run["alm"])
    for layout in ("plain", "packed"):
        for r in range(DIST_DEAL_SHARDS):
            rows = sp.m_assignment[r]
            live = torch.as_tensor(rows >= 0, device=dev)
            idx = torch.as_tensor(slot[np.maximum(rows, 0)], device=dev)
            a = a_pk.index_select(0, idx) * live[:, None, None]
            with on_dist_path():
                d_re, d_im = ops.delta_from_alm_auto(
                    a.real.contiguous(), a.imag.contiguous(), rows, geo,
                    log_mu, l_max=l_max, variant="mxu", layout=layout,
                    store={})
            got = torch.cat([d_re, d_im], dim=-1)
            want = delta1.index_select(0, idx)
            pad_zero = not bool(got[~live].any())
            what = (f"rank {r} of {DIST_DEAL_SHARDS} [{layout}] "
                    f"({int(live.sum())} rows + {int((~live).sum())} "
                    f"padding)")
            held_dist(f"{what} stage-1 synthesis vs (a)'s Delta rows",
                      got[live][:, :R1], want[live], bits=True)
            if not pad_zero:
                raise AssertionError(f"{what}: padding rows not zero")
            pad = torch.zeros((len(rows), sp.r_pad - R1, K), device=dev)
            w_re = torch.cat([dw_re.index_select(0, idx), pad], dim=1)
            w_im = torch.cat([dw_im.index_select(0, idx), pad], dim=1)
            with on_dist_path():
                g_re, g_im = ops.alm_from_delta_auto(
                    w_re * live[:, None, None], w_im * live[:, None, None],
                    rows, geo, log_mu, l_max=l_max, variant="mxu",
                    layout=layout, store={})
            held_dist(f"{what} stage-1 analysis vs (a)'s rows",
                      torch.cat([g_re, g_im], -1)[live],
                      torch.cat(a1, -1).index_select(0, idx)[live])
            if bool(torch.cat([g_re, g_im], -1)[~live].any()):
                raise AssertionError(f"{what}: analysis padding rows not "
                                     "zero")


def dist_vpu(dev) -> None:
    """(c) GL 2048 K 1 spin 0 C 1 (the same grid: its cuFFT plans are
    built): the vpu variant through the dist path on the plain layout
    (kernels 1, 3) and the packed one (5, 7) against the serial plain
    cuda_vpu plan."""
    from repro_torch.core.dist_sht import DistSHT
    from repro_torch.core.plan import SHTPlan
    grid, l_max, _ = DIST_SHAPE
    serial = repro_torch.make_plan(grid, l_max, K=1, dtype="float32",
                                   mode="cuda_vpu", layout="plain")
    sp = SHTPlan(serial.grid, l_max, l_max, 1)
    alm = numpy_alm(np.random.default_rng(82), l_max, 1, 0, dev)
    want_s = serial.alm2map(alm)
    want_a = serial.map2alm(want_s)
    for layout in ("plain", "packed"):
        d = DistSHT(sp, device=dev, dtype="float32", stage1=DIST_STAGE1,
                    layout=layout)
        synth, anal = dist_calls(d)
        with on_dist_path():
            got_s, got_a = synth(alm), anal(want_s)
            err = spectra.d_err(alm, anal(got_s))
        held_dist(f"dist alm2map K 1 [{layout}] (vpu)", got_s, want_s)
        held_dist(f"dist map2alm K 1 [{layout}] (vpu)", got_a, want_a)
        log(f"  dist K 1 [{layout}]: alm2map {host_ms(lambda: synth(alm)):.2f}"
            f" ms, map2alm {host_ms(lambda: anal(want_s)):.2f} ms (serial "
            f"plain {host_ms(lambda: serial.alm2map(alm)):.2f}, "
            f"{host_ms(lambda: serial.map2alm(want_s)):.2f}); round trip "
            f"d_err {err:.3e}")
        if not err < ROUNDTRIP_TOL:
            raise AssertionError(f"dist K 1 [{layout}]: round trip {err}")


def dist_bf16(dev, run: dict) -> None:
    """(d) the bfloat16 exchange once, spin 0 K 8: against the float32
    exchange, inside the reference's band (and not equal: the cast ran)."""
    from repro_torch.core.dist_sht import DistSHT
    d = DistSHT(run["engines"][1].plan, device=dev, dtype="float32",
                stage1=DIST_STAGE1, comm_dtype="bfloat16")
    with on_dist_path():
        got = dist_calls(d)[0](run["alm"])
    gap = rel_gap(got, run["synth"])
    log(f"  bf16 exchange, alm2map spin 0 K {DIST_SHAPE[2]}: against the "
        f"float32 exchange {gap:.3e} (band (0, {DIST_BF16_BAND:g}))")
    if not 0 < gap < DIST_BF16_BAND:
        raise AssertionError(f"bf16 exchange: {gap}")


def dist_gradient(run: dict) -> None:
    """(e) <A x, y> against <x, A^T y> through autograd on the dist path at
    (a)'s shape, spin 0: the backward of each direction runs the other
    direction's kernels and the reverse exchange."""
    import types
    d = run["engines"][1]
    synth, anal = dist_calls(d)
    s = run["serial"]
    shim = types.SimpleNamespace(
        alm2map=synth, map2alm=anal, _maps_shape=s._maps_shape,
        device=s.device, spin=0, l_max=s.l_max, m_max=s.m_max, K=s.K)
    with on_dist_path():
        err = dot_identity_err(shim, 83)
    log(f"  dist spin 0 {where(s)} K {s.K}: <A x, y> vs <x, A^T y> through "
        f"autograd, rel. gap {err:.3e} (limit {DOT_TOL:g})")
    if not err < DOT_TOL:
        raise AssertionError(f"dist dot identity {err}")


def dist_phase(dev) -> None:
    """Phase 8: (a)-(e) in one process group of one rank; the launch
    counters set to 0 before, every launch on the dist path counted
    (:func:`on_dist_path`), every kernel of DIST_KERNELS held to have
    launched there."""
    with world_of_one(dev):
        reset_launches()
        DIST_COUNTS.clear()
        with stamped("(a) full width, spin 0"):
            run = dist_full_width(dev, 0)
        with stamped("(b) dealt rows"):
            dist_dealt_rows(dev, run)
        with stamped("(a) full width, spin 2"):
            dist_full_width(dev, 2)
        with stamped("(c) vpu"):
            dist_vpu(dev)
        with stamped("(d) bf16 exchange"):
            dist_bf16(dev, run)
        with stamped("(e) gradient"):
            dist_gradient(run)
        log("  launches on the dist path in phase 8: "
            f"{ {k: c for k, c in DIST_COUNTS.items() if c} }")
        missing = [k for k in DIST_KERNELS if not DIST_COUNTS.get(k)]
        if missing:
            raise AssertionError(f"phase 8 never launched {missing}")
        del run
    repro_torch.clear_plan_cache()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the dense decoders' serving path (repro_torch.models)
# ---------------------------------------------------------------------------

#: the architecture of phase 9, at its published widths and depth
MODEL_ARCH = "qwen3-8b"
MODEL_SEED = 9
#: (a): prefill (B, S), then MODEL_DECODE_STEPS decode steps; the
#: stepwise check (B, S); the loss forward (B, S)
MODEL_PREFILL = (4, 512)
MODEL_DECODE_STEPS = 32
MODEL_STEPWISE = (1, 16)
MODEL_LOSS = (2, 512)
#: (a): bfloat16 prefill against token-by-token decode, relative to
#: max|prefill logits|.  Both round every product and elementwise result
#: to bfloat16, at other GEMM shapes (M = S against M = 1), so the
#: hidden states drift by bfloat16 ulps (2^-8 relative) layer by layer.
#: On the CPU the port's bf16 logits sit 1.25e-2 from the reference's at
#: depth 2 and its prefill 1.85e-2 from its stepwise decode at depth 36
#: (reduced widths, tests/test_torch_models.py and PERF.md); the limit is
#: 5e-2, while a wrong cache slot, position or mask moves the logits O(1).
MODEL_STEPWISE_TOL = 5e-2
#: (b): float32 at the same widths, depth cut to MODEL_F32_LAYERS: the
#: card against the port's CPU run on the same weights (TF32 off), relative
#: to max|CPU|; (B, prompt, decode steps) of its run, kept short: the CPU
#: half reads the 2.5 GB float32 embedding for every logit row batch (12.4
#: s of (b) at (2, 32, 4) on the card's host, PR 26)
MODEL_F32_LAYERS = 2
MODEL_F32_RUN = (2, 16, 2)
MODEL_F32_TOL = 1e-4
#: phase 9's budget in seconds
MODEL_BUDGET_S = 20.0


def model_tokens(gen, B: int, S: int, vocab: int, dev) -> torch.Tensor:
    return torch.randint(0, vocab, (B, S), generator=gen, device=dev,
                         dtype=torch.int32)


def event_ms(fn) -> tuple:
    """(result, device ms) of one call of ``fn`` between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def model_bounds(cfg, B: int, S: int, weight_bytes: int) -> tuple:
    """Least times (ms) of a prefill of (B, S) and of one decode step at
    batch B after S tokens: bf16 products at the bf16 peak (attention's
    float32 scores and values at the float32 peak) against the weights
    read once (and, for decode, the cache read once)."""
    hd, H, KvH = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    d, F, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    per_tok = 2 * (d * (H + 2 * KvH) * hd + H * hd * d + 3 * d * F)
    # QK^T and PV over the causal triangle: S(S+1)/2 key positions a query
    attn = 2 * 2 * B * H * (S * (S + 1) // 2) * hd
    pre_flops = L * (B * S * per_tok) + 2 * B * d * V
    pre_ms = max(pre_flops / PEAK_BF16_FLOPS * 1e3
                 + L * attn / PEAK_F32_FLOPS * 1e3,
                 weight_bytes / PEAK_BYTES_S * 1e3)
    cache = L * 2 * B * S * KvH * hd * 2
    dec_ms = max((L * B * per_tok + 2 * B * d * V) / PEAK_BF16_FLOPS * 1e3,
                 (weight_bytes + cache) / PEAK_BYTES_S * 1e3)
    return pre_ms, dec_ms


def model_full_width(dev) -> dict:
    """(a) MODEL_ARCH at full width and depth in its bfloat16: prefill and
    decode timed, finite logits, prefill against stepwise decode, one loss
    forward."""
    cfg = model_registry.get(MODEL_ARCH)
    bundle = make_bundle(cfg)
    torch.cuda.reset_peak_memory_stats()
    model, init_ms = event_ms(lambda: bundle.init(MODEL_SEED))
    n = sum(p.numel() for p in model.parameters())
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_dtype}: {n} parameters "
        f"(config count {cfg.n_params()}), {wbytes / 1e9:.2f} GB, drawn on "
        f"the card in {init_ms:.0f} ms")
    norms = cfg.n_layers * (2 * cfg.d_model
                            + (2 * cfg.hd if cfg.qk_norm else 0)) + cfg.d_model
    if cfg.qkv_bias or n != cfg.n_params() + norms:
        raise AssertionError(f"{n} parameters: not the config's count plus "
                             f"its {norms} norm scales")
    gen = torch.Generator(device=dev).manual_seed(MODEL_SEED)
    B, S = MODEL_PREFILL
    steps = MODEL_DECODE_STEPS
    toks = model_tokens(gen, B, S + steps, cfg.vocab, dev)
    # a warm-up prefill (cuBLAS handles and workspaces), then the timed one
    bundle.prefill_fn(model, {"tokens": toks[:, :S]},
                      bundle.init_caches(B, S + steps))
    caches = bundle.init_caches(B, S + steps)
    (logits, caches), pre_ms = event_ms(lambda: bundle.prefill_fn(
        model, {"tokens": toks[:, :S]}, caches))
    finite = [bool(torch.isfinite(logits).all())]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(S, S + steps):
        logits, caches = bundle.decode_fn(model, toks[:, t:t + 1], t, caches)
        finite.append(bool(torch.isfinite(logits).all()))
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3 / steps
    pre_bound, dec_bound = model_bounds(cfg, B, S, wbytes)
    run = {"prefill_ms": pre_ms, "decode_ms": dec_ms,
           "prefill_tok_s": B * S / pre_ms * 1e3,
           "decode_tok_s": B / dec_ms * 1e3,
           "prefill_bound_ms": pre_bound, "decode_bound_ms": dec_bound}
    log(f"  prefill B {B} x {S}: {pre_ms:.1f} ms (CUDA events), "
        f"{run['prefill_tok_s']:.0f} tokens/s, bound {pre_bound:.1f} ms")
    log(f"  decode {steps} steps at B {B}: {dec_ms:.2f} ms a step "
        f"(host clock, synchronised), {run['decode_tok_s']:.0f} tokens/s, "
        f"bound {dec_bound:.2f} ms a step (weights + cache read once)")
    if not all(finite):
        raise AssertionError(f"{cfg.name}: non-finite logits at steps "
                             f"{[i for i, f in enumerate(finite) if not f]}")
    del caches, logits
    B1, S1 = MODEL_STEPWISE
    toks1 = model_tokens(gen, B1, S1, cfg.vocab, dev)
    lp, _ = bundle.prefill_fn(model, {"tokens": toks1},
                              bundle.init_caches(B1, S1))
    c = bundle.init_caches(B1, S1)
    for t in range(S1):
        ld, c = bundle.decode_fn(model, toks1[:, t:t + 1], t, c)
    gap = float((lp - ld).abs().max() / lp.abs().max())
    log(f"  prefill vs token-by-token decode (B {B1}, {S1} tokens): rel. "
        f"gap {gap:.3e} (limit {MODEL_STEPWISE_TOL:g}), max|logit| "
        f"{float(lp.abs().max()):.3f}")
    if not gap < MODEL_STEPWISE_TOL:
        raise AssertionError(f"{cfg.name}: prefill vs stepwise decode {gap}")
    B2, S2 = MODEL_LOSS
    with torch.no_grad():
        loss, loss_ms = event_ms(lambda: bundle.loss_fn(
            model, {"tokens": model_tokens(gen, B2, S2, cfg.vocab, dev)}))
    log(f"  loss forward B {B2} x {S2}: {float(loss):.4f} in "
        f"{loss_ms:.1f} ms (ln vocab {np.log(cfg.vocab):.4f})")
    if not np.isfinite(float(loss)):
        raise AssertionError(f"{cfg.name}: loss {float(loss)}")
    run.update(stepwise_gap=gap, loss=float(loss),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  peak memory {run['peak_gb']:.2f} GB "
        "(torch.cuda.max_memory_allocated)")
    del model
    torch.cuda.empty_cache()
    return run


def model_card_vs_cpu(dev) -> None:
    """(b) the same widths in float32, MODEL_F32_LAYERS layers: weights
    drawn on the card, copied to the host; prefill logits, each decode
    step's logits and the loss held to the port's CPU run on them."""
    cfg = dataclasses.replace(model_registry.get(MODEL_ARCH),
                              n_layers=MODEL_F32_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    gpu, cpu = make_bundle(cfg), make_bundle(cfg, device="cpu")
    t0 = time.perf_counter()
    model = gpu.init(MODEL_SEED + 1)
    host = cpu.from_state(model.state_dict())
    secs = [time.perf_counter() - t0]
    B, S, steps = MODEL_F32_RUN
    toks = model_tokens(torch.Generator().manual_seed(MODEL_SEED), B,
                        S + steps, cfg.vocab, "cpu")
    gaps = []

    def hold(what, got, want):
        gap = float((got.cpu() - want).abs().max() / want.abs().max())
        gaps.append(gap)
        if not gap < MODEL_F32_TOL:
            raise AssertionError(f"float32 {what}: card vs CPU {gap}")

    runs = []
    for b, m in ((gpu, model), (cpu, host)):
        t0 = time.perf_counter()
        t = toks.to(b.device)
        logits, c = b.prefill_fn(m, {"tokens": t[:, :S]},
                                 b.init_caches(B, S + steps))
        outs = [logits]
        for i in range(S, S + steps):
            logits, c = b.decode_fn(m, t[:, i:i + 1], i, c)
            outs.append(logits)
        with torch.no_grad():
            outs.append(b.loss_fn(m, {"tokens": t}).reshape(1))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        runs.append(outs)
    for i, (got, want) in enumerate(zip(*runs)):
        hold("prefill" if i == 0 else "loss" if i == len(runs[0]) - 1
             else f"decode step {i}", got, want)
    log(f"  float32, {MODEL_F32_LAYERS} layers, B {B}, prompt {S}, {steps} "
        f"decode steps, loss: card vs CPU rel. gaps "
        f"{', '.join(f'{g:.2e}' for g in gaps)} (limit {MODEL_F32_TOL:g}; "
        f"TF32 off); s: draw + copy to the host {secs[0]:.1f}, card "
        f"{secs[1]:.1f}, CPU {secs[2]:.1f}")
    del model, host
    torch.cuda.empty_cache()


def model_phase(dev, card: str) -> dict:
    """Phase 9: (a) then (b); fails past MODEL_BUDGET_S."""
    log(f"  card: {card}")
    t0 = time.perf_counter()
    with stamped("(a) qwen3-8b full width bf16"):
        run = model_full_width(dev)
    with stamped("(b) float32 card vs CPU"):
        model_card_vs_cpu(dev)
    wall = time.perf_counter() - t0
    if wall > MODEL_BUDGET_S:
        raise AssertionError(f"phase 9 took {wall:.1f} s, budget "
                             f"{MODEL_BUDGET_S:g} s")
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    count_plain_seconds()
    t0 = time.perf_counter()
    with stamped("phase 1"):
        built = build.build()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(sorted(built))}, one nvcc each, run together)")
    for name, (_, build_log) in sorted(built.items()):
        for line in build_log.splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"  ptxas {name}: {line.strip()}")

    log(f"{elapsed()} phase 2: kernels against their plain versions, limit "
        f"{KERNEL_TOL:g}")
    with stamped("phase 2"):
        for spin in SPINS:
            log(f"  -- spin {spin}" + (": the kernels' spin branch on the "
                                       "2M Wigner-d rows" if spin else ""))
            with stamped(f"phase 2 spin {spin}"):
                check_kernels(dev, bool(spin))
                check_fused_kernels(dev, bool(spin))
                check_packed_kernels(dev, bool(spin))
                check_bf16_kernels(dev, bool(spin))
                check_bucket_chains(dev, spin)

    log(f"{elapsed()} phase 3: main paths at full width; each kernel "
        "against its plain version at the shapes the path gave it")
    kernels = []
    with stamped("phase 3"):
        for spin in SPINS:
            for mode, l_max, K, layout in MAIN_PATH:
                stride = RING_STRIDE if ("gl", l_max, layout, spin) in \
                    RING_SUBSET_PATHS else 1
                with stamped(f"gl {l_max} {mode} {layout} spin {spin}"):
                    kernels += main_path(dev, mode, l_max, K, layout, spin,
                                         stride=stride)
        log(f"{elapsed()}   -- the vpu templates (kernels 9, 5, 11, 7, 3, "
            f"1) with the fold at l_max {FOLD_VPU_L_MAX}")
        with stamped("vpu templates with the fold"):
            check_vpu_fold_full_width(dev)
        log(f"{elapsed()}   -- the mxu synthesis template (kernels 10, 6, 2) "
            "at full width with the fold")
        with stamped("mxu synthesis template with the fold"):
            check_mxu_synth_fold_full_width(dev)
        log(f"{elapsed()}   -- the ragged-grid paths: HEALPix, ring-uniform "
            "HEALPix, ECP")
        for grid, size, mode, K, layout, spins in RAGGED_PATHS:
            for spin in spins:
                stride = RING_STRIDE if (grid, size, layout, spin) in \
                    RING_SUBSET_PATHS else 1
                with stamped(f"{grid} {size} {mode} {layout} spin {spin}"):
                    kernels += main_path(dev, mode, size, K, layout, spin,
                                         grid, stride=stride)
        log(f"{elapsed()}   -- the bfloat16 branch of kernels 10 and 12")
        for grid, size, K, spin, stride in BF16_PATHS:
            with stamped(f"{grid} {size} bf16 spin {spin}"):
                kernels += bf16_path(dev, grid, size, K, spin, stride)

    log(f"{elapsed()} phase 4: float64 anchor")
    with stamped("phase 4"):
        for spin in SPINS:
            f64_anchor(dev, spin)
        for grid, size, spins, layouts in RAGGED_ANCHORS:
            for spin in spins:
                f64_anchor(dev, spin, grid, size, layouts)

    log(f"{elapsed()} phase 5: gradients on the card")
    with stamped("phase 5"):
        for spin in SPINS:
            check_gradients(dev, spin)
        for spin in SPINS:
            for mode, K in (("cuda_vpu", 1), ("cuda_mxu", 8)):
                for layout in ("fused", "plain"):
                    plan = repro_torch.make_plan(
                        "healpix", nside=DOT_NSIDE, K=K, dtype="float32",
                        mode=mode, layout=layout, spin=spin)
                    err = dot_identity_err(plan, 17 + spin)
                    log(f"  {mode} [{layout}] spin {spin} {where(plan)} K "
                        f"{K}: <A x, y> vs <x, A^T y> through autograd, rel. "
                        f"gap {err:.3e} (limit {DOT_TOL:g})")
                    if not err < DOT_TOL:
                        raise AssertionError(f"healpix {mode} [{layout}] "
                                             f"spin {spin}: dot identity "
                                             f"{err}")

    log(f"{elapsed()} phase 6: cost model and measured autotune at "
        f"{AUTOTUNE_SHAPE[0]} l_max {AUTOTUNE_SHAPE[1]} K "
        f"{AUTOTUNE_SHAPE[2]} (budget {AUTOTUNE_BUDGET_S:g} s)")
    with stamped("phase 6"):
        for spin in SPINS:
            autotune_path(spin)

    log(f"{elapsed()} phase 7: the serving engine at gl l_max "
        f"{SERVE_L_MAX} float32, spin 0 and 2 (budget {SERVE_BUDGET_S:g} s)")
    with stamped("phase 7"):
        with stamped("serving payloads"):
            reqs = serve_payloads(dev)
        with stamped("engine A, double-buffered"):
            serve_engine_a(dev, reqs)
        with stamped("engine B, admission"):
            serve_engine_b(dev, reqs)
        with stamped("serving CLI"):
            serve_cli()
        del reqs
        repro_torch.clear_plan_cache()
        torch.cuda.empty_cache()

    log(f"{elapsed()} phase 8: the distributed transform, {DIST_BACKEND} at "
        f"world size 1, {DIST_SHAPE[0]} l_max {DIST_SHAPE[1]} K "
        f"{DIST_SHAPE[2]} (budget {DIST_BUDGET_S:g} s)")
    with stamped("phase 8"):
        dist_phase(dev)

    torch.cuda.empty_cache()
    log(f"{elapsed()} phase 9: the dense decoders' serving path, "
        f"{MODEL_ARCH} at full width (budget {MODEL_BUDGET_S:g} s; TF32 "
        "off for every float32 product)")
    with stamped("phase 9"):
        model_phase(dev, card)

    log("timeline: wall s | plain-version s")
    for label, wall, plain in TIMELINE:
        log(f"  {label:40s} {wall:8.1f} | {plain:8.1f}")
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s "
        "(kernel build included)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
