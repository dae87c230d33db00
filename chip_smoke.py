"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout (one ``nvcc``
per source, started together), holds each against its plain PyTorch
version on the card, drives the port's main paths at the repo's full
widths (``make_plan("gl", ...)`` then ``alm2map`` then ``map2alm``, the
``sht_cmb`` shapes l_max 2048 K 8 and l_max 4096 K 1, on the fused layout
the plans pick by default, on the staged plain layout and on the packed
staged layout), checks that every kernel of each path launched, prints a
digest of each kernel's output and holds the bits equal where two layouts
run the same code, times each kernel beside its bound, anchors every
kernel plan to the float64 ``torch`` plan, and takes gradients through
the plans on the card (dot identities on every layout, one full-width
step whose backward must run the other direction's kernels).  Every phase
runs twice: for the spin-0 transform pair and for the spin-2 one
(``make_plan(..., spin=2)``: (E, B) alm <-> (Q, U) maps), whose paths
launch the spin branch of every kernel.
Prints the card's name and power limit, one JSON line of per-kernel
numbers, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, without a CUDA device or without the
rest of the repository.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
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

#: H100 SXM datasheet peaks (dense, 700 W): float32 on the CUDA cores and HBM3
PEAK_F32_FLOPS = 67e12
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
#: l_max of the kernel checks (phase 2) and the dot identities (phase 5),
#: of the float64 anchor (phase 4), and (l_max, K) of the full-width
#: gradient step (phase 5): the sht_cmb main shape of the mxu variant
CHECK_L_MAX = 256
ANCHOR_L_MAX = 512
GRAD_SHAPE = (2048, 8)
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


def log(msg: str) -> None:
    print(msg, flush=True)


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


def bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops = flops / PEAK_F32_FLOPS * 1e3
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
         pad=None) -> float:
    """Hold a kernel's output against its plain version's at KERNEL_TOL
    (relative to max|plain|), padding rows exactly zero; log the gap and
    both outputs' digests, and return max|difference|."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    zero_pad = pad is None or bool((got[pad] == 0).all())
    log(f"  {name:15s} {what}: max|d|/max|plain| = {rel:.3e}"
        + ("" if pad is None else f"  padding zero: {zero_pad}")
        + f"  digest {digest(got)} (plain {digest(want)})")
    if not (rel < KERNEL_TOL and zero_pad):
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


def check_kernels(dev, spin: bool = False) -> None:
    """Hold each kernel against its plain version at l_max 256, K 1 and 8,
    fold off and on, with padding rows among the real ones; log kernel and
    plain times with fold off at each variant's main-path K (1 for vpu, 8
    for mxu).  With ``spin`` the kernels' spin branch on the 2M spin rows
    (fold off), whose analysis rows below l0 = max(m, |m'|) and reduce
    output there must be exact zeros."""
    l_max = CHECK_L_MAX
    gen = torch.Generator().manual_seed(2 + 100 * spin)
    # plan padding: -1 rows among the real ones must come out exactly zero
    if spin:
        m_vals, mp_vals = spin_test_rows(l_max)
    else:
        m_vals = np.concatenate([np.arange(l_max + 1), [-1, -1]])
        m_vals, mp_vals = np.insert(m_vals, 17, -1), None
    pad = np.flatnonzero(m_vals < 0)
    mp_t = None if mp_vals is None else torch.as_tensor(
        mp_vals, dtype=torch.int32, device=dev)
    L, sfx = l_max + 1, tag(spin)
    for fold in ((False,) if spin else (False, True)):
        m_t, x, pmm, pms = seeds_for(l_max, m_vals, fold, dev, mp_vals)
        R, P = x.shape[0], (2 if fold else 1)
        kw = dict(l_max=l_max, fold=fold, mp_vals=mp_t)
        for K in (1, 8):
            K2 = 2 * K
            a = random_a(gen, m_vals, L, K2, dev, mp_vals)
            dw = (torch.rand((len(m_vals), P, R, K2), generator=gen) * 2 - 1
                  ).to(dev)
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


# ---------------------------------------------------------------------------
# phase 3: the main paths at full width, then each kernel at its shapes
# ---------------------------------------------------------------------------

#: (mode, l_max, K, layout): the sht_cmb shapes, first on the fused layout
#: the plans pick by default, then on the staged plain and packed layouts;
#: each runs as the spin-0 pair and as the spin-2 (E, B) <-> (Q, U) pair
MAIN_PATH = (("cuda_mxu", 2048, 8, "fused"), ("cuda_vpu", 4096, 1, "fused"),
             ("cuda_mxu", 2048, 8, "plain"), ("cuda_vpu", 4096, 1, "plain"),
             ("cuda_mxu", 2048, 8, "packed"), ("cuda_vpu", 4096, 1, "packed"))
SPINS = (0, 2)

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


def run_main_path(dev, mode: str, l_max: int, K: int, layout: str,
                  spin: int = 0) -> tuple:
    """One sht_cmb round trip through make_plan/alm2map/map2alm (spin 2:
    (E, B) alm -> (Q, U) maps -> (E, B) alm)."""
    gen = torch.Generator().manual_seed(l_max + K + spin)
    if spin:
        alm = sht.random_alm_spin(gen, l_max, l_max, K, dtype=torch.float32,
                                  device=dev)
    else:
        alm = sht.random_alm(gen, l_max, l_max, K, dtype=torch.float32,
                             device=dev)
    t0 = time.perf_counter()
    # the fused paths are the plans' default layout: called as a user would
    plan = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                                 mode=mode, spin=spin,
                                 layout=None if layout == "fused" else layout)
    if plan.layouts != {"synth": layout, "anal": layout}:
        raise AssertionError(f"{mode}: layouts {plan.layouts}")
    maps = plan.alm2map(alm)
    alm2 = plan.map2alm(maps)
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
    log(f"  {mode} [{layout}] spin {spin} l_max={l_max} K={K}: maps "
        f"{tuple(maps.shape)}, round-trip d_err = {err:.3e} (limit "
        f"{ROUNDTRIP_TOL:g}), {secs:.2f} s with plan build")
    if not err < ROUNDTRIP_TOL:
        raise AssertionError(f"{mode} spin {spin} round trip d_err {err}")
    return plan, alm, maps


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


def time_kernels(mode: str, l_max: int, K: int, run: tuple) -> dict:
    """Each kernel of one main path at the shapes that path gave it: held
    against its plain version on the same inputs, then kernel time, plain
    version time, bound, and the library call where one exists."""
    var = mode[5:]
    plan, alm, maps = run
    m_t, x, pmm, pms, mp_t = plan._row_seeds()
    sfx = tag(plan.spin)
    a, dw = path_rows(plan, alm, maps)
    K2, R, L = 2 * K, x.shape[0], l_max + 1
    what = f"l_max {l_max}, K {K} (main path)"
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
    want_s, plain_s = plain_ms(lambda: kref.synth_ref(a, m_t, x, pmm, pms,
                                                      **rkw))
    want_a, plain_a = plain_ms(lambda: kref.anal_ref(dw, m_t, x, pmm, pms,
                                                     **rkw))
    want_r, plain_r = plain_ms(lambda: kref.anal_reduce_ref(part, m_t,
                                                            **rkw))
    err_s = held(f"synth_{var}{sfx}", out_s, want_s, what)
    err_a = held(f"anal_{var}{sfx}", out_a, want_a, what)
    err_r = held("anal_reduce", out_a, want_r, what)
    if plan.spin:
        below_zero(f"anal_{var}{sfx}", out_a, m_t.cpu().numpy(), mp_np)
    dig_a = digest(out_a)
    del want_s, want_a, want_r, out_s, out_a
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
                    S: int, what: str, spin: bool) -> None:
    """The fused analysis with explicit identity tables against the skipped
    tables of the main path: the kernel must give the same bits (1 re +
    0 im == re), while the plain version, which then contracts a rotated
    copy instead of a view of the rows, may round its ring sums in another
    order.  Logs both, so a change in the gap between runs is seen to come
    from the plain version or from the kernel."""
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
    plain = kref.anal_fused_ref(f_pk, *prep, ident, l_max=l_max, s_len=S,
                                layout=var, spin=spin)
    gap = float((out_a - plain).abs().max() / plain.abs().max())
    log(f"  anal_fused_{var}{sfx} plain version with identity tables: digest "
        f"{digest(plain)} (without: {digest(want_a)}), kernel vs it "
        f"{gap:.3e}")


def time_fused_kernels(mode: str, l_max: int, K: int, run: tuple) -> dict:
    """Each kernel of one fused main path at the shapes that path gave it
    (the plan's own packed seeds and tables), as :func:`time_kernels`."""
    var = mode[5:]
    plan, alm, maps = run
    spin = bool(plan.spin)
    sfx = tag(spin)
    _, kw = plan._fused_parts(var)
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
                          n=plan.phase.n, fold_rings=None, n_half=x.shape[0],
                          spin=spin)
    f_pk = ops._pack_rows(fp, lo)
    f_pk = (f_pk.movedim(-1, 3) if var == "vpu" else f_pk).contiguous()
    del fp
    K2, R, L, S = 2 * K, x.shape[0], l_max + 1, lo.S
    zeros = torch.zeros(lo.n_slots, dtype=torch.int32, device=x.device)
    what = f"l_max {l_max}, K {K} (fused main path)"
    triples, flops = legendre_work(rows, L, R, K2, mp_rows)
    synth = getattr(fused_cuda, f"synth_fused_{var}")

    def run_s():
        return synth(a_pk, pmaps, x, pmm_pk, pms_pk, tab_s, l_max=l_max,
                     spin=spin)

    def run_a():
        return fused_cuda.anal_fused_partials(var, f_pk, pmaps, x, pmm_pk,
                                              pms_pk, tab_a, l_max=l_max,
                                              s_len=S, spin=spin)

    out_s, part = run_s(), run_a()
    out_a = lc.anal_reduce(part, zeros, l_max=S - 1)
    want_s, plain_s = plain_ms(lambda: kref.synth_fused_ref(
        a_pk, pmaps, x, pmm_pk, pms_pk, tab_s, l_max=l_max, layout=var,
        spin=spin))
    want_a, plain_a = plain_ms(lambda: kref.anal_fused_ref(
        f_pk, pmaps, x, pmm_pk, pms_pk, tab_a, l_max=l_max, s_len=S,
        layout=var, spin=spin))
    want_r, plain_r = plain_ms(lambda: kref.anal_reduce_ref(part, zeros,
                                                            l_max=S - 1))
    empty = torch.as_tensor(lo.slot_seed == S, device=x.device)
    dead = torch.as_tensor(lo.a_row < 0, device=x.device)
    err_s = held(f"synth_fused_{var}{sfx}", out_s, want_s, what, (empty, 1))
    err_a = held(f"anal_fused_{var}{sfx}", out_a, want_a, what, dead)
    err_r = held("anal_reduce", out_a, want_r, what)
    dig_a = digest(out_a)
    if tab_a is None:
        identity_tables(var, out_a, want_a, f_pk, (pmaps, x, pmm_pk, pms_pk),
                        l_max, S, what, spin)
    del want_s, want_a, want_r, out_s, out_a
    ms_s, ms_a = cuda_time_ms(run_s), cuda_time_ms(run_a)
    ms_r = cuda_time_ms(lambda: lc.anal_reduce(part, zeros, l_max=S - 1))
    rerun_same(f"anal_fused_{var}{sfx}", dig_a,
               lambda: lc.anal_reduce(run_a(), zeros, l_max=S - 1))
    lib_r = cuda_time_ms(lambda: part.sum(dim=1))
    seeds = nbytes(x, pmm_pk, pms_pk, *pmaps)
    shape = f"l_max {l_max}, K {K}, {lo.n_slots} slots x S {S}"
    # rows: one (slot, segment) each; the reduce reads the live positions
    # of every chunk and writes the full packed output
    live = triples // R
    n_ch = part.shape[1]
    red_bytes = live * n_ch * K2 * 4 + lo.n_slots * S * K2 * 4
    red_ops = live * (n_ch - 1) * K2
    return {
        f"synth_fused_{var}{sfx}": dict(
            ms=ms_s, plain_ms=plain_s, library_ms=None, err=err_s,
            shape=shape, tables=tab_s is not None,
            bound=bound_ms(flops + rotation_ops(tab_s, K),
                           nbytes(a_pk, tab_s) + seeds
                           + lo.n_slots * 2 * R * K2 * 4)),
        f"anal_fused_{var}{sfx}": dict(
            ms=ms_a, plain_ms=plain_a, library_ms=None, err=err_a,
            shape=shape, tables=tab_a is not None,
            bound=bound_ms(flops + rotation_ops(tab_a, K),
                           nbytes(f_pk, tab_a, part) + seeds)),
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
    zeros = torch.zeros(lo.n_slots, dtype=torch.int32, device=x.device)
    what = f"l_max {l_max}, K {K} (packed main path)"
    triples, flops = legendre_work(rows, L, R, K2, mp_rows)
    synth = getattr(fused_cuda, f"synth_packed_{var}")

    def run_s():
        return synth(a_pk, pmaps, x, pmm_pk, pms_pk, l_max=l_max, spin=spin)

    def run_a():
        return fused_cuda.anal_packed_partials(var, dk, pmaps, x, pmm_pk,
                                               pms_pk, l_max=l_max, s_len=S,
                                               spin=spin)

    out_s, part = run_s(), run_a()
    out_a = lc.anal_reduce(part, zeros, l_max=S - 1)
    want_s, plain_s = plain_ms(lambda: kref.synth_packed_ref(
        a_pk, pmaps, x, pmm_pk, pms_pk, l_max=l_max, layout=var, spin=spin))
    want_a, plain_a = plain_ms(lambda: kref.anal_packed_ref(
        dk, pmaps, x, pmm_pk, pms_pk, l_max=l_max, s_len=S, layout=var,
        spin=spin))
    want_r, plain_r = plain_ms(lambda: kref.anal_reduce_ref(part, zeros,
                                                            l_max=S - 1))
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
    ms_r = cuda_time_ms(lambda: lc.anal_reduce(part, zeros, l_max=S - 1))
    lib_r = cuda_time_ms(lambda: part.sum(dim=1))
    rerun_same(f"anal_packed_{var}{sfx}", dig_a,
               lambda: lc.anal_reduce(run_a(), zeros, l_max=S - 1))
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


def time_round_trip(mode: str, l_max: int, K: int, layout: str, run: tuple,
                    kernel_ms: dict) -> None:
    """Steady-state time of each direction of one main path, with its
    Legendre (or fused) kernel time and its FFT time; the rest is the
    layout glue (re|im split, packing, scatter/gather)."""
    plan, alm, maps = run
    syn = host_ms(lambda: plan.alm2map(alm))
    ana = host_ms(lambda: plan.map2alm(maps))
    g, n = plan.grid, plan.phase.n
    pmaps = path_maps(plan, maps)            # Q|U as 2K channels on spin 2
    if layout in ("plain", "packed"):
        delta = plan.phase.anal(pmaps)
        fft_s = cuda_time_ms(lambda: plan.phase.synth(delta))
        fft_a = cuda_time_ms(lambda: plan.phase.anal(pmaps))
        what = "phase stage"
    else:
        H = torch.zeros((g.n_rings, n // 2 + 1, pmaps.shape[-1]),
                        dtype=torch.complex64, device=maps.device)
        fft_s = cuda_time_ms(lambda: torch.fft.irfft(H, n=n, dim=1))
        fft_a = cuda_time_ms(lambda: torch.fft.rfft(pmaps, dim=1))
        what = "FFT"
    var = mode[5:]
    names = PATH_KERNELS[layout](var, tag(plan.spin))
    k_s = kernel_ms[names[0]]
    k_a = kernel_ms[names[1]] + kernel_ms["anal_reduce"]
    log(f"  {mode} [{layout}] spin {plan.spin} l_max={l_max} K={K}: alm2map "
        f"{syn:.2f} ms "
        f"(kernel {k_s:.2f}, {what} {fft_s:.2f}, rest "
        f"{syn - k_s - fft_s:.2f}), map2alm {ana:.2f} ms (kernels "
        f"{k_a:.2f}, {what} {fft_a:.2f}, rest {ana - k_a - fft_a:.2f})")


# ---------------------------------------------------------------------------
# phase 4: float64 anchor
# ---------------------------------------------------------------------------


def random_alm_for(gen, plan, dtype, dev) -> torch.Tensor:
    """Random alm of a plan's shape: an (E, B) pair on a spin-2 plan."""
    draw = sht.random_alm_spin if plan.spin else sht.random_alm
    return draw(gen, plan.l_max, plan.m_max, plan.K, dtype=dtype, device=dev)


def f64_anchor(dev, spin: int = 0) -> None:
    """Every float32 kernel plan (both variants; fused, plain, packed)
    against the float64 torch plan of the same spin at l_max 512, K 2."""
    l_max, K = ANCHOR_L_MAX, 2
    gen = torch.Generator().manual_seed(7 + spin)
    p64 = repro_torch.make_plan("gl", l_max, K=K, dtype="float64",
                                mode="torch", spin=spin)
    alm = random_alm_for(gen, p64, torch.float64, dev)
    maps64 = p64.alm2map(alm)
    alm64 = p64.map2alm(maps64)
    for mode in ("cuda_vpu", "cuda_mxu"):
        for layout in ("fused", "plain", "packed"):
            p32 = repro_torch.make_plan("gl", l_max, K=K, dtype="float32",
                                        mode=mode, layout=layout, spin=spin)
            maps32 = p32.alm2map(alm.to(torch.complex64))
            alm32 = p32.map2alm(maps64.to(torch.float32))
            rel_s = float((maps32 - maps64).abs().max() / maps64.abs().max())
            rel_a = float((alm32 - alm64).abs().max() / alm64.abs().max())
            log(f"  {mode} [{layout}] spin {spin} vs torch float64, "
                f"l_max={l_max} K={K}: synthesis {rel_s:.3e}, analysis "
                f"{rel_a:.3e} (limit {ANCHOR_TOL:g})")
            if not max(rel_s, rel_a) < ANCHOR_TOL:
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
              spin: int) -> list:
    """Drive one main path with the launch counters set to 0 just before it
    and read just after; fail if a kernel of the path never launched or
    one outside it did.  Then hold and time each of its kernels at the
    path's own inputs, and time both directions.  Returns the path's
    entries of the ``kernels`` JSON line."""
    reset_launches()
    run = run_main_path(dev, mode, l_max, K, layout, spin)
    torch.cuda.synchronize()
    counts = read_launches()
    log(f"  launches on the {mode} [{layout}] spin {spin} path: "
        f"{ {k: c for k, c in counts.items() if c} }")
    var = mode[5:]
    wanted = PATH_KERNELS[layout](var, tag(spin))
    missing = [k for k in wanted if counts[k] == 0]
    stray = [k for k, c in counts.items() if c and k not in wanted]
    if missing or stray:
        raise AssertionError(f"{mode} [{layout}] spin {spin} path: never "
                             f"launched {missing}, launched outside it "
                             f"{stray}")
    timed = {"fused": time_fused_kernels, "plain": time_kernels,
             "packed": time_packed_kernels}[layout](mode, l_max, K, run)
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
            "path": f"{mode} {layout} spin {spin}", "shape": r["shape"],
            "launches": counts[name], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bms,
            "bound_by": by, "library_ms": r["library_ms"]})
    time_round_trip(mode, l_max, K, layout, run,
                    {k: r["ms"] for k, r in timed.items()})
    del run
    torch.cuda.empty_cache()
    return out


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

    t0 = time.perf_counter()
    built = build.build()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(sorted(built))}, one nvcc each, run together)")
    for name, (_, build_log) in sorted(built.items()):
        for line in build_log.splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"  ptxas {name}: {line.strip()}")

    log("phase 2: kernels against their plain versions, limit "
        f"{KERNEL_TOL:g}")
    for spin in SPINS:
        log(f"  -- spin {spin}" + (": the kernels' spin branch on the 2M "
                                   "Wigner-d rows" if spin else ""))
        check_kernels(dev, bool(spin))
        check_fused_kernels(dev, bool(spin))
        check_packed_kernels(dev, bool(spin))

    log("phase 3: main paths at full width; each kernel against its plain "
        "version at the shapes the path gave it")
    kernels = []
    for spin in SPINS:
        for mode, l_max, K, layout in MAIN_PATH:
            kernels += main_path(dev, mode, l_max, K, layout, spin)

    log("phase 4: float64 anchor")
    for spin in SPINS:
        f64_anchor(dev, spin)

    log("phase 5: gradients on the card")
    for spin in SPINS:
        check_gradients(dev, spin)

    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s "
        "(kernel build included)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
