"""Kernel 2 (``synth_mxu``, ``csrc/legendre.cu``) emulated on the CPU,
against its plain version and, with ``--against``, against another
revision's kernel bit for bit.

    python3 scripts/host_emu/run.py [--against REV]

The sources are compiled with g++ (C++20, ``-ffp-contract=off``) against
the stand-in headers of this directory: every launch runs its blocks one
at a time, a block's threads as ``std::thread``s meeting at a
``std::barrier``, and every float32 operation is one IEEE operation, as
on the card.  So the emulation gives the card's bits wherever the kernel
rounds as written (it does not emulate shuffles, tensor-core ``mma`` or
the card's scheduling: races that a barrier hides on the host stay
hidden).  ``--against`` builds REV's sources (``git show``) beside the
working tree's and fails unless every output is equal bit for bit.
Prints, for each case, the gap to ``kernels.ref.synth_ref`` as a share of
max|plain| and whether the padding row is exactly zero.  The ``ONE_HOT``
cases give each channel a single coefficient 1 (channel c of every row at
one l of its own, spread from the row's first l to l_max): every sum is
then one recurrence value, exact in both the kernel's ``fmaf`` sums and
the plain version's products and adds, so kernel and plain version must
agree bit for bit (the spin branch at l_max 258: the contracted update,
``fmaf`` on the host as on the card, against ``kref.fma_f32``).  Builds into
``scripts/host_emu/_build/`` (git-ignored); about three minutes with
``--against``.
"""
import argparse
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import grids, legendre  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

CSRC = "src/repro_torch/kernels/csrc"
FILES = ("legendre.cu", "recurrence.cuh", "mxu_anal.cuh", "mxu_synth.cuh")
BUILD = os.path.join(HERE, "_build")

#: (l_max, K, fold, spin, rings or None for l_max + 1, seed): small rows,
#: every channel block (K 1, 3, 8, 12: 2, 8 with 6 live, 16, 16 + 8), the
#: fold and the spin branch, rows longer than a 256-l group (the sums
#: stashed across a table fill), one ring past a 512-ring chunk
CASES = ((40, 1, False, False, None, 0), (40, 3, True, False, None, 0),
         (40, 8, False, True, None, 0), (40, 12, False, False, None, 0),
         (40, 8, True, False, None, 0), (30, 2, False, True, None, 0),
         (300, 8, False, False, None, 1), (300, 1, True, False, None, 2),
         (258, 3, False, True, None, 3), (300, 3, False, True, None, 4),
         (40, 8, False, False, 513, 0), (40, 1, True, False, 1025, 0))
#: the same fields, coefficients one-hot (see the module docstring)
ONE_HOT = ((258, 12, False, True, None, 5), (258, 12, False, False, None, 6))


def emulation_source(text: str) -> str:
    """A kernel source for the host: dynamic shared memory read from the
    block's buffer, inline assembly dropped, each ``kernel<<<...>>>(args)``
    an ``emu_launch(..., [&] { kernel(args); })``."""
    text = text.replace("extern __shared__ __align__(16) float smem[];",
                        "float* smem = g_smem;")
    text = text.replace("asm volatile(", "ASM_STUB(")
    return re.sub(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                  r"emu_launch(\2, [&] { \1(\3); });", text, flags=re.S)


def build(tag: str, rev: str | None) -> str:
    """Compile the emulation of the working tree's sources (rev None) or of
    revision ``rev``'s; returns the binary."""
    src = os.path.join(BUILD, tag)
    os.makedirs(src, exist_ok=True)
    for name in FILES:
        if rev is None:
            with open(os.path.join(ROOT, CSRC, name)) as fh:
                text = fh.read()
        else:
            text = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"],
                                  cwd=ROOT, check=True, capture_output=True,
                                  text=True).stdout
        with open(os.path.join(src, name), "w") as fh:
            fh.write(emulation_source(text))
    exe = os.path.join(BUILD, f"synth_mxu_{tag}")
    subprocess.run(["g++", "-x", "c++", "-std=c++20", "-O1",
                    "-ffp-contract=off", "-Wno-unknown-pragmas", "-pthread",
                    "-I", HERE, "-I", src, os.path.join(HERE, "synth_mxu.cpp"),
                    "-o", exe], check=True)
    return exe


def operands(l_max, K, fold, spin, rings, seed, one_hot=False):
    """Rows 0..l_max (spin: the 2M spin rows) with row 5 made a padding row
    (m = -1), a GL grid of ``rings`` rings (its northern half with the
    fold), seeds, and uniform coefficients zero below max(m, |m'|); with
    ``one_hot`` channel c of each row is 1 at one l >= max(m, |m'|) and 0
    elsewhere."""
    g = grids.make_grid("gl", l_max=(rings or l_max + 1) - 1)
    if spin:
        m, mp = ops.spin_rows(np.arange(l_max + 1))
        m[5] = -1
        x = g.cos_theta
        pmm, pms = kref.prepare_seeds_spin(m, mp, x, g.sin_theta, m_max=l_max)
        l0 = np.maximum(m, np.abs(mp))
    else:
        m, mp = np.insert(np.arange(l_max + 1), 5, -1), None
        nh = (g.n_rings + 1) // 2
        sin = g.sin_theta[:nh] if fold else g.sin_theta
        x = g.cos_theta[:nh] if fold else g.cos_theta
        pmm, pms = kref.prepare_seeds(m, sin, legendre.log_mu(l_max))
        l0 = m
    L = l_max + 1
    keep = (np.arange(L)[None, :] >= l0[:, None]) & (m >= 0)[:, None]
    a = np.random.default_rng(seed).uniform(-1, 1, (len(m), L, 2 * K))
    if one_hot:
        frac = np.arange(2 * K) / max(2 * K - 1, 1)
        pick = np.minimum(l0, l_max)[:, None] + np.round(
            frac[None, :] * (l_max - np.minimum(l0, l_max))[:, None])
        a = (np.arange(L)[None, :, None] == pick[:, None, :]).astype(float)
    return ((a * keep[..., None]).astype(np.float32), m.astype(np.int32),
            None if mp is None else mp.astype(np.int32),
            np.asarray(x, np.float32), np.asarray(pmm, np.float32),
            np.asarray(pms, np.int32))


def emulate(exe, a, m, mp, x, pmm, pms, fold) -> np.ndarray:
    Mp, L, K2 = a.shape
    R = x.shape[0]
    path_in = os.path.join(BUILD, "in.bin")
    path_out = os.path.join(BUILD, "out.bin")
    with open(path_in, "wb") as fh:
        np.array([Mp, L, K2, R, L, int(fold), int(mp is not None)],
                 np.int32).tofile(fh)
        for v in (a, m, np.zeros_like(m) if mp is None else mp, x, pmm, pms):
            v.tofile(fh)
    subprocess.run([exe, path_in, path_out], check=True)
    return np.fromfile(path_out, np.float32).reshape(Mp, 2 if fold else 1,
                                                     R, K2)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", metavar="REV")
    args = ap.parse_args()
    exes = {"tree": build("tree", None)}
    if args.against:
        exes["rev"] = build("rev", args.against)
    ok = True
    cases = [c + (False,) for c in CASES] + [c + (True,) for c in ONE_HOT]
    for l_max, K, fold, spin, rings, seed, one_hot in cases:
        t0 = time.time()
        a, m, mp, x, pmm, pms = operands(l_max, K, fold, spin, rings, seed,
                                         one_hot)
        outs = {k: emulate(e, a, m, mp, x, pmm, pms, fold)
                for k, e in exes.items()}
        got = outs["tree"]
        t = torch.as_tensor
        want = kref.synth_ref(t(a), t(m), t(x), t(pmm), t(pms), l_max=l_max,
                              fold=fold, mp_vals=None if mp is None
                              else t(mp)).numpy()
        gap = float(np.abs(got - want).max() / np.abs(want).max())
        pad = bool((got[m < 0] == 0).all())
        same = "" if "rev" not in outs else \
            f", bit-equal to {args.against}: {np.array_equal(got, outs['rev'])}"
        ok &= pad and np.isfinite(got).all() and (
            "rev" not in outs or np.array_equal(got, outs["rev"]))
        if one_hot:
            bits = np.array_equal(got.view(np.int32), want.view(np.int32))
            same += f", one-hot, bit-equal to the plain version: {bits}"
            ok &= bits
        print(f"l_max {l_max} K {K} fold {fold} spin {spin} R {x.shape[0]}: "
              f"max|d|/max|plain| {gap:.3e}, padding row zero {pad}{same} "
              f"({time.time() - t0:.1f} s)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
