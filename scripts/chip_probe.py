"""A short first call on the GPU after a change to the bf16 kernels or the
bucket phase stage, ahead of the full ``chip_smoke.py``.

    python3 scripts/chip_probe.py

Builds the kernels (their ``-Xptxas -v`` logs go to ``chiprun_out/``),
holds the bfloat16 branch of kernels 10 and 12 against its bf16 plain
version at l_max 256 (K 1, 2, 3, 8; fold on and off; spin 0 and 2; random
tables and none) and prints each gap beside the bf16-vs-float32 gap; runs
HEALPix nside 64 plans on every layout on the card against the same plans
on the CPU, twice for identical bits; and times the bucket phase stage and
the fused directions at nside 1024/K8 and 2048/K1.  With
``--first-calls`` it times only the first calls on a new HEALPix grid
(plan, bucket index, first bucket FFTs) at nside 1024 and 2048.  Prints
numbers only;
the checks that pass or fail are ``chip_smoke.py``'s.
"""
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
os.chdir(ROOT)
os.makedirs("chiprun_out", exist_ok=True)

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.kernels import build, fused_cuda, ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
t0 = time.time()
res = build.build()
print("build s", time.time() - t0, flush=True)
for name, (path, log) in res.items():
    with open(f"chiprun_out/ptxas_{name}.log", "w") as fh:
        fh.write(log)
dev = torch.device("cuda")


def first_calls(nside, K):
    """Seconds of the first calls on a new HEALPix grid: the plan, its
    bucket index, the first and second bucket synthesis (K and 2K
    channels), and single first FFTs of a few of its bucket lengths."""
    t = time.time()
    p = repro_torch.make_plan("healpix", nside=nside, K=K, dtype="float32")
    t_plan = time.time() - t
    t = time.time()
    ph = p.phase
    t_index = time.time() - t
    out = [f"nside {nside} K {K}: make_plan {t_plan:.2f} s, bucket index "
           f"{t_index:.2f} s"]
    for C in (K, 2 * K):
        d = torch.zeros(p.m_max + 1, p.grid.n_rings, C, dtype=torch.complex64,
                        device=dev)
        maps = torch.zeros(p.grid.n_rings, p.grid.max_n_phi, C, device=dev)
        for what in ("first", "second"):
            for direction, fn, arg in (("synthesis", ph.synth, d),
                                       ("analysis", ph.anal, maps)):
                torch.cuda.synchronize()
                t = time.time()
                fn(arg)
                torch.cuda.synchronize()
                out.append(f"{what} bucket {direction}, {C} channels: "
                           f"{time.time() - t:.3f} s")
    for n in (4 * nside, 4 * nside - 4, 4 * nside - 12, 3 * 4 * 7 * 11):
        x = torch.zeros(3, n, 5, dtype=torch.complex64, device=dev)
        torch.cuda.synchronize()
        t = time.time()
        torch.fft.ifft(x, dim=1)
        torch.cuda.synchronize()
        out.append(f"first ifft of length {n}: {time.time() - t:.4f} s")
    print("\n  ".join(out), flush=True)


if "--first-calls" in sys.argv:
    print("cufft plan cache max size",
          torch.backends.cuda.cufft_plan_cache.max_size, flush=True)
    first_calls(1024, 8)
    first_calls(2048, 1)
    sys.exit(0)

l_max = 256
for spin in (False, True):
    gen = torch.Generator().manual_seed(3)
    m_vals, mp_vals, lo = cs.test_layout(l_max, spin)
    for fold in ((False,) if spin else (False, True)):
        _, x, pmm, pms = cs.seeds_for(l_max, m_vals, fold, dev, mp_vals)
        maps, x, pmm_pk, pms_pk = ops._prep(lo, x, pmm, pms)
        R, P = x.shape[0], (2 if fold else 1)
        for K in (1, 2, 3, 8):
            K2 = 2 * K
            a_pk = ops._pack_a(cs.random_a(gen, m_vals, l_max + 1, K2, dev, mp_vals), lo).contiguous()
            f = (torch.rand((lo.n_slots, 2, P, R, K2), generator=gen) * 2 - 1).to(dev)
            tab = (torch.rand((lo.n_slots, 2, P, 4, R), generator=gen) * 2 - 1).to(dev)
            for t in (tab, None):
                ws = kref.synth_fused_ref(a_pk, maps, x, pmm_pk, pms_pk, t, l_max=l_max, fold=fold, spin=spin, bf16=True)
                wa = kref.anal_fused_ref(f, maps, x, pmm_pk, pms_pk, t, l_max=l_max, s_len=lo.S, spin=spin, bf16=True)
                w32 = kref.synth_fused_ref(a_pk, maps, x, pmm_pk, pms_pk, t, l_max=l_max, fold=fold, spin=spin)
                gs = fused_cuda.synth_fused_mxu(a_pk, maps, x, pmm_pk, pms_pk, t, l_max=l_max, fold=fold, spin=spin, bf16=True)
                ga = fused_cuda.anal_fused_mxu(f, maps, x, pmm_pk, pms_pk, t, l_max=l_max, s_len=lo.S, spin=spin, bf16=True)
                torch.cuda.synchronize()
                es = float((gs - ws).abs().max() / ws.abs().max()); ea = float((ga - wa).abs().max() / wa.abs().max())
                e32 = float((ws - w32).abs().max() / w32.abs().max())
                print(f"spin={spin} fold={fold} K={K} tab={t is not None}: synth {es:.3e} anal {ea:.3e} (bf16 vs f32 plain {e32:.3e})", flush=True)
print(fused_cuda.launches)
# bucket path at nside 64
for spin in (0, 2):
    for lay in ("fused", "plain", "packed"):
        p = repro_torch.make_plan("healpix", nside=64, K=4, dtype="float32", spin=spin, layout=lay)
        pc = repro_torch.make_plan("healpix", nside=64, K=4, dtype="float32", spin=spin, layout=lay, device="cpu")
        rng = np.random.default_rng(0); shp = p._alm_shape
        a = rng.normal(size=shp) + 1j * rng.normal(size=shp)
        mask = np.arange(p.l_max + 1)[None, :] >= np.maximum(np.arange(p.m_max + 1), spin)[:, None]
        a = (a * mask[..., None]).astype(np.complex64)
        m1 = p.alm2map(torch.as_tensor(a, device=dev)); m2 = p.alm2map(torch.as_tensor(a, device=dev))
        mc = pc.alm2map(torch.as_tensor(a))
        b1 = p.map2alm(m1); bc = pc.map2alm(mc)
        torch.cuda.synchronize()
        print(f"healpix 64 spin {spin} {lay}: rerun equal {torch.equal(m1, m2)}, vs cpu plain synth {float((m1.cpu()-mc).abs().max()/mc.abs().max()):.3e} anal {float((b1.cpu()-bc).abs().max()/bc.abs().max()):.3e}", flush=True)
# bucket phase timing at full width
for nside, K in ((1024, 8), (2048, 1)):
    t = time.time()
    p = repro_torch.make_plan("healpix", nside=nside, K=K, dtype="float32")
    ph = p.phase
    print("plan + phase build s", time.time() - t, flush=True)
    d = torch.randn(p.m_max + 1, p.grid.n_rings, K, dtype=torch.complex64, device=dev)
    mp = ph.synth(d)
    print(f"nside {nside} K {K}: bucket synth ms {cs.cuda_time_ms(lambda: ph.synth(d)):.2f} host {cs.host_ms(lambda: ph.synth(d)):.2f}; anal ms {cs.cuda_time_ms(lambda: ph.anal(mp)):.2f} host {cs.host_ms(lambda: ph.anal(mp)):.2f}", flush=True)
    a = torch.randn(p._alm_shape, dtype=torch.complex64, device=dev)
    t = time.time(); m = p.alm2map(a); torch.cuda.synchronize(); print("first alm2map s", time.time() - t, flush=True)
    print(f"  fused alm2map host ms {cs.host_ms(lambda: p.alm2map(a)):.2f} map2alm {cs.host_ms(lambda: p.map2alm(m)):.2f}", flush=True)
    print(torch.cuda.max_memory_allocated() / 1e9, "GB peak", flush=True)
print("total s", time.time() - t0)
