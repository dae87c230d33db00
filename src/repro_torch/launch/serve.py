"""Serving CLI: the SHT request-coalescing engine under synthetic load.

Counterpart of ``repro.launch.serve``::

    PYTHONPATH=src python -m repro_torch.launch.serve --lmax 2048 --max-k 8 \\
        --requests 8 --mode cuda_mxu          # on the CUDA device
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Runs the double-buffered serving threads (batch i+1 stages while batch i
computes), submits a mixed spin-0/spin-2 request stream (even request ids
spin 0, odd ids spin 2, on the GL grid at ``--lmax``), waits for every
future, and prints the stats table (p50/p95/p99 latency, coalescing
factor, admission caps, plan-pool hit rate) and ``completed N/N
requests``.  ``--p99-target-ms`` turns on roofline admission control: the
coalesced K per signature is capped by the latency target instead of
``--max-k`` alone.  The alm are drawn with numpy from ``--seed``.  The
engine serves on the CUDA device unless ``--device cpu`` is given; without
a visible card it exits with an error and serves nothing.
"""

import argparse

import numpy as np

from repro_torch.serve import ShtEngine


def random_alm(rng: np.random.Generator, l_max: int, spin: int,
               dtype=np.float64) -> np.ndarray:
    """One request's alm, (M, L) complex, or the (E, B) pair (2, M, L) for
    spin 2: real and imaginary parts uniform in [-1, 1), drawn in
    ``dtype`` (float64 or float32), m = 0 real, zero where l < max(m,
    spin)."""
    shape = (l_max + 1, l_max + 1)
    cdtype = np.result_type(dtype, np.complex64)

    def one():
        a = np.empty(shape, cdtype)
        a.real = rng.random(shape, dtype) * 2 - 1
        a.imag = rng.random(shape, dtype) * 2 - 1
        a.imag[0] = 0.0
        for m in range(l_max + 1):
            a[m, :max(m, spin)] = 0.0
        return a
    return one() if spin == 0 else np.stack([one(), one()])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lmax", type=int, default=32)
    ap.add_argument("--max-k", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--mode", default="torch",
                    help="plan dispatch mode for pooled plans "
                         "(torch | auto | model | cuda_vpu | cuda_mxu)")
    ap.add_argument("--p99-target-ms", type=float, default=None,
                    help="roofline admission: cap each group's coalesced "
                         "K to fit this tail-latency target")
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: the CUDA device)")
    ap.add_argument("--seed", type=int, default=0,
                    help="numpy seed of the request payloads")
    ap.add_argument("--smoke", action="store_true")
    a = ap.parse_args()
    if a.smoke:
        a.lmax = min(a.lmax, 16)

    target_s = None if a.p99_target_ms is None else a.p99_target_ms * 1e-3
    try:
        eng = ShtEngine(max_k=a.max_k, mode=a.mode, warm_after=2,
                        p99_target_s=target_s, device=a.device)
    except RuntimeError as e:          # no CUDA device visible
        raise SystemExit(f"repro_torch.launch.serve: {e}") from None
    rng = np.random.default_rng(a.seed)
    with eng:                          # double-buffered form/exec threads
        futs = []
        for rid in range(a.requests):
            spin = 0 if rid % 2 == 0 else 2
            futs.append(eng.submit(direction="alm2map",
                                   payload=random_alm(rng, a.lmax, spin),
                                   grid="gl", l_max=a.lmax, spin=spin))
        results = [f.result(timeout=600) for f in futs]
    bad = [i for i, r in enumerate(results) if not np.isfinite(r).all()]
    if bad:
        raise SystemExit(f"repro_torch.launch.serve: non-finite results for "
                         f"requests {bad}")
    print(eng.report())
    done = eng.stats()["requests"]["completed"]
    print(f"completed {done}/{a.requests} requests")


if __name__ == "__main__":
    main()
