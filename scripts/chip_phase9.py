"""Phase 9 of chip_smoke.py alone, on the card: the dense decoders'
serving path (qwen3-8b at full width and depth in bfloat16, then float32
at two layers against the CPU).

    python3 scripts/chip_phase9.py [--trace]

A short first call after touching ``repro_torch.models``; the whole smoke
runs the same phase after phases 1-8.  Builds no kernel: the model path
runs no hand-written kernel.

``--trace`` then traces one prefill (B 4 x 512) and one decode step at
B 4 of the same model with ``torch.profiler`` (CPU and CUDA activity):
wall, device-busy time (the union of the kernels' and copies' intervals)
and the device's idle share, the counts of kernel launches, host-to-device
copies and stream or device synchronisations, and the ops with the most
device time.  The tables go to ``chiprun_out/phase9_trace.txt``.
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _busy_ms(events) -> float:
    """The union of the device intervals of ``events`` (kernels, copies,
    sets), in ms."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in iv:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def trace(dev, card: str) -> str:
    """Trace one prefill and one decode step of MODEL_ARCH at full width;
    returns the report."""
    from torch.profiler import ProfilerActivity, profile

    bundle = cs.make_bundle(cs.model_registry.get(cs.MODEL_ARCH))
    cfg = bundle.cfg
    model = bundle.init(cs.MODEL_SEED)
    B, S = cs.MODEL_PREFILL
    toks = cs.model_tokens(torch.Generator(device=dev).manual_seed(1), B,
                           S + 2, cfg.vocab, dev)
    lines = [f"card: {card}", f"{cfg.name} bf16, prefill B {B} x {S}, "
             f"decode at B {B} after {S} tokens"]
    bundle.prefill_fn(model, {"tokens": toks[:, :S]},
                      bundle.init_caches(B, S + 2))
    caches = bundle.init_caches(B, S + 2)
    torch.cuda.synchronize()
    for what in ("prefill", "decode"):
        if what == "decode":     # one untraced step first
            bundle.decode_fn(model, toks[:, S:S + 1], S, caches)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if what == "prefill":
                bundle.prefill_fn(model, {"tokens": toks[:, :S]},
                                  bundle.init_caches(B, S + 2))
            else:
                bundle.decode_fn(model, toks[:, S + 1:S + 2], S + 1, caches)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        evs = prof.events()
        dev_evs = [e for e in evs
                   if str(e.device_type).endswith("CUDA")]
        names = [e.name for e in evs]
        n_kern = sum(1 for e in dev_evs if not e.name.startswith("Memcpy")
                     and not e.name.startswith("Memset"))
        n_h2d = sum(1 for e in dev_evs if "HtoD" in e.name)
        n_sync = sum(1 for n in names if n in (
            "cudaStreamSynchronize", "cudaDeviceSynchronize"))
        n_copy_api = sum(1 for n in names if n in (
            "cudaMemcpyAsync", "cudaMemcpy"))
        n_aten = sum(1 for n in names if n.startswith("aten::"))
        busy = _busy_ms(dev_evs) if dev_evs else 0.0
        lines.append("")
        lines.append(
            f"{what}: wall {wall:.3f} ms (host clock, synchronised), device "
            f"busy {busy:.3f} ms, idle share "
            f"{(1 - busy / wall) if wall else float('nan'):.3f}; "
            f"{len(dev_evs)} device activities ({n_kern} kernels, "
            f"{n_h2d} host-to-device copies), {n_copy_api} cudaMemcpy(Async) "
            f"and {n_sync} stream/device syncs from the host, {n_aten} "
            "aten:: events (nested ones included)")
        if not dev_evs:
            lines.append("  (no device activity in the trace)")
        lines.append(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=15,
            max_name_column_width=48))
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_phase9: no CUDA device is visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    with cs.stamped("phase 9"):
        cs.model_phase(torch.device("cuda"), card)
    print(f"phase 9 alone ok in {time.perf_counter() - t0:.1f} s")
    if a.trace:
        report = trace(torch.device("cuda"), card)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "phase9_trace.txt"), "w") as f:
            f.write(report + "\n")
        print("\n".join(ln for ln in report.splitlines()
                        if ln.startswith(("card", "prefill:", "decode:")))
              )
    return 0


if __name__ == "__main__":
    sys.exit(main())
