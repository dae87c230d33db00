"""Phase 8 of chip_smoke.py alone, on the card: build the kernels, then
the distributed transform's checks (NCCL at world size 1, GL 2048/K8).

    python3 scripts/chip_phase8.py

A short first call after touching the distributed path; the whole smoke
runs the same phase after phases 1-7.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phase8: no CUDA device is visible", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.count_plain_seconds()
    with cs.stamped("phase 1"):
        cs.build.build()
    with cs.stamped("phase 8"):
        cs.dist_phase(torch.device("cuda"))
    print(f"phase 8 alone ok in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
