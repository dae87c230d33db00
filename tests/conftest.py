# NOTE: deliberately NO --xla_force_host_platform_device_count here --
# smoke tests and benches must see 1 device (the dry-run sets its own flags
# as the first lines of repro.launch.dryrun).  Multi-device tests spawn
# subprocesses (see tests/helpers/).
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# tests/ itself, for the _hypothesis_compat shim (real hypothesis when
# installed, deterministic fallback runner otherwise)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one (run on "
        "the GPU with `python -m pytest -m cuda tests/test_torch_cuda.py`)")
