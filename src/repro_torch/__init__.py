"""repro_torch: the spherical harmonic transforms ported to PyTorch and CUDA.

The package mirrors ``repro`` (``core/``, ``kernels/``) module for module,
so each ported file has one reference file to be checked against.  The
Legendre recurrence runs in CUDA kernels written by hand for Hopper
(``kernels/csrc``), built at first use; the FFTs run on ``torch.fft``.
Plans run on the CUDA device unless ``device="cpu"`` is passed, where the
kernels' plain PyTorch versions run instead.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API: ``repro_torch.make_plan`` / ``repro_torch.Plan``."""
    if name in ("make_plan", "Plan", "available_backends",
                "backend_eligibility", "clear_plan_cache"):
        from repro_torch.core import transform
        return getattr(transform, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
