"""Build the port's CUDA Legendre kernels into a shared library at first use.

``csrc/legendre.cu`` compiles with one ``nvcc`` process into
``_build/legendre_<hash>.so`` next to this file (the directory is
git-ignored); the hash covers the source bytes and the flags, so an edited
source rebuilds and an unchanged one loads at once.  The library has a
plain C interface and is loaded with ctypes.  Needs ``nvcc``
(``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or the PATH); nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["SOURCE", "NVCC_FLAGS", "build_dir", "build", "load"]

_HERE = os.path.dirname(os.path.abspath(__file__))

SOURCE = os.path.join(_HERE, "csrc", "legendre.cu")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB: list[ctypes.CDLL] = []


def build_dir() -> str:
    return os.path.join(_HERE, "_build")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build() -> tuple[str, str]:
    """Compile the library if it is missing.

    Returns ``(library path, compiler output)``, the output empty when the
    library was already built; raises with the compiler's output if the
    build fails.
    """
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    path = os.path.join(build_dir(), f"legendre_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"CUDA build failed: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, path)
    return path, proc.stdout


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    with _LOCK:
        if not _LIB:
            _LIB.append(ctypes.CDLL(build()[0]))
        return _LIB[0]
