"""Build the port's CUDA kernels into shared libraries at first use.

Each source in :data:`SOURCES` (``csrc/legendre.cu``, ``csrc/fused.cu``)
compiles with its own ``nvcc`` process into ``_build/<name>_<hash>.so``
next to this file (the directory is git-ignored); :func:`build` starts the
missing ones together.  The hash covers the source, the shared headers
``csrc/recurrence.cuh``, ``csrc/mxu_anal.cuh`` and ``csrc/mxu_synth.cuh``
and the flags, so an edited source or header rebuilds and an unchanged one
loads at once.  The libraries have a plain C
interface and are loaded with ctypes.  Needs ``nvcc`` (``$CUDA_HOME/bin``,
``/usr/local/cuda/bin`` or the PATH); nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["SOURCES", "HEADERS", "NVCC_FLAGS", "build_dir", "build", "load"]

_HERE = os.path.dirname(os.path.abspath(__file__))

SOURCES = {name: os.path.join(_HERE, "csrc", f"{name}.cu")
           for name in ("legendre", "fused")}
HEADERS = [os.path.join(_HERE, "csrc", name)
           for name in ("recurrence.cuh", "mxu_anal.cuh", "mxu_synth.cuh")]

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    return os.path.join(_HERE, "_build")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name], *HEADERS):
        with open(f, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(build_dir(), f"{name}_{digest.hexdigest()[:16]}.so")


def build(names=None) -> dict[str, tuple[str, str]]:
    """Compile the libraries of ``names`` (default: every source) that are
    missing, one ``nvcc`` per source, all started together.

    Returns ``{name: (library path, compiler output)}``, the output empty
    for a library that was already built; raises with the compiler's output
    if a build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    out, procs = {}, {}
    for name in names:
        path = _path(name)
        if os.path.exists(path):
            out[name] = (path, "")
            continue
        os.makedirs(build_dir(), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (path, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (path, tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = (path, log)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed (once
    per process)."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(build([name])[name][0])
        return _LIBS[name]
