"""Python wrappers of the CUDA Legendre kernels (``csrc/legendre.cu``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on the current CUDA
stream, raises if the launch reports an error, and adds one to its entry
of :data:`launches` per kernel launch.  They take CUDA tensors only: the
plain versions for CPU tensors are in ``kernels.ref``, and the choice
between the two is made in ``kernels.ops``.

Layouts (the unpadded ``ops`` seam):
  synth_*: a (Mp, L1, 2K) f32, m_vals (Mp,) i32, x (R,) f32,
           pmm (Mp, R) f32, pms (Mp, R) i32 -> Delta (Mp, P, R, 2K) f32;
  anal_*:  dw (Mp, P, R, 2K) f32 (same seeds) -> (Mp, l_max+1, 2K) f32,
           through per-ring-chunk partials and the ``anal_reduce`` pass.
P is 2 (even, odd (l+m) planes) when ``fold`` else 1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["synth_vpu", "synth_mxu", "anal_vpu", "anal_mxu", "anal_partials",
           "anal_reduce", "launches", "reset_launches", "ANAL_CHUNK"]

#: kernel name -> launches since the last :func:`reset_launches`
launches = {"synth_vpu": 0, "synth_mxu": 0, "anal_vpu": 0, "anal_mxu": 0,
            "anal_reduce": 0}

#: rings per partial-sum chunk of each analysis kernel; the C launchers
#: refuse a partials buffer sized otherwise (``legendre.cu``: kTile times
#: kVpuAnalTiles / kMxuAnalTiles)
ANAL_CHUNK = {"vpu": 1024, "mxu": 512}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "legendre_synth_vpu": [_P] * 6 + [_I] * 6 + [_P],
    "legendre_synth_mxu": [_P] * 6 + [_I] * 6 + [_P],
    "legendre_anal_vpu": [_P] * 6 + [_I] * 6 + [_P],
    "legendre_anal_mxu": [_P] * 6 + [_I] * 6 + [_P],
    "legendre_anal_reduce": [_P] * 3 + [_I] * 4 + [_P],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    lib = build.load("legendre")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_seeds(m_vals, x, pmm, pms, Mp, R, device):
    _check("m_vals", m_vals, torch.int32, (Mp,))
    _check("x", x, torch.float32, (R,))
    _check("pmm", pmm, torch.float32, (Mp, R))
    _check("pms", pms, torch.int32, (Mp, R))
    for t in (m_vals, x, pmm, pms):
        if t.device != device:
            raise ValueError(f"operands on {t.device} and {device}")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _synth(kernel, a, m_vals, x, pmm, pms, *, l_max, fold):
    Mp, L1, K2 = a.shape
    R = x.shape[0]
    _check("a", a, torch.float32, (Mp, L1, K2))
    _check_seeds(m_vals, x, pmm, pms, Mp, R, a.device)
    P = 2 if fold else 1
    out = torch.empty((Mp, P, R, K2), dtype=torch.float32, device=a.device)
    fn = getattr(_lib(), f"legendre_{kernel}")
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), m_vals.data_ptr(), x.data_ptr(),
                 pmm.data_ptr(), pms.data_ptr(), out.data_ptr(), Mp, L1, K2,
                 R, min(l_max + 1, L1), int(fold), _stream())
    _raise_on(err, kernel)
    launches[kernel] += 1
    return out


def synth_vpu(a, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False):
    """Synthesis, one ring per thread (paper Alg. 4)."""
    return _synth("synth_vpu", a, m_vals, x, pmm, pms, l_max=l_max, fold=fold)


def synth_mxu(a, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False):
    """Synthesis as (l x ring) P panels contracted in float32."""
    return _synth("synth_mxu", a, m_vals, x, pmm, pms, l_max=l_max, fold=fold)


def anal_partials(variant: str, dw, m_vals, x, pmm, pms, *, l_max: int,
                  fold: bool = False):
    """First analysis pass of ``anal_<variant>``: per-ring-chunk partial
    sums (Mp, n_chunks, l_max+1, 2K); rows l < m are left unwritten."""
    kernel = f"anal_{variant}"
    Mp, P, R, K2 = dw.shape
    if P != (2 if fold else 1):
        raise ValueError(f"dw has {P} parity planes, fold={fold}")
    _check("dw", dw, torch.float32, (Mp, P, R, K2))
    _check_seeds(m_vals, x, pmm, pms, Mp, R, dw.device)
    L = l_max + 1
    n_chunks = -(-R // ANAL_CHUNK[variant])
    part = torch.empty((Mp, n_chunks, L, K2), dtype=torch.float32,
                       device=dw.device)
    fn = getattr(_lib(), f"legendre_{kernel}")
    with torch.cuda.device(dw.device):
        err = fn(dw.data_ptr(), m_vals.data_ptr(), x.data_ptr(),
                 pmm.data_ptr(), pms.data_ptr(), part.data_ptr(), Mp, K2, R,
                 L, n_chunks, int(fold), _stream())
    _raise_on(err, kernel)
    launches[kernel] += 1
    return part


def anal_vpu(dw, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False):
    """Analysis, rings reduced in registers, warps and a fixed-order pass
    (paper Alg. 5)."""
    part = anal_partials("vpu", dw, m_vals, x, pmm, pms, l_max=l_max,
                         fold=fold)
    return anal_reduce(part, m_vals, l_max=l_max)


def anal_mxu(dw, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False):
    """Analysis as (l x ring) P panels contracted against resident dw."""
    part = anal_partials("mxu", dw, m_vals, x, pmm, pms, l_max=l_max,
                         fold=fold)
    return anal_reduce(part, m_vals, l_max=l_max)


def anal_reduce(partials, m_vals, *, l_max: int):
    """Second analysis pass: (Mp, n_chunks, l_max+1, 2K) partials summed
    over chunks in chunk order -> (Mp, l_max+1, 2K); rows l < m and padding
    rows are zero."""
    Mp, n_chunks, L, K2 = partials.shape
    if L != l_max + 1:
        raise ValueError(f"partials hold {L} rows, l_max + 1 = {l_max + 1}")
    _check("partials", partials, torch.float32, (Mp, n_chunks, L, K2))
    _check("m_vals", m_vals, torch.int32, (Mp,))
    out = torch.empty((Mp, L, K2), dtype=torch.float32,
                      device=partials.device)
    with torch.cuda.device(partials.device):
        err = _lib().legendre_anal_reduce(
            partials.data_ptr(), m_vals.data_ptr(), out.data_ptr(), Mp,
            n_chunks, L, K2, _stream())
    _raise_on(err, "anal_reduce")
    launches["anal_reduce"] += 1
    return out
