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

``mp_vals`` (Mp,) i32, m' per row, launches each kernel's spin branch (the
Wigner-d rows of the spin-2 plans, seeded at l0 = max(m, |m'|) from
``ref.prepare_seeds_spin``; fold off only), counted under the kernel's name
with ``_spin`` appended; ``anal_reduce`` then zeroes l < l0.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["synth_vpu", "synth_mxu", "anal_vpu", "anal_mxu", "anal_partials",
           "anal_reduce", "partials_shape", "launches", "reset_launches",
           "ANAL_CHUNK"]

#: kernel name -> launches since the last :func:`reset_launches`; the spin
#: branch of a kernel counts under its name with ``_spin`` appended
launches = {f"{k}{b}": 0 for k in ("synth_vpu", "synth_mxu", "anal_vpu",
                                   "anal_mxu") for b in ("", "_spin")}
launches["anal_reduce"] = 0

#: rings per partial-sum chunk of each analysis kernel; the C launchers
#: refuse a partials buffer sized otherwise (``legendre.cu``: kTile times
#: kVpuAnalTiles / kMxuAnalTiles)
ANAL_CHUNK = {"vpu": 1024, "mxu": 512}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "legendre_synth_vpu": [_P] * 7 + [_I] * 6 + [_P],
    "legendre_synth_mxu": [_P] * 7 + [_I] * 6 + [_P],
    "legendre_anal_vpu": [_P] * 7 + [_I] * 6 + [_P],
    "legendre_anal_mxu": [_P] * 7 + [_I] * 6 + [_P],
    "legendre_anal_reduce": [_P] * 7 + [_I] * 5 + [_P],
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
    if (t.is_cuda and t.dtype == dtype and t.shape == tuple(shape)
            and t.is_contiguous()):
        return
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_seeds(m_vals, x, pmm, pms, Mp, R, device, mp_vals=None):
    _check("m_vals", m_vals, torch.int32, (Mp,))
    _check("x", x, torch.float32, (R,))
    _check("pmm", pmm, torch.float32, (Mp, R))
    _check("pms", pms, torch.int32, (Mp, R))
    if mp_vals is not None:
        _check("mp_vals", mp_vals, torch.int32, (Mp,))
    for t in (m_vals, mp_vals, x, pmm, pms):
        if t is not None and t.device != device:
            raise ValueError(f"operands on {t.device} and {device}")


def _branch(kernel: str, mp_vals, fold: bool) -> str:
    """The counter and error name of ``kernel``'s branch for ``mp_vals``;
    the spin branch runs with the fold off only."""
    if mp_vals is None:
        return kernel
    if fold:
        raise ValueError(f"{kernel}: the spin branch (mp_vals) runs with "
                         "the fold off; fold is not supported for spin "
                         "transforms")
    return f"{kernel}_spin"


def _ptr(t) -> int:
    """A tensor's device pointer, or 0 (null) for None."""
    return 0 if t is None else t.data_ptr()


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")


_CURRENT = contextlib.nullcontext()


def _guard(t: torch.Tensor):
    """A guard that makes ``t``'s device current for a launch, or none where
    it already is (entering ``torch.cuda.device`` costs host time on every
    call)."""
    i = t.device.index
    if i is not None and i == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(t.device)


def _stream() -> int:
    """The current device's current stream as a raw handle, without the
    ``torch.cuda.Stream`` object ``current_stream()`` builds."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def _synth(kernel, a, m_vals, x, pmm, pms, *, l_max, fold, mp_vals):
    Mp, L1, K2 = a.shape
    R = x.shape[0]
    name = _branch(kernel, mp_vals, fold)
    _check("a", a, torch.float32, (Mp, L1, K2))
    _check_seeds(m_vals, x, pmm, pms, Mp, R, a.device, mp_vals)
    P = 2 if fold else 1
    out = torch.empty((Mp, P, R, K2), dtype=torch.float32, device=a.device)
    fn = getattr(_lib(), f"legendre_{kernel}")
    with _guard(a):
        err = fn(a.data_ptr(), m_vals.data_ptr(), _ptr(mp_vals),
                 x.data_ptr(), pmm.data_ptr(), pms.data_ptr(),
                 out.data_ptr(), Mp, L1, K2, R, min(l_max + 1, L1),
                 int(fold), _stream())
    _raise_on(err, name)
    launches[name] += 1
    return out


def synth_vpu(a, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False,
              mp_vals=None):
    """Synthesis, one ring per thread (paper Alg. 4)."""
    return _synth("synth_vpu", a, m_vals, x, pmm, pms, l_max=l_max, fold=fold,
                  mp_vals=mp_vals)


def synth_mxu(a, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False,
              mp_vals=None):
    """Synthesis on the mxu synthesis template (``csrc/mxu_synth.cuh``): a
    ring pair a thread, its values times each l's coefficient row summed in
    float32 registers."""
    return _synth("synth_mxu", a, m_vals, x, pmm, pms, l_max=l_max, fold=fold,
                  mp_vals=mp_vals)


def partials_shape(variant: str, Mp: int, R: int, l_max: int,
                   K2: int) -> tuple:
    """(Mp, n_chunks, l_max + 1, 2K): the float32 partials buffer of
    ``anal_<variant>`` on R rings (ring chunks of ``ANAL_CHUNK``)."""
    return (Mp, -(-R // ANAL_CHUNK[variant]), l_max + 1, K2)


def anal_partials(variant: str, dw, m_vals, x, pmm, pms, *, l_max: int,
                  fold: bool = False, mp_vals=None):
    """First analysis pass of ``anal_<variant>``: per-ring-chunk partial
    sums (Mp, n_chunks, l_max+1, 2K); rows l < l0 (m, or max(m, |m'|) with
    ``mp_vals``) are left unwritten."""
    kernel = f"anal_{variant}"
    name = _branch(kernel, mp_vals, fold)
    Mp, P, R, K2 = dw.shape
    if P != (2 if fold else 1):
        raise ValueError(f"dw has {P} parity planes, fold={fold}")
    _check("dw", dw, torch.float32, (Mp, P, R, K2))
    _check_seeds(m_vals, x, pmm, pms, Mp, R, dw.device, mp_vals)
    L = l_max + 1
    part = torch.empty(partials_shape(variant, Mp, R, l_max, K2),
                       dtype=torch.float32, device=dw.device)
    n_chunks = part.shape[1]
    fn = getattr(_lib(), f"legendre_{kernel}")
    with _guard(dw):
        err = fn(dw.data_ptr(), m_vals.data_ptr(), _ptr(mp_vals),
                 x.data_ptr(), pmm.data_ptr(), pms.data_ptr(),
                 part.data_ptr(), Mp, K2, R, L, n_chunks, int(fold),
                 _stream())
    _raise_on(err, name)
    launches[name] += 1
    return part


def anal_vpu(dw, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False,
             mp_vals=None):
    """Analysis, rings reduced in registers, warps and a fixed-order pass
    (paper Alg. 5)."""
    part = anal_partials("vpu", dw, m_vals, x, pmm, pms, l_max=l_max,
                         fold=fold, mp_vals=mp_vals)
    return anal_reduce(part, m_vals, l_max=l_max, mp_vals=mp_vals)


def anal_mxu(dw, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False,
             mp_vals=None):
    """Analysis as (l x ring) P panels contracted against resident dw."""
    part = anal_partials("mxu", dw, m_vals, x, pmm, pms, l_max=l_max,
                         fold=fold, mp_vals=mp_vals)
    return anal_reduce(part, m_vals, l_max=l_max, mp_vals=mp_vals)


def anal_reduce(partials, m_vals, *, l_max: int, mp_vals=None,
                slot_maps=None):
    """Second analysis pass: per-ring-chunk partials summed over chunks in
    chunk order.  Plain rows: (Mp, n_chunks, l_max+1, 2K) with ``m_vals``
    (and ``mp_vals``) -> (Mp, l_max+1, 2K); rows l < m (l < max(m, |m'|)
    with ``mp_vals``) and padding rows are exact zeros.  Slot streams:
    ``m_vals`` None and ``slot_maps`` the five per-slot maps of a slot
    layout (m0, m1, mp0, mp1, seed; mp0, mp1 None for spin 0) of band limit
    ``l_max``: (n_slots, n_chunks, S, 2K) -> (n_slots, S, 2K), each slot's
    dead tail (past both segments; zeros in the partials) written as zeros
    without being read."""
    Mp, n_chunks, L, K2 = partials.shape
    if (m_vals is None) == (slot_maps is None):
        raise ValueError("anal_reduce takes m_vals (plain rows) or "
                         "slot_maps (slot streams)")
    if m_vals is not None and L != l_max + 1:
        raise ValueError(f"partials hold {L} rows, l_max + 1 = {l_max + 1}")
    _check("partials", partials, torch.float32, (Mp, n_chunks, L, K2))
    if slot_maps is not None:
        if mp_vals is not None:
            raise ValueError("the slot streams' m' are in slot_maps")
        m_vals, m1, mp_vals, mp1, seed = slot_maps
    else:
        m1 = mp1 = seed = None
    for name, t in (("m_vals", m_vals), ("mp_vals", mp_vals), ("m1", m1),
                    ("mp1", mp1), ("seed", seed)):
        if t is not None:
            _check(name, t, torch.int32, (Mp,))
    out = torch.empty((Mp, L, K2), dtype=torch.float32,
                      device=partials.device)
    with _guard(partials):
        err = _lib().legendre_anal_reduce(
            partials.data_ptr(), m_vals.data_ptr(), _ptr(mp_vals), _ptr(m1),
            _ptr(mp1), _ptr(seed), out.data_ptr(), Mp, n_chunks, L, K2,
            l_max, _stream())
    _raise_on(err, "anal_reduce")
    launches["anal_reduce"] += 1
    return out
