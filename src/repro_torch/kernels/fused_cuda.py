"""Python wrappers of the slot kernels (``csrc/fused.cu``): the fused
Legendre+phase kernels and the packed staged Legendre kernels.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output and scratch with ``torch.empty``, launches on the current CUDA
stream, raises if the launch reports an error, and adds one to its entry of
:data:`launches` per kernel launch.  They take CUDA tensors only: the plain
versions for CPU tensors are ``kernels.ref.synth_fused_ref`` /
``anal_fused_ref`` / ``synth_packed_ref`` / ``anal_packed_ref``, and
``kernels.fused`` and ``kernels.ops`` choose between the two.

Operands, on a ``kernels.pack`` slot layout (n_slots slots, stream length
S, P = 2 planes with the equator fold, else 1, Q = 2 x P):
  maps   the five per-slot i32 (n_slots,) maps of ``ops._pack_maps``
         (m0, m1, mp0, mp1, seed); mp0/mp1 are read by the spin branch
         only;
  x (R,) f32; pmm_pk / pms_pk (n_slots, 2, R) f32 / i32 segment seeds;
  tab_pk (n_slots, 2, P, 4, R) f32 rotation tables, or None (identity).
  synth_fused_vpu:  a_pk (n_slots, S, 2K) -> (n_slots, 2, P, 2K, R);
  synth_fused_mxu:  a_pk (n_slots, S, 2K) -> (n_slots, 2, P, R, 2K);
  anal_fused_vpu:   f_pk (n_slots, 2, P, 2K, R) -> (n_slots, S, 2K);
  anal_fused_mxu:   f_pk (n_slots, 2, P, R, 2K) -> (n_slots, S, 2K);
  synth_packed_vpu: a_pk (n_slots, S, 2K) -> (n_slots, Q, 2K, R);
  synth_packed_mxu: a_pk (n_slots, S, 2K) -> (n_slots, Q, R, 2K);
  anal_packed_vpu:  dw_pk (n_slots, Q, 2K, R) -> (n_slots, S, 2K);
  anal_packed_mxu:  dw_pk (n_slots, Q, R, 2K) -> (n_slots, S, 2K).
The fused planes are north/south (combined in the kernel), the packed ones
even/odd (l+m), plane q = segment x P + parity, and take no tables.
Analysis writes per-ring-chunk partials and sums them in chunk order with
``legendre_cuda.anal_reduce``'s slot route (:func:`slot_maps`).

``spin=True`` launches each kernel's spin branch on a spin slot layout (the
Wigner-d rows (m, m') of the spin-2 plans, each segment starting at
l0 = max(m, |m'|); fold off only), counted under the kernel's name with
``_spin`` appended.  ``bf16=True`` on the fused mxu kernels launches their
bfloat16 instantiation (tensor-core contraction of bfloat16-rounded panels,
float32 accumulation), counted as ``<kernel>_bf16`` (``_bf16_spin``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import legendre_cuda as lc
from repro_torch.kernels.ops import _pad_to

__all__ = ["synth_fused_vpu", "synth_fused_mxu", "anal_fused_vpu",
           "anal_fused_mxu", "anal_fused_partials", "synth_packed_vpu",
           "synth_packed_mxu", "anal_packed_vpu", "anal_packed_mxu",
           "anal_packed_partials", "slot_maps", "partials_shape",
           "launches", "reset_launches"]

#: kernel name -> launches since the last :func:`reset_launches`; the spin
#: branch of a kernel counts under its name with ``_spin`` appended
launches = {f"{d}_{kind}_{v}{b}": 0 for d in ("synth", "anal")
            for kind in ("fused", "packed") for v in ("vpu", "mxu")
            for b in ("", "_spin")}
launches.update({f"{d}_fused_mxu_bf16{b}": 0 for d in ("synth", "anal")
                 for b in ("", "_spin")})

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fused_synth_vpu": [_P] * 11 + [_I] * 6 + [_P],
    "fused_synth_mxu": [_P] * 11 + [_I] * 6 + [_P],
    "fused_anal_vpu": [_P] * 11 + [_I] * 7 + [_P],
    "fused_anal_mxu": [_P] * 11 + [_I] * 7 + [_P],
    "fused_synth_mxu_bf16": [_P] * 11 + [_I] * 6 + [_P],
    "fused_anal_mxu_bf16": [_P] * 11 + [_I] * 7 + [_P],
    "packed_synth_vpu": [_P] * 10 + [_I] * 6 + [_P],
    "packed_synth_mxu": [_P] * 10 + [_I] * 6 + [_P],
    "packed_anal_vpu": [_P] * 10 + [_I] * 7 + [_P],
    "packed_anal_mxu": [_P] * 10 + [_I] * 7 + [_P],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    lib = build.load("fused")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _operands(maps, x, pmm_pk, pms_pk, tab_pk, n_slots, P, device, spin):
    """Check the shared operands; returns the pointers of (m0, m1, mp0, mp1,
    seed, x, pmm_pk, pms_pk), mp0/mp1 null unless ``spin``, and the
    table's (0 for None)."""
    m0, m1, mp0, mp1, seed = maps
    R = x.shape[0]
    if spin and P != 1:
        raise ValueError("the spin branch runs with the fold off; fold is "
                         "not supported for spin transforms")
    for name, t in (("m0", m0), ("m1", m1), ("mp0", mp0), ("mp1", mp1),
                    ("seed", seed)):
        lc._check(name, t, torch.int32, (n_slots,))
    lc._check("x", x, torch.float32, (R,))
    lc._check("pmm_pk", pmm_pk, torch.float32, (n_slots, 2, R))
    lc._check("pms_pk", pms_pk, torch.int32, (n_slots, 2, R))
    if tab_pk is not None:
        lc._check("tab_pk", tab_pk, torch.float32, (n_slots, 2, P, 4, R))
    ts = (m0, m1, mp0, mp1, seed, x, pmm_pk, pms_pk)
    for t in ts + (() if tab_pk is None else (tab_pk,)):
        if t.device != device:
            raise ValueError(f"operands on {t.device} and {device}")
    ptrs = [t.data_ptr() for t in ts]
    if not spin:
        ptrs[2] = ptrs[3] = 0
    return ptrs, (0 if tab_pk is None else tab_pk.data_ptr())


def _synth(kernel, a_pk, maps, x, pmm_pk, pms_pk, tab_pk, *, l_max, fold,
           spin, bf16=False):
    """Launch synthesis ``kernel`` (``synth_{fused,packed}_{vpu,mxu}``); the
    packed ones take no table and return their planes as (n_slots, Q,
    ...)."""
    n_slots, S, K2 = a_pk.shape
    R, P = x.shape[0], (2 if fold else 1)
    _, kind, var = kernel.split("_")
    bf = "_bf16" if bf16 else ""
    name = kernel + bf + ("_spin" if spin else "")
    lc._check("a_pk", a_pk, torch.float32, (n_slots, S, K2))
    ptrs, tab = _operands(maps, x, pmm_pk, pms_pk, tab_pk, n_slots, P,
                          a_pk.device, spin)
    shape = ((n_slots, 2, P, K2, R) if var == "vpu"
             else (n_slots, 2, P, R, K2))
    out = torch.empty(shape, dtype=torch.float32, device=a_pk.device)
    fn = getattr(_lib(), f"{kind}_synth_{var}{bf}")
    tab = [tab] if kind == "fused" else []
    with lc._guard(a_pk):
        err = fn(a_pk.data_ptr(), *ptrs, *tab, out.data_ptr(), n_slots, S,
                 K2 // 2, R, l_max, int(fold), lc._stream())
    lc._raise_on(err, name)
    launches[name] += 1
    return out if kind == "fused" else out.reshape(n_slots, 2 * P,
                                                   *shape[3:])


def synth_fused_vpu(a_pk, maps, x, pmm_pk, pms_pk, tab_pk=None, *,
                    l_max: int, fold: bool = False, spin: bool = False):
    """Fused synthesis, one ring per thread."""
    return _synth("synth_fused_vpu", a_pk, maps, x, pmm_pk, pms_pk, tab_pk,
                  l_max=l_max, fold=fold, spin=spin)


def synth_fused_mxu(a_pk, maps, x, pmm_pk, pms_pk, tab_pk=None, *,
                    l_max: int, fold: bool = False, spin: bool = False,
                    bf16: bool = False):
    """Fused synthesis as (l x ring) P panels contracted in float32, or with
    ``bf16`` in bfloat16 on the tensor cores (float32 accumulation)."""
    return _synth("synth_fused_mxu", a_pk, maps, x, pmm_pk, pms_pk, tab_pk,
                  l_max=l_max, fold=fold, spin=spin, bf16=bf16)


def synth_packed_vpu(a_pk, maps, x, pmm_pk, pms_pk, *, l_max: int,
                     fold: bool = False, spin: bool = False):
    """Packed synthesis, one ring per thread: the fused vpu kernel without
    the fold combine and the rotation."""
    return _synth("synth_packed_vpu", a_pk, maps, x, pmm_pk, pms_pk, None,
                  l_max=l_max, fold=fold, spin=spin)


def synth_packed_mxu(a_pk, maps, x, pmm_pk, pms_pk, *, l_max: int,
                     fold: bool = False, spin: bool = False):
    """Packed synthesis as (l x ring) P panels: the fused mxu kernel without
    the fold combine and the rotation."""
    return _synth("synth_packed_mxu", a_pk, maps, x, pmm_pk, pms_pk, None,
                  l_max=l_max, fold=fold, spin=spin)


def partials_shape(variant: str, n_slots: int, R: int, s_len: int,
                   K2: int) -> tuple:
    """(n_slots, n_chunks, S, 2K): the float32 partials buffer of the slot
    analysis kernels of ``variant`` on R rings (ring chunks of
    ``legendre_cuda.ANAL_CHUNK``)."""
    chunk = lc.ANAL_CHUNK[variant]
    return (n_slots, _pad_to(R, chunk) // chunk, s_len, K2)


def _partials(kernel, f, maps, x, pmm_pk, pms_pk, tab_pk, *, l_max, s_len,
              spin, bf16=False):
    """Launch analysis ``kernel`` (``anal_{fused,packed}_{vpu,mxu}``) on its
    per-slot rows ``f`` (n_slots, 2 x P, ...): per-ring-chunk partial sums
    (n_slots, n_chunks, S, 2K), dead stream positions zero."""
    _, kind, var = kernel.split("_")
    rows = f.reshape(f.shape[0], -1, *f.shape[-2:])
    if var == "vpu":
        n_slots, Q, K2, R = rows.shape
    else:
        n_slots, Q, R, K2 = rows.shape
    lc._check("rows", f, torch.float32, f.shape)
    if R != x.shape[0] or Q not in (2, 4):
        raise ValueError(f"rows {tuple(f.shape)} do not fit x "
                         f"({x.shape[0]} rings) and 1 or 2 planes")
    P = Q // 2
    bf = "_bf16" if bf16 else ""
    name = kernel + bf + ("_spin" if spin else "")
    ptrs, tab = _operands(maps, x, pmm_pk, pms_pk, tab_pk, n_slots, P,
                          f.device, spin)
    part = torch.empty(partials_shape(var, n_slots, R, s_len, K2),
                       dtype=torch.float32, device=f.device)
    n_chunks = part.shape[1]
    fn = getattr(_lib(), f"{kind}_anal_{var}{bf}")
    tab = [tab] if kind == "fused" else []
    with lc._guard(f):
        err = fn(f.data_ptr(), *ptrs, *tab, part.data_ptr(), n_slots, s_len,
                 K2 // 2, R, l_max, n_chunks, int(P == 2), lc._stream())
    lc._raise_on(err, name)
    launches[name] += 1
    return part


def anal_fused_partials(variant: str, f_pk, maps, x, pmm_pk, pms_pk,
                        tab_pk=None, *, l_max: int, s_len: int,
                        spin: bool = False, bf16: bool = False):
    """First pass of ``anal_fused_<variant>``: per-ring-chunk partial sums
    (n_slots, n_chunks, S, 2K), dead stream positions zero; ``bf16`` (mxu
    only) launches the bfloat16 instantiation."""
    if bf16 and variant != "mxu":
        raise ValueError("only the mxu variant has a bfloat16 contraction")
    return _partials(f"anal_fused_{variant}", f_pk, maps, x, pmm_pk, pms_pk,
                     tab_pk, l_max=l_max, s_len=s_len, spin=spin, bf16=bf16)


def anal_packed_partials(variant: str, dw_pk, maps, x, pmm_pk, pms_pk, *,
                         l_max: int, s_len: int, spin: bool = False):
    """First pass of ``anal_packed_<variant>``, as
    :func:`anal_fused_partials`."""
    return _partials(f"anal_packed_{variant}", dw_pk, maps, x, pmm_pk,
                     pms_pk, None, l_max=l_max, s_len=s_len, spin=spin)


def slot_maps(maps, spin: bool = False) -> tuple:
    """A slot layout's five maps as ``anal_reduce``'s slot route takes them
    (m' only on the spin branch)."""
    m0, m1, mp0, mp1, seed = maps
    return (m0, m1, mp0 if spin else None, mp1 if spin else None, seed)


def _reduce(part, maps, l_max, spin):
    """Chunk-order sum of slot partials (n_slots, n_chunks, S, 2K) through
    ``anal_reduce``'s slot route: each slot's dead tail is written as zeros
    without being read."""
    return lc.anal_reduce(part, None, l_max=l_max,
                          slot_maps=slot_maps(maps, spin))


def anal_fused_vpu(f_pk, maps, x, pmm_pk, pms_pk, tab_pk=None, *,
                   l_max: int, s_len: int, spin: bool = False):
    """Fused analysis, each thread's rings summed in registers, then the
    threads in one fixed-order shared-memory pass per 32-l tile."""
    return _reduce(anal_fused_partials(
        "vpu", f_pk, maps, x, pmm_pk, pms_pk, tab_pk, l_max=l_max,
        s_len=s_len, spin=spin), maps, l_max, spin)


def anal_fused_mxu(f_pk, maps, x, pmm_pk, pms_pk, tab_pk=None, *,
                   l_max: int, s_len: int, spin: bool = False,
                   bf16: bool = False):
    """Fused analysis as (l x ring) P panels contracted against the rotated
    Delta resident in shared memory, in float32 or with ``bf16`` in
    bfloat16 on the tensor cores (float32 accumulation)."""
    return _reduce(anal_fused_partials(
        "mxu", f_pk, maps, x, pmm_pk, pms_pk, tab_pk, l_max=l_max,
        s_len=s_len, spin=spin, bf16=bf16), maps, l_max, spin)


def anal_packed_vpu(dw_pk, maps, x, pmm_pk, pms_pk, *, l_max: int,
                    s_len: int, spin: bool = False):
    """Packed analysis: the fused vpu kernel on the parity planes as given,
    unrotated."""
    return _reduce(anal_packed_partials(
        "vpu", dw_pk, maps, x, pmm_pk, pms_pk, l_max=l_max, s_len=s_len,
        spin=spin), maps, l_max, spin)


def anal_packed_mxu(dw_pk, maps, x, pmm_pk, pms_pk, *, l_max: int,
                    s_len: int, spin: bool = False):
    """Packed analysis: the fused mxu kernel on the parity planes as given,
    unrotated."""
    return _reduce(anal_packed_partials(
        "mxu", dw_pk, maps, x, pmm_pk, pms_pk, l_max=l_max, s_len=s_len,
        spin=spin), maps, l_max, spin)
