"""The Legendre-stage seam: variant choice and CPU / CUDA dispatch.

Counterpart of the plain-layout part of ``repro.kernels.ops``.  ``synth``
and ``anal`` take the unpadded layouts (the CUDA kernels mask the ragged
ring edge themselves, so nothing is padded to the TPU's 128-lane tiles):

  synth: a (Mp, L1, 2K) f32 -> Delta (Mp, P, R, 2K) f32;
  anal:  dw (Mp, P, R, 2K) f32 -> (Mp, l_max+1, 2K) f32.

A CPU tensor runs the plain version (``kernels.ref``); a CUDA tensor
launches the hand-written kernel (``kernels.legendre_cuda``) or raises;
any other device raises.  The environment overrides and the measured
autotune of the reference's ``pick_variant`` wait for ROADMAP.md Open
items section 1, item 9.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as kref

__all__ = ["synth", "anal", "pick_variant"]


def pick_variant(K2: int, variant: str | None = None) -> str:
    """vpu-vs-mxu: the explicit argument, else the static ``K2 >= 16`` rule
    (broadcast FMA for few maps, panel contraction for many)."""
    if variant in ("vpu", "mxu"):
        return variant
    if variant is not None:
        raise ValueError(f"unknown Legendre variant {variant!r}")
    return "mxu" if K2 >= 16 else "vpu"


def _operands(m_vals, x, pmm, pms, device):
    """The seed operands as contiguous tensors of the kernels' dtypes."""
    def t(v, dtype):
        return torch.as_tensor(v, device=device).to(dtype).contiguous()
    return (t(m_vals, torch.int32), t(x, torch.float32),
            t(pmm, torch.float32), t(pms, torch.int32))


def _route(device: torch.device) -> str:
    if device.type in ("cpu", "cuda"):
        return device.type
    raise ValueError(f"the Legendre kernels run on CUDA tensors and their "
                     f"plain versions on CPU tensors; got a {device.type} "
                     "tensor")


def synth(a, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False,
          variant: str | None = None) -> torch.Tensor:
    """Kernel-backed synthesis: Delta_m(r) = sum_l a_lm P_lm(x_r).

    a (Mp, L1, 2K) f32; m_vals (Mp,) int (-1 rows are padding and give
    zeros); x (R,) f32 cos(theta); pmm/pms (Mp, R) seeds from
    ``ref.prepare_seeds``.  Returns (Mp, P, R, 2K) f32, P = 2 if fold.
    """
    route = _route(a.device)
    var = pick_variant(a.shape[-1], variant)
    m_t, x_t, pmm_t, pms_t = _operands(m_vals, x, pmm, pms, a.device)
    a = a.to(torch.float32).contiguous()
    if route == "cpu":
        return kref.synth_ref(a, m_t, x_t, pmm_t, pms_t, l_max=l_max,
                              fold=fold)
    from repro_torch.kernels import legendre_cuda
    kernel = legendre_cuda.synth_vpu if var == "vpu" \
        else legendre_cuda.synth_mxu
    return kernel(a, m_t, x_t, pmm_t, pms_t, l_max=l_max, fold=fold)


def anal(dw, m_vals, x, pmm, pms, *, l_max: int, fold: bool = False,
         variant: str | None = None) -> torch.Tensor:
    """Kernel-backed analysis: a_lm = sum_r dw_m(r) P_lm(x_r).

    dw (Mp, P, R, 2K) f32 weighted Delta (P = 2 (even, odd) if fold).
    Returns (Mp, l_max+1, 2K) f32.
    """
    route = _route(dw.device)
    var = pick_variant(dw.shape[-1], variant)
    m_t, x_t, pmm_t, pms_t = _operands(m_vals, x, pmm, pms, dw.device)
    dw = dw.to(torch.float32).contiguous()
    if route == "cpu":
        return kref.anal_ref(dw, m_t, x_t, pmm_t, pms_t, l_max=l_max,
                             fold=fold)
    from repro_torch.kernels import legendre_cuda
    kernel = legendre_cuda.anal_vpu if var == "vpu" \
        else legendre_cuda.anal_mxu
    return kernel(dw, m_t, x_t, pmm_t, pms_t, l_max=l_max, fold=fold)
