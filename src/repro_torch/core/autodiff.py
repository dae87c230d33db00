"""Adjoint-based differentiation rules for the transform layers.

Counterpart of ``repro.core.autodiff``.  Every layer of the transform
stack is a linear map whose adjoint is the opposite-direction transform of
the same layer:

  ===========================  =======================================
  layer (forward)              adjoint (transpose)
  ===========================  =======================================
  Legendre synthesis           Legendre analysis with unit weights
  Legendre analysis (w)        w * Legendre synthesis
  phase synthesis              fac_m * weight-free phase analysis
  phase analysis               phase synthesis of the cotangent / fac_m
  kernel ``ops.synth``         kernel ``ops.anal`` (same layout)
  kernel ``ops.anal``          kernel ``ops.synth`` (same layout)
  fused synthesis              fac_m * fused analysis chain
  fused analysis               fused synthesis chain of ct / fac_m
  ===========================  =======================================

:func:`linear_pair` packages one such (forward, transpose) pair as a
``torch.autograd.Function``: backward applies the transpose to the
cotangent (so autograd never traces a recurrence loop or a kernel), and
forward mode applies the forward map to the tangent (the map is linear).

Contract: ``fwd(residuals, operand)`` is linear in ``operand`` (a tensor
or a tuple of real tensors); ``transpose(residuals, cotangent)`` is its
exact transpose under the standard real inner product and returns
tensors shaped like ``operand``.  ``residuals`` (a dict: geometry, seeds,
weights, index maps) are constants of the differentiation: a residual
tensor that requires a gradient, or carries a forward-mode tangent,
raises a ``ValueError`` naming it rather than receiving a silent zero.
First order only: the backward is not itself differentiable.

Complex operands are split into real and imaginary parts before they
reach a pair, so the pairs see real tensors only and PyTorch's complex
convention applies outside them: for a real loss of a complex input, the
gradient PyTorch returns is the conjugate of what ``jax.grad`` returns.
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad
from torch.autograd.function import once_differentiable

__all__ = ["linear_pair"]


def _as_tuple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


class _LinearPair(torch.autograd.Function):
    """One linear map with a hand-written transpose (see module docs)."""

    @staticmethod
    def forward(ctx, fwd, transpose, residuals, single, *ops):
        ctx.fwd, ctx.transpose, ctx.residuals = fwd, transpose, residuals
        ctx.single = single
        ctx.op_meta = [(o.shape, o.dtype, o.device) for o in ops]
        out = fwd(residuals, ops[0] if single else ops)
        ctx.out_single = not isinstance(out, tuple)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *cts):
        ct = cts[0] if ctx.out_single else cts
        grads = _as_tuple(ctx.transpose(ctx.residuals, ct))
        return (None, None, None, None, *grads)

    @staticmethod
    def jvp(ctx, _fwd, _transpose, _residuals, _single, *tangents):
        tangents = tuple(
            torch.zeros(shape, dtype=dtype, device=device) if t is None else t
            for t, (shape, dtype, device) in zip(tangents, ctx.op_meta))
        return ctx.fwd(ctx.residuals,
                       tangents[0] if ctx.single else tangents)


def _check_residuals(residuals: dict) -> None:
    for name, v in residuals.items():
        if not isinstance(v, torch.Tensor):
            continue
        perturbed = (torch.is_grad_enabled() and v.requires_grad) or \
            forward_ad.unpack_dual(v).tangent is not None
        if perturbed:
            raise ValueError(
                f"linear_pair: differentiation with respect to the residual "
                f"{name!r} (quadrature weights, grid geometry, seed tables "
                f"and index maps are constants of the transform) is not "
                f"supported -- only the linear operands (alm, maps, Delta) "
                f"carry adjoint-based gradients")


def linear_pair(fwd, transpose, residuals: dict, operand):
    """``fwd(residuals, operand)``, differentiable through ``transpose``.

    ``operand`` is a tensor or a tuple of tensors; the result is whatever
    ``fwd`` returns (a tensor or a tuple of tensors).  Reverse mode calls
    ``transpose(residuals, cotangent)``; forward mode calls ``fwd`` on the
    tangent.  ``residuals`` maps names to the non-differentiated arguments.
    """
    _check_residuals(residuals)
    single = not isinstance(operand, (tuple, list))
    return _LinearPair.apply(fwd, transpose, residuals, single,
                             *_as_tuple(operand))
