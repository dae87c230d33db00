"""Shared building blocks of the language models, in PyTorch.

Counterpart of ``repro.models.layers``.  Parameters live in small
``nn.Module``s whose attribute names are the reference's parameter keys
(``Dense.w``/``.b``, ``Norm.scale``/``.bias``, ``Embedding.table``), so a
reference parameter path is the port's ``state_dict`` key.  The
arithmetic is in plain functions on tensors and rounds where the
reference rounds: ``dense`` casts both operands to the compute dtype and
adds the bias in it, norms compute in float32 and return the input's
dtype, RoPE rotates in float32.

Each module's ``spec(rules)`` gives its sharding spec: a dict keyed like
its parameters, whose leaves are plain tuples of mesh axis names (or
``None``), one entry per tensor axis.  ``ShardingRules`` resolves the
logical axes as the reference's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "ShardingRules", "Dense", "Norm", "Embedding", "MLP", "dense",
    "rms_norm", "layer_norm", "apply_norm", "rope_freqs", "apply_rope",
    "swiglu", "gelu_mlp", "apply_mlp", "cross_entropy_loss",
]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis -> mesh axis (or None) resolution."""
    batch: tuple | str | None = ("pod", "data")
    heads: str | None = "model"        # attention head axis
    kv_heads: str | None = None        # usually replicated (kv < mesh)
    d_ff: str | None = "model"         # MLP hidden
    vocab: str | None = "model"        # embedding/logits vocab axis
    d_model: str | None = None         # residual axis ("data" under FSDP)
    experts: str | None = "model"      # MoE expert axis
    seq: str | None = None             # sequence axis (SP when set)
    layers: str | None = None          # stacked-layer axis (FSDP variant)

    def ax(self, name: str | None):
        if name is None:
            return None
        return getattr(self, name)


def _normal(gen: torch.Generator | None, shape, scale: float, dtype,
            device):
    """float32 normal draws times ``scale``, then cast (the reference's
    ``_init_normal``); with no generator, an uninitialised tensor (for a
    module whose state is loaded afterwards)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x.mul_(scale)).to(dtype)


# -- dense ---------------------------------------------------------------------


class Dense(nn.Module):
    """``w`` (d_in, d_out) ~ N(0, 1/d_in), optional zero bias ``b``
    (d_out,)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.bfloat16, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.w = nn.Parameter(_normal(gen, (d_in, d_out), 1.0 / np.sqrt(d_in),
                                      dtype, device))
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype,
                                          device=device)) if bias else None

    def spec(self, rules: ShardingRules, in_axis, out_axis) -> dict:
        s = {"w": (rules.ax(in_axis), rules.ax(out_axis))}
        if self.b is not None:
            s["b"] = (rules.ax(out_axis),)
        return s


def dense(p: Dense, x, cdt):
    y = torch.matmul(x.to(cdt), p.w.to(cdt))
    if p.b is not None:
        y = y + p.b.to(cdt)
    return y


# -- norms ---------------------------------------------------------------------


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``); float32
    parameters whatever the model's dtype, as in the reference."""

    def __init__(self, d: int, *, kind: str = "rmsnorm", device=None):
        super().__init__()
        f32 = torch.float32
        self.scale = nn.Parameter(torch.ones(d, dtype=f32, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=f32, device=device)) \
            if kind == "layernorm" else None

    def spec(self, rules: ShardingRules) -> dict:
        s = {"scale": (None,)}
        if self.bias is not None:
            s["bias"] = (None,)
        return s


def rms_norm(p: Norm, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p.scale.float()
    return y.to(x.dtype)


def layer_norm(p: Norm, x, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p.scale.float() + p.bias.float()
    return y.to(x.dtype)


def apply_norm(p: Norm, x, kind: str):
    return rms_norm(p, x) if kind == "rmsnorm" else layer_norm(p, x)


# -- RoPE ----------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 1e4) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(half, dtype=np.float64) * 2.0
                            / head_dim))


#: (head_dim, theta, device) -> float32 frequencies on that device, so
#: a step copies them to the card once, not twice a layer
_ROPE_FREQS: dict = {}


def _rope_freqs_on(head_dim: int, theta: float, device) -> torch.Tensor:
    key = (head_dim, float(theta), torch.device(device))
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        freqs = torch.as_tensor(rope_freqs(head_dim, theta),
                                dtype=torch.float32, device=device)
        _ROPE_FREQS[key] = freqs
    return freqs


def apply_rope(x, positions, *, theta: float = 1e4):
    """x: (..., S, H, D) with D even; positions: (S,).  Rotates the split
    halves (x1, x2) of the last axis, not interleaved pairs; frequencies
    are float64 cast to float32, the rotation runs in float32."""
    freqs = _rope_freqs_on(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs              # (S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- embeddings ----------------------------------------------------------------


class Embedding(nn.Module):
    """``table`` (vocab, d) ~ N(0, 0.02^2)."""

    def __init__(self, vocab: int, d: int, dtype=torch.bfloat16,
                 device=None, gen: torch.Generator | None = None):
        super().__init__()
        self.table = nn.Parameter(_normal(gen, (vocab, d), 0.02, dtype,
                                          device))

    def spec(self, rules: ShardingRules) -> dict:
        return {"table": (rules.ax("vocab"), rules.ax("d_model"))}


# -- MLPs ----------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU (``gate``, ``up``, ``down``) or GELU (``up``, ``down``)."""

    def __init__(self, d: int, d_ff: int, *, act: str = "swiglu",
                 dtype=torch.bfloat16, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.gate = Dense(d, d_ff, **kw) if act == "swiglu" else None
        self.up = Dense(d, d_ff, **kw)
        self.down = Dense(d_ff, d, **kw)

    def spec(self, rules: ShardingRules) -> dict:
        s = {}
        if self.gate is not None:
            s["gate"] = self.gate.spec(rules, "d_model", "d_ff")
        s["up"] = self.up.spec(rules, "d_model", "d_ff")
        s["down"] = self.down.spec(rules, "d_ff", "d_model")
        return s


def swiglu(p: MLP, x, cdt):
    g = dense(p.gate, x, cdt)
    u = dense(p.up, x, cdt)
    return dense(p.down, F.silu(g) * u, cdt)


def gelu_mlp(p: MLP, x, cdt):
    u = dense(p.up, x, cdt)
    return dense(p.down, F.gelu(u, approximate="tanh"), cdt)


def apply_mlp(p: MLP, x, act: str, cdt):
    return swiglu(p, x, cdt) if act == "swiglu" else gelu_mlp(p, x, cdt)


# -- loss ----------------------------------------------------------------------


def cross_entropy_loss(embedding_table, h, targets, *, n_chunks: int = 8,
                       compute_dtype=torch.bfloat16):
    """Chunked softmax cross entropy against (vocab, d) logit weights.

    h: (B, S, D) final hidden states; targets: (B, S) integer (-1 = pad,
    ignored).  The (B, S, V) logits are never held whole: the sequence
    runs in ``n_chunks`` pieces, their float32 sums carried across.  (The
    reference's ``z_loss`` term, which no caller sets, is not ported.)
    """
    B, S, D = h.shape
    n_chunks = max(1, min(n_chunks, S))
    while S % n_chunks:
        n_chunks -= 1
    s = S // n_chunks
    table = embedding_table.to(compute_dtype)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        hc, tc = h[:, c * s:(c + 1) * s], targets[:, c * s:(c + 1) * s]
        logits = torch.einsum("bsd,vd->bsv", hc.to(compute_dtype),
                              table).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           tc.clamp(min=0).long()[..., None])[..., 0]
        valid = (tc >= 0).float()
        tot = tot + ((lse - tgt) * valid).sum()
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1.0)
