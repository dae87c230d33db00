"""Grouped-query attention (bias, qk-norm, sliding window) and its caches.

Counterpart of the GQA half of ``repro.models.attention``.  Training and
prefill attention runs blockwise with an online softmax (``mea``, the same
q and kv blocks as the reference, in float32), so the (S, T) score matrix
is never held whole; ``dense_attention`` is the unblocked form.  Query
head h reads kv head h // G (G = H / KvH).

Decode reads a position-indexed cache per layer: ``k``/``v`` (B, slots,
KvH, Dh) and ``pos`` (slots,), where ``slots`` is the window of a
sliding-window model (a ring buffer: position p lives in slot p % slots)
and the whole context otherwise.  Empty slots carry position -1 and mask
to -inf.  The port updates a cache in place and returns it.

MLA and ``ulysses_attention`` are not ported yet (ROADMAP item 12c).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L

__all__ = ["Attention", "attention_train", "attention_decode",
           "decode_positions", "init_cache", "cache_specs", "mea",
           "dense_attention"]


def _mask_bias(qpos, kpos, window):
    """Additive mask: causal, optionally sliding-window.  qpos: (Sq,),
    kpos: (Sk,) -> (Sq, Sk) float32 {0, -inf}."""
    ok = kpos[None, :] <= qpos[:, None]
    if window is not None:
        ok &= (qpos[:, None] - kpos[None, :]) < window
    ok &= kpos[None, :] >= 0          # invalid slots carry position -1
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill_(~ok, -torch.inf)


def _key_bias(kpos):
    """Non-causal mask: only the invalid slots.  (1, Sk) {0, -inf}."""
    return torch.zeros((1, kpos.shape[0]), dtype=torch.float32,
                       device=kpos.device).masked_fill_(kpos[None] < 0,
                                                        -torch.inf)


def mea(q, k, v, qpos, kpos, *, window=None, q_block=512, kv_block=1024,
        causal=True):
    """Memory-efficient attention.  q: (B, Sq, H, D); k/v: (B, Sk, KvH, D).

    The reference's blocks and online-softmax update, in float32.  One
    guard the reference lacks: a kv block that masks a query row whole
    before any key of that row was seen (a sliding window more than a
    block behind the query) leaves the running max at -inf; the
    reference then computes exp(-inf - -inf) = NaN, the port subtracts 0
    there and the row's sums stay 0, which equals the reference wherever
    the reference is finite.  Returns (B, Sq, H, Dv) in q.dtype.
    """
    B, Sq, H, D = q.shape
    _, Sk, KvH, Dv = v.shape
    G = H // KvH
    scale = float(1.0 / np.sqrt(D))
    q_block = min(q_block, Sq)
    while Sq % q_block:
        q_block //= 2
    kv_block = min(kv_block, Sk)
    while Sk % kv_block:
        kv_block //= 2
    qg = q.reshape(B, Sq, KvH, G, D).float()
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, Sq, q_block):
        qs = qg[:, q0:q0 + q_block]
        qp = qpos[q0:q0 + q_block]
        acc = torch.zeros((B, KvH, G, q_block, Dv), dtype=torch.float32,
                          device=q.device)
        m_run = torch.full((B, KvH, G, q_block), -torch.inf,
                           dtype=torch.float32, device=q.device)
        l_run = torch.zeros((B, KvH, G, q_block), dtype=torch.float32,
                            device=q.device)
        for k0 in range(0, Sk, kv_block):
            ks = kf[:, k0:k0 + kv_block]
            vs = vf[:, k0:k0 + kv_block]
            kp = kpos[k0:k0 + kv_block]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qs, ks) * scale
            bias = _mask_bias(qp, kp, window) if causal else _key_bias(kp)
            s = s + bias
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            m_sub = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(s - m_sub[..., None])
            corr = torch.exp(m_run - m_sub)
            l_run = l_run * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vs)
            acc = acc * corr[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp(l_run[..., None], min=1e-30)
        outs.append(out.movedim(3, 1).reshape(B, q_block, H, Dv))
    return torch.cat(outs, dim=1).to(q.dtype)


def dense_attention(q, k, v, qpos, kpos, *, window=None, causal=True):
    """Unblocked attention (materialised scores)."""
    B, Sq, H, D = q.shape
    KvH = v.shape[2]
    G = H // KvH
    scale = float(1.0 / np.sqrt(D))
    qg = q.reshape(B, Sq, KvH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    bias = _mask_bias(qpos, kpos, window) if causal else _key_bias(kpos)
    w = torch.softmax(s + bias, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", w, v.float())
    return out.movedim(3, 1).reshape(B, Sq, H, -1).to(q.dtype)


# -- GQA -----------------------------------------------------------------------


class Attention(nn.Module):
    """``wq``/``wk``/``wv`` (bias when ``qkv_bias``), ``wo``, and
    ``q_norm``/``k_norm`` when ``qk_norm``."""

    def __init__(self, cfg, dtype=torch.bfloat16, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        if cfg.attention != "gqa":
            raise NotImplementedError(
                f"{cfg.attention!r} attention is not ported yet (ROADMAP "
                "item 12c)")
        d, H, KvH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.head_dim or d // H
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.wq = L.Dense(d, H * hd, bias=cfg.qkv_bias, **kw)
        self.wk = L.Dense(d, KvH * hd, bias=cfg.qkv_bias, **kw)
        self.wv = L.Dense(d, KvH * hd, bias=cfg.qkv_bias, **kw)
        self.wo = L.Dense(H * hd, d, **kw)
        self.q_norm = L.Norm(hd, device=device) if cfg.qk_norm else None
        self.k_norm = L.Norm(hd, device=device) if cfg.qk_norm else None

    def spec(self, rules: L.ShardingRules) -> dict:
        s = {"wq": self.wq.spec(rules, "d_model", "heads"),
             "wk": self.wk.spec(rules, "d_model", "kv_heads"),
             "wv": self.wv.spec(rules, "d_model", "kv_heads"),
             "wo": self.wo.spec(rules, "heads", "d_model")}
        if self.q_norm is not None:
            s["q_norm"] = self.q_norm.spec(rules)
            s["k_norm"] = self.k_norm.spec(rules)
        return s


def _qkv(p: Attention, x, cfg, positions, cdt):
    B, S, d = x.shape
    H, KvH = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.head_dim or d // H
    q = L.dense(p.wq, x, cdt).reshape(B, S, H, hd)
    k = L.dense(p.wk, x, cdt).reshape(B, S, KvH, hd)
    v = L.dense(p.wv, x, cdt).reshape(B, S, KvH, hd)
    if cfg.qk_norm:
        q = L.rms_norm(p.q_norm, q)
        k = L.rms_norm(p.k_norm, k)
    q = L.apply_rope(q, positions, theta=cfg.rope_theta)
    k = L.apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def attention_train(p: Attention, x, positions, cfg, *, window=None,
                    cdt=torch.bfloat16, cache=None):
    """Causal self-attention for train/prefill; positions: (S,).  With a
    ``cache``, also writes the chunk's keys and values into it.

    Returns (y, cache') -- cache' is None when cache is None.
    """
    B, S, d = x.shape
    q, k, v = _qkv(p, x, cfg, positions, cdt)
    win = window if window is not None else cfg.sliding_window
    out = mea(q, k, v, positions, positions, window=win)
    y = L.dense(p.wo, out.reshape(B, S, -1), cdt)
    if cache is not None:
        cache = _fill_cache(cache, k, v, positions)
    return y, cache


# -- caches --------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Self-attention cache for one layer (a ring buffer of the window's
    slots on a sliding-window model)."""
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    W = cfg.sliding_window
    slots = min(max_len, W) if W else max_len
    shape = (batch, slots, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((slots,), -1, dtype=torch.int32,
                              device=device)}


def cache_specs(cfg, rules: L.ShardingRules) -> dict:
    kv = (rules.ax("batch"), None, rules.ax("kv_heads"), None)
    return {"k": kv, "v": kv, "pos": (None,)}


def _fill_cache(cache, k, v, positions):
    """Write a prefill chunk into the (possibly ring-buffer) cache, in
    place.  A chunk longer than the ring writes only its last ``slots``
    positions: the reference's scatter of every position repeats slot
    indices there, and a duplicate-index scatter has no defined winner
    on the card; the last ``slots`` positions are what "last write wins"
    keeps, and their slots are distinct."""
    slots = cache["k"].shape[1]
    if positions.shape[0] > slots:
        k, v, positions = k[:, -slots:], v[:, -slots:], positions[-slots:]
    idx = (positions % slots).long()
    cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
    cache["pos"].index_copy_(0, idx, positions.to(torch.int32))
    return cache


def decode_positions(pos, device) -> torch.Tensor:
    """The (1,) int32 position tensor of a decode step on ``device``:
    from a Python int by a fill on the device (no host-to-device copy),
    from a tensor by a cast that stays on its device when that is
    ``device``."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(1)
    return torch.full((1,), int(pos), dtype=torch.int32, device=device)


def attention_decode(p: Attention, x, positions, cache, cfg, *,
                     cdt=torch.bfloat16):
    """One-token decode.  x: (B, 1, d); positions: the current position
    as a (1,) int32 tensor on x's device (``decode_positions``, made once
    a step).  Updates ``cache`` in place.

    Returns (y (B, 1, d), cache).
    """
    B = x.shape[0]
    H, KvH = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    q, k, v = _qkv(p, x, cfg, positions, cdt)
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    slot = (positions % ck.shape[1]).long()
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    cp.index_copy_(0, slot, positions)
    scale = float(1.0 / float(np.sqrt(hd)))
    qh = q.reshape(B, 1, KvH, H // KvH, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(), ck.float()) * scale
    s = s + _mask_bias(positions, cp, cfg.sliding_window)     # (1, slots)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", w, cv.float())
    out = out.movedim(3, 1).reshape(B, 1, H * hd).to(cdt)
    return L.dense(p.wo, out, cdt), cache
