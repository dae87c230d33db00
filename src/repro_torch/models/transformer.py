"""Decoder-LM assembly: config-driven blocks, caches, prefill and decode.

Counterpart of the dense path of ``repro.models.transformer``.  Where the
reference stacks each group's layers and runs one ``lax.scan`` over them,
the port keeps one module per layer in an ``nn.ModuleList`` (``layers``,
in the reference's group order) and loops over it.  Caches are a list
with one dict per layer.

Only the ``dense`` block kind (attention + dense MLP: qwen*, danube,
internvl) is ported; the MoE, xLSTM and RG-LRU kinds wait for ROADMAP
item 12c and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import layers as L

__all__ = ["Runtime", "make_rules", "build_groups", "block_kinds",
           "DenseBlock", "LM", "init_lm", "lm_specs", "embed_tokens",
           "forward_train", "init_caches", "caches_specs", "decode_step",
           "prefill"]

NOT_PORTED = "is not ported yet (ROADMAP item 12c)"


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a mesh: ``None`` (no mesh), a
    ``torch.distributed`` ``DeviceMesh``, or anything with ``axis_names``
    and a ``shape`` mapping (as the reference's ``Mesh``)."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Everything the model functions need besides parameters and inputs."""
    cfg: object
    mesh: object
    rules: L.ShardingRules
    device: torch.device

    @property
    def cdt(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    @property
    def pdt(self) -> torch.dtype:
        return getattr(torch, self.cfg.param_dtype)


def make_rules(cfg, mesh=None) -> L.ShardingRules:
    """The reference's logical-axis rules for ``cfg`` on ``mesh``
    (see :func:`mesh_axes`; ``None``: every axis replicated)."""
    sizes = mesh_axes(mesh)
    axes = set(sizes)
    batch = tuple(a for a in ("pod", "data") if a in axes) or None
    model = "model" if "model" in axes else None
    if cfg.tp_profile == "dp":
        batch = tuple(a for a in ("pod", "data", "model")
                      if a in axes) or None
        return L.ShardingRules(batch=batch, heads=None, kv_heads=None,
                               d_ff=None, vocab=None, d_model=None,
                               experts=None, seq=None, layers=None)
    msize = sizes["model"] if model else 1
    small = cfg.tp_profile == "small"
    heads = None if small else model
    kv = model if (not small and model and cfg.n_kv_heads % msize == 0
                   and cfg.n_kv_heads >= msize) else None
    d_ff = model if (cfg.d_ff or cfg.lru_width) and not (
        cfg.family == "ssm") else None
    if small and cfg.family == "ssm":
        d_ff = None
    vocab = model if (model and cfg.vocab % msize == 0) else None
    return L.ShardingRules(
        batch=batch, heads=heads, kv_heads=kv, d_ff=d_ff,
        vocab=vocab, d_model=None, experts=model, seq=None, layers=None)


def build_groups(cfg):
    """[(pattern tuple, n_repeat), ...] covering all layers."""
    if cfg.block_pattern:
        pat = tuple(cfg.block_pattern)
        n_full = cfg.n_layers // len(pat)
        rem = cfg.n_layers - n_full * len(pat)
        groups = [(pat, n_full)] if n_full else []
        if rem:
            groups.append((pat[:rem], 1))
        return groups
    if cfg.n_experts:
        g = []
        if cfg.first_dense_layers:
            g.append((("dense",), cfg.first_dense_layers))
        g.append((("moe",), cfg.n_layers - cfg.first_dense_layers))
        return g
    return [(("dense",), cfg.n_layers)]


def block_kinds(cfg) -> list:
    """The kind of each layer, in ``LM.layers`` order: each group's
    repeats in turn, each repeat's pattern in turn."""
    return [kind for pat, n_rep in build_groups(cfg)
            for _ in range(n_rep) for kind in pat]


# -- blocks --------------------------------------------------------------------


class DenseBlock(nn.Module):
    """``ln1`` -> attention -> residual, ``ln2`` -> MLP -> residual."""

    def __init__(self, cfg, dtype, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.ln1 = L.Norm(cfg.d_model, kind=cfg.norm, device=device)
        self.attn = A.Attention(cfg, **kw)
        self.ln2 = L.Norm(cfg.d_model, kind=cfg.norm, device=device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, act=cfg.act, **kw)

    def spec(self, rules: L.ShardingRules) -> dict:
        return {"ln1": self.ln1.spec(rules), "attn": self.attn.spec(rules),
                "ln2": self.ln2.spec(rules), "mlp": self.mlp.spec(rules)}

    def _mlp(self, x, rt: Runtime):
        h = L.apply_norm(self.ln2, x, rt.cfg.norm)
        return x + L.apply_mlp(self.mlp, h, rt.cfg.act, rt.cdt)

    def apply(self, x, positions, rt: Runtime, cache=None):
        """Training/prefill forward; with a cache, also fills it.
        Returns (x', cache')."""
        h = L.apply_norm(self.ln1, x, rt.cfg.norm)
        y, cache = A.attention_train(self.attn, h, positions, rt.cfg,
                                     window=rt.cfg.sliding_window,
                                     cdt=rt.cdt, cache=cache)
        return self._mlp(x + y, rt), cache

    def decode(self, x, positions, cache, rt: Runtime):
        """One-token step; positions: (1,) int32 on x's device."""
        h = L.apply_norm(self.ln1, x, rt.cfg.norm)
        y, cache = A.attention_decode(self.attn, h, positions, cache,
                                      rt.cfg, cdt=rt.cdt)
        return self._mlp(x + y, rt), cache


BLOCKS = {"dense": DenseBlock}


def _block_class(kind):
    if kind not in BLOCKS:
        raise NotImplementedError(f"the {kind!r} block {NOT_PORTED}")
    return BLOCKS[kind]


class LM(nn.Module):
    """``embed``, ``layers`` (one block per layer), ``final_norm`` and,
    when the embeddings are untied, ``lm_head``.  Its ``state_dict`` keys
    are the reference's parameter paths with each group's stacked layer
    axis unstacked into ``layers.<i>``."""

    def __init__(self, cfg, dtype, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, **kw)
        self.layers = nn.ModuleList(_block_class(kind)(cfg, **kw)
                                    for kind in block_kinds(cfg))
        self.final_norm = L.Norm(cfg.d_model, kind=cfg.norm, device=device)
        self.lm_head = None if cfg.tie_embeddings else \
            L.Dense(cfg.d_model, cfg.vocab, **kw)

    def logits(self, x, cdt):
        """(B, S, d) final-normed states -> (B, S, V) in ``cdt``."""
        if self.lm_head is None:
            return torch.einsum("bsd,vd->bsv", x.to(cdt),
                                self.embed.table.to(cdt))
        return torch.matmul(x.to(cdt), self.lm_head.w.to(cdt))

    def loss_table(self):
        """(V, d) logit weights for the loss."""
        return self.embed.table if self.lm_head is None \
            else self.lm_head.w.t()


def init_lm(cfg, gen: torch.Generator, device) -> LM:
    """A model in ``cfg.param_dtype`` with the reference's initial
    distributions, drawn from ``gen`` on ``device``: dense weights
    N(0, 1/d_in), the embedding N(0, 0.02^2), norm scales one, biases
    zero."""
    return LM(cfg, getattr(torch, cfg.param_dtype), device=device, gen=gen)


def lm_specs(cfg, rules: L.ShardingRules) -> dict:
    """The parameter spec tree: nested dicts keyed like the model's
    parameters (``layers`` a list), leaves tuples of mesh axes."""
    model = LM(cfg, torch.float32, device="meta")
    specs = {"embed": model.embed.spec(rules),
             "layers": [blk.spec(rules) for blk in model.layers],
             "final_norm": model.final_norm.spec(rules)}
    if model.lm_head is not None:
        specs["lm_head"] = model.lm_head.spec(rules, "d_model", "vocab")
    return specs


# -- training forward ----------------------------------------------------------


def embed_tokens(model: LM, tokens, rt: Runtime):
    return model.embed.table[tokens.long()].to(rt.cdt)


def forward_train(model: LM, tokens, rt: Runtime, *, extra=None):
    """Decoder-LM loss.  tokens: (B, S) integer.  extra: dict for the vlm
    stub ({"patch_embeds": (B, n_vis, d)}).  Targets = tokens shifted
    left, -1 at the end and under the patch embeddings."""
    cfg = rt.cfg
    x = embed_tokens(model, tokens, rt)
    targets = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                        dim=1)
    if extra is not None and "patch_embeds" in extra:
        pe = extra["patch_embeds"].to(rt.cdt)
        x = torch.cat([pe, x], dim=1)
        targets = torch.cat([torch.full(pe.shape[:2], -1,
                                        dtype=targets.dtype,
                                        device=targets.device), targets],
                            dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for blk in model.layers:
        x, _ = blk.apply(x, positions, rt)
    x = L.apply_norm(model.final_norm, x, cfg.norm)
    # the reference adds aux_weight * (the MoE blocks' auxiliary loss),
    # which is 0 on the dense blocks
    return L.cross_entropy_loss(model.loss_table(), x, targets,
                                compute_dtype=rt.cdt,
                                n_chunks=cfg.loss_chunks)


# -- serving: caches, prefill, decode ------------------------------------------


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                device=None) -> list:
    """One cache dict per layer (see ``attention.init_cache``)."""
    return [A.init_cache(cfg, batch, max_len, dtype, device)
            for _ in block_kinds(cfg)]


def caches_specs(cfg, rules: L.ShardingRules) -> list:
    """The cache spec tree: one dict per layer, like the cache list."""
    return [A.cache_specs(cfg, rules) for _ in block_kinds(cfg)]


@torch.no_grad()
def decode_step(model: LM, token, pos, caches, rt: Runtime):
    """One decode step.  token: (B, 1) integer; pos: the position (an int
    or a 0-d tensor).  Updates ``caches`` in place.

    Returns (logits (B, vocab) float32, caches)."""
    x = embed_tokens(model, token, rt)
    positions = A.decode_positions(pos, x.device)
    for blk, cache in zip(model.layers, caches):
        x, _ = blk.decode(x, positions, cache, rt)
    x = L.apply_norm(model.final_norm, x, rt.cfg.norm)
    return model.logits(x, rt.cdt)[:, 0].float(), caches


@torch.no_grad()
def prefill(model: LM, tokens, caches, rt: Runtime):
    """Prefill the caches with a full prompt.  tokens: (B, S).  Updates
    ``caches`` in place.

    Returns (last-token logits (B, vocab) float32, caches)."""
    x = embed_tokens(model, tokens, rt)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for blk, cache in zip(model.layers, caches):
        x, _ = blk.apply(x, positions, rt, cache=cache)
    x = L.apply_norm(model.final_norm, x[:, -1:], rt.cfg.norm)
    return model.logits(x, rt.cdt)[:, 0].float(), caches
