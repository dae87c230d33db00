"""Architecture & run configuration dataclasses + the assigned shape set."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "reduced"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention
    attention: str = "gqa"         # gqa | mla | none
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 1e4

    # MLA (DeepSeek-family)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "a2a"           # a2a (seq-split dispatch) | replicated

    # recurrent / hybrid
    block_pattern: Optional[Tuple[str, ...]] = None  # e.g. ("rglru","rglru","local")
    lru_width: Optional[int] = None
    local_window: int = 2048
    mlstm_pf: float = 2.0

    # encoder-decoder / multimodal
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    frontend: Optional[str] = None  # audio_stub | vision_stub
    n_vision_tokens: int = 256      # stub patch embeddings per sample (vlm)

    # norms / activations / embeddings
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = True

    # dtypes & sharding
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    tp_profile: str = "tp"          # tp | small  (DESIGN.md §6)
    long_context_ok: bool = False   # may run the long_500k cell
    remat: bool = True

    # accounting-lowering knobs (roofline correction for while-loop
    # trip-count undercounting in XLA cost analysis; see launch/dryrun.py)
    attn_impl: str = "mea"          # mea | dense
    loss_chunks: int = 8
    scan_unroll: bool = False       # unroll the layer scan
    inner_unroll: bool = False      # unroll block-internal chunk scans

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Approximate parameter count (reported in EXPERIMENTS.md)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attention == "gqa":
            per_layer += d * self.n_heads * self.hd * 2          # q, o
            per_layer += d * self.n_kv_heads * self.hd * 2       # k, v
        elif self.attention == "mla":
            per_layer += d * self.q_lora_rank
            per_layer += self.q_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.qk_rope_dim)
            per_layer += d * (self.kv_lora_rank + self.qk_rope_dim)
            per_layer += self.kv_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.v_head_dim)
            per_layer += self.n_heads * self.v_head_dim * d
        if self.n_experts:
            moe = 3 * self.moe_d_ff * d * (self.n_experts
                                           + self.n_shared_experts)
            dense = 3 * self.d_ff * d
            per_layer += moe  # dominated by experts
            total = emb + (L - self.first_dense_layers) * per_layer \
                + self.first_dense_layers * (per_layer - moe + dense)
            return total
        if self.d_ff:
            per_layer += 3 * d * self.d_ff if self.act == "swiglu" \
                else 2 * d * self.d_ff
        if self.block_pattern and "mlstm" in self.block_pattern:
            per_layer = 0  # handled coarsely below
            di = int(d * self.mlstm_pf)
            per_layer += 2 * d * di + 3 * di * di + di * d      # mLSTM-ish
        if self.block_pattern and "rglru" in self.block_pattern:
            w = self.lru_width or d
            per_layer += 2 * d * w + 2 * w * w + w * d
        enc = self.n_encoder_layers * per_layer if self.is_encoder_decoder else 0
        return emb + L * per_layer + enc

    def n_active_params(self) -> int:
        """Active params per token (MoE top-k)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        active_moe = 3 * self.moe_d_ff * d * (self.top_k
                                              + self.n_shared_experts)
        full_moe = 3 * self.moe_d_ff * d * (self.n_experts
                                            + self.n_shared_experts)
        return self.n_params() - self.n_layers * (full_moe - active_moe)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=min(cfg.n_layers, 2 if not cfg.block_pattern
                     else len(cfg.block_pattern)),
        d_model=128,
        n_heads=max(2, min(cfg.n_heads, 4)),
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        head_dim=32 if cfg.head_dim else None,
        remat=False,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.n_experts:
        base.update(n_experts=8, top_k=2, moe_d_ff=64,
                    n_shared_experts=min(cfg.n_shared_experts, 1),
                    first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.attention == "mla":
        base.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                    qk_rope_dim=16, v_head_dim=32, head_dim=None)
    if cfg.lru_width:
        base.update(lru_width=128)
    if cfg.sliding_window:
        base.update(sliding_window=64)
    if cfg.is_encoder_decoder:
        base.update(n_encoder_layers=2)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
