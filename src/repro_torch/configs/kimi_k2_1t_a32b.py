"""Kimi K2 -- trillion-param MoE [arXiv:2501.kimi2; spec-literal].

Spec: 61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert) vocab=163840,
MoE 384 experts top-8.  All layers MoE per the assignment table.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, head_dim=112,
    attention="gqa", rope_theta=5e4,
    n_experts=384, top_k=8, moe_d_ff=2048, n_shared_experts=0,
    first_dense_layers=0,
    tp_profile="tp", tie_embeddings=False,
)
