"""Qwen1.5-32B [hf:Qwen family; spec-literal].

Spec: 64L d_model=5120 40H (GQA kv=40 == MHA) d_ff=27392 vocab=152064,
QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab=152064, head_dim=128,
    attention="gqa", qkv_bias=True, rope_theta=1e6,
    tp_profile="tp", tie_embeddings=False,
)
