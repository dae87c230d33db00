"""Qwen2-0.5B [arXiv:2407.10671; hf-verified].

Spec: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, QKV bias.
14 heads % 16 mesh => `small` TP profile (attention replicated on model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151936, head_dim=64,
    attention="gqa", qkv_bias=True, rope_theta=1e6,
    tp_profile="small",
)
