"""InternVL2-1B [arXiv:2404.16821; hf-verified backbone].

Spec: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
InternViT frontend is a STUB per the task: input_specs() provides
precomputed patch embeddings (n_vision_tokens per sample).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655, head_dim=64,
    attention="gqa", qkv_bias=True, rope_theta=1e6,
    frontend="vision_stub", n_vision_tokens=256,
    tp_profile="small",
)
