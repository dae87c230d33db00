"""RecurrentGemma-9B [arXiv:2402.19427; spec-literal].

Spec: 38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000;
RG-LRU + local attention 1:2 (pattern: rglru, rglru, local window 2048).
Bounded state => runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    attention="gqa", block_pattern=("rglru", "rglru", "local"),
    lru_width=4096, local_window=2048,
    tp_profile="tp", long_context_ok=True,
)
