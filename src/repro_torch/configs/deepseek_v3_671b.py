"""DeepSeek-V3 671B [arXiv:2412.19437; hf-verified].

Spec: 61L d_model=7168 128H d_ff=2048(expert) vocab=129280, MLA,
1 shared + 256 routed experts top-8.  MLA dims and the 3 leading dense
layers (d_ff 18432) follow the published config.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab=129280,
    attention="mla", rope_theta=1e4,
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    n_experts=256, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    first_dense_layers=3,
    tp_profile="tp", tie_embeddings=False,
)
