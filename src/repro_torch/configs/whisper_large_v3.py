"""Whisper large-v3 [arXiv:2212.04356; spec-literal].

Spec: 32L(enc)+32L(dec) d_model=1280 20H MHA d_ff=5120 vocab=51866;
encoder-decoder with conv audio frontend STUBBED per the task
(input_specs() provides precomputed frame embeddings).
20 heads % 16 mesh => `small` TP profile.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    attention="gqa", norm="layernorm", act="gelu",
    is_encoder_decoder=True, n_encoder_layers=32,
    frontend="audio_stub",
    tp_profile="small", tie_embeddings=False,
)
