"""H2O Danube3-4B [arXiv:2401.16818; spec-literal].

Spec: 24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000,
llama+mistral mix with sliding-window attention (window 4096).
SWA => sub-quadratic decode => runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000, head_dim=120,
    attention="gqa", sliding_window=4096, rope_theta=1e4,
    tp_profile="tp", long_context_ok=True,
)
