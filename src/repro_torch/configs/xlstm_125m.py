"""xLSTM-125M [arXiv:2405.04517; spec-literal].

Spec: 12L d_model=768 4H d_ff=0 vocab=50304; alternating sLSTM + mLSTM
blocks (1:1).  O(1) decode state => runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    attention="none", block_pattern=("mlstm", "slstm"),
    mlstm_pf=2.0,
    tp_profile="small", long_context_ok=True,
)
