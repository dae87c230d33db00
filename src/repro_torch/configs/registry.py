"""--arch <id> registry: the 10 assigned architectures + the paper's own."""

from repro_torch.configs import (kimi_k2_1t_a32b, deepseek_v3_671b, internvl2_1b,
                           qwen1_5_32b, qwen3_8b, h2o_danube_3_4b,
                           qwen2_0_5b, xlstm_125m, recurrentgemma_9b,
                           whisper_large_v3)

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    kimi_k2_1t_a32b, deepseek_v3_671b, internvl2_1b, qwen1_5_32b, qwen3_8b,
    h2o_danube_3_4b, qwen2_0_5b, xlstm_125m, recurrentgemma_9b,
    whisper_large_v3)}


def get(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
