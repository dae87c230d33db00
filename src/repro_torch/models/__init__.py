# The language models of the reference's non-SHT substrate, in PyTorch:
# config-driven ``nn.Module``s (explicit dtypes and device), sharding spec
# trees built beside each parameter tree.  The dense decoder family is
# ported; MoE, MLA, SSM/hybrid and encoder-decoder wait for ROADMAP 12c.
