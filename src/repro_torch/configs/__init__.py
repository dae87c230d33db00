# The port's copy of the reference's configurations: one module per
# architecture (public-literature configs), the SHT configuration and the
# --arch registry.  Plain dataclasses, equal field for field to
# ``repro.configs`` (tests/test_torch_configs.py).
