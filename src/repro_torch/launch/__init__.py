"""Launch layer of the port: the serving CLI (``python -m
repro_torch.launch.serve``)."""
