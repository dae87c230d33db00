"""Launch layer of the port: the serving CLI (``python -m
repro_torch.launch.serve``), the production mesh shapes (``mesh``) and the
SHT dry-run cell (``python -m repro_torch.launch.dryrun``)."""
