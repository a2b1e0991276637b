"""Step builders and launchers: ``python -m repro_torch.launch.serve``."""
