"""Command-line entry points of the port (``python -m
pevit_tpu_torch.commands.<name>``)."""
