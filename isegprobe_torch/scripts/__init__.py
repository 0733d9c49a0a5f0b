"""Command-line entry points of the port (``python -m
isegprobe_torch.scripts.<name>``)."""
