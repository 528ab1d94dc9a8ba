"""Command-line entry points (``python -m can_tpu_torch.cli.serve``)."""
