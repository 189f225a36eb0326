"""Command-line interfaces: ``python -m tfswa_tpu_torch.cli.train``."""
