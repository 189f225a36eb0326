"""Command-line tools of the port (run with ``python -m tfswa_tpu_torch.tools.<name>``)."""
