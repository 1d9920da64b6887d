"""Command-line tools of the port, run as `python -m deepfepe_tpu_torch.tools.<name>`."""
