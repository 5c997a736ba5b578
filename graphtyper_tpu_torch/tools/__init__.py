"""Command-line tools of the port (python -m graphtyper_tpu_torch.tools.<name>)."""
