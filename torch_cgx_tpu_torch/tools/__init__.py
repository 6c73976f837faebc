"""Command-line tools of the port (``python -m torch_cgx_tpu_torch.tools.<name>``)."""
