"""Tools of the port (``python -m fcvsr_tpu_torch.tools.<name>``)."""
