"""Command-line tools of the port:
``python -m fvsrn_tpu_torch.tools.<name>``."""
