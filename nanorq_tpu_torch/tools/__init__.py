"""Measurement tools of the port (`python -m nanorq_tpu_torch.tools.<name>`)."""
