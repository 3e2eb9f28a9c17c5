"""Scripts that drive the port on the card (``python -m distmlip_tpu_torch.tools.<name>``)."""
