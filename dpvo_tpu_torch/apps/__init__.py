"""Command-line entry points of the port (``python -m dpvo_tpu_torch.apps.<name>``)."""
