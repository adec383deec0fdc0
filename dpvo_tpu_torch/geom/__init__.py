"""See the package docstring of dpvo_tpu_torch."""
