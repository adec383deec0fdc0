"""Deployment export of the port: ``torch.export`` programs of patchify and
the update operator (``export``)."""
