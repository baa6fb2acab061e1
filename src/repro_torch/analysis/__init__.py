"""Runtime checks the port's modules arm on request (``runtime``)."""
