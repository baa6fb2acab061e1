"""Launchers: ``python -m repro_torch.launch.serve --arch <id>``; the card
peaks that price roofline terms (``launch.roofline``)."""
