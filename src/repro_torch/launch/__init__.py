"""Launchers: ``python -m repro_torch.launch.train --arch <id>`` and
``python -m repro_torch.launch.serve --arch <id>``; the card peaks that
price roofline terms (``launch.roofline``)."""
