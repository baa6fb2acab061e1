"""Launchers: ``python -m repro_torch.launch.train --arch <id>`` and
``python -m repro_torch.launch.serve --arch <id>``; the cells
(``launch.cell``), the one-card FLOP, byte and memory counter
(``launch.count``) and the dry-run over every cell (``python -m
repro_torch.launch.dryrun``); the card peaks that price roofline terms
(``launch.roofline``) and the device-free production meshes
(``launch.mesh``)."""
