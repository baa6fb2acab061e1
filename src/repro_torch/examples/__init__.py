"""The reference's four examples on the port, one module each:
``quickstart``, ``serve_lm``, ``train_distributed_gnn`` and
``congestion_adaptation_demo`` (``python -m repro_torch.examples.<name>``).
Each takes ``--device`` (default ``cuda``) and raises where there is no
card."""
