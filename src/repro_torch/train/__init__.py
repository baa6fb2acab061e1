"""Training substrate: checkpointing (``train.checkpoint``), the trainers
and gradient compression.

``gnn_trainer.run`` is the single-trainer (P=1) entry point over one
``worker.TrainerWorker``; ``cluster.run_cluster`` drives P workers
concurrently over one shared requester-aware fabric.
"""
from repro_torch.train.cluster import (
    ClusterConfig,
    ClusterReport,
    build_cluster_traces,
    run_cluster,
)
from repro_torch.train.worker import TrainerWorker, worker_rngs

__all__ = [
    "ClusterConfig",
    "ClusterReport",
    "TrainerWorker",
    "build_cluster_traces",
    "run_cluster",
    "worker_rngs",
]
