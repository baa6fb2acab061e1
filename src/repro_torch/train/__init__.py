"""Training substrate: the P=1 trainer (``gnn_trainer.run``) over one
``worker.TrainerWorker`` with the measured compute lane."""
