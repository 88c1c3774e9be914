"""repro_torch.distributed — checkpoints (``CheckpointManager``)."""
