"""repro_torch.distributed — checkpoints (``CheckpointManager``) and the
ranks of a mesh-resident sketch (``ranks``: ``init_group``,
``spawn_ranks``)."""
