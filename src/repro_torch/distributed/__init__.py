"""repro_torch.distributed — checkpoints (``CheckpointManager``), fault
tolerance and elasticity (``fault_tolerance``, ``elastic``), the logical
sharding context (``sharding_ctx``) and the ranks of a mesh
(``ranks``: ``init_group``, ``spawn_ranks``)."""

from .checkpoint import CheckpointManager
from .elastic import (ElasticController, make_elastic_mesh, plan_mesh,
                      resharding_specs)
from .fault_tolerance import (HeartbeatMonitor, HostClock, HotSparePool,
                              RestartLoop, StragglerPolicy)
from .sharding_ctx import ShardingCtx, constrain, use_sharding_ctx

__all__ = ["CheckpointManager", "ElasticController", "make_elastic_mesh",
           "plan_mesh", "resharding_specs", "HeartbeatMonitor", "HostClock",
           "HotSparePool", "RestartLoop", "StragglerPolicy", "ShardingCtx",
           "constrain", "use_sharding_ctx"]
