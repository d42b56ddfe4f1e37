"""Distribution: device meshes, sharded batches, the distributed
objective, and the multi-host training fleet.

Counterpart of ``photon_ml_tpu/parallel/__init__.py``: the meshes and
the distributed objective (``parallel.mesh``,
``parallel.distributed_objective``), plus what the fleet brings
(``parallel.fleet``: the chunk-synchronized fleet over tcp or a
``torch.distributed`` all-reduce).
"""

from photon_ml_torch.parallel.distributed_objective import (
    DistributedGLMObjective,
)
from photon_ml_torch.parallel.fleet import (
    EMPTY_CHUNK,
    FleetBarrierError,
    FleetContext,
    FleetReducer,
    ReduceCoordinator,
    host_dir,
    shard_chunk_ids,
)
from photon_ml_torch.parallel.mesh import (
    DATA_AXIS,
    ENTITY_AXIS,
    batch_spec,
    data_parallel_mesh,
    padded_rows,
    replicate,
    shard_batch,
    shard_sparse_batch,
)

__all__ = [
    "DistributedGLMObjective",
    "DATA_AXIS",
    "ENTITY_AXIS",
    "batch_spec",
    "data_parallel_mesh",
    "padded_rows",
    "replicate",
    "shard_batch",
    "shard_sparse_batch",
    "EMPTY_CHUNK",
    "FleetBarrierError",
    "FleetContext",
    "FleetReducer",
    "ReduceCoordinator",
    "host_dir",
    "shard_chunk_ids",
]
