"""Multi-host training: the chunk-synchronized fleet over tcp.

Counterpart of ``photon_ml_tpu/parallel/__init__.py``, with what the
tcp fleet brings (``parallel.fleet``).  The meshes, the distributed
objective and the psum transport are ROADMAP A7b.
"""

from photon_ml_torch.parallel.fleet import (
    EMPTY_CHUNK,
    FleetBarrierError,
    FleetContext,
    FleetReducer,
    ReduceCoordinator,
    host_dir,
    shard_chunk_ids,
)

__all__ = [
    "EMPTY_CHUNK",
    "FleetBarrierError",
    "FleetContext",
    "FleetReducer",
    "ReduceCoordinator",
    "host_dir",
    "shard_chunk_ids",
]
