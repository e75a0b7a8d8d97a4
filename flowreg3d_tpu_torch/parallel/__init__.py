"""Parallel execution: executors over frames on one device, over a list of
devices (frames split: ``mesh``), or with each frame's pyramid Z-sharded
over a list of devices (``spatial``).

Counterpart of ``flowreg3d_tpu/parallel/__init__.py``. JAX's 1-D device
mesh is a plain list of ``torch.device``s here (``batch_devices``), driven
by one controller; a device may repeat in it.
"""

from flowreg3d_tpu_torch.parallel.executors import (
    BaseExecutor3D,
    BatchedExecutor3D,
    MeshExecutor3D,
    SequentialExecutor3D,
    SpatialExecutor3D,
    get_executor,
    list_executors,
)
from flowreg3d_tpu_torch.parallel.mesh import (batch_devices, replicate,
                                               shard_batch)

__all__ = [
    "BaseExecutor3D",
    "SequentialExecutor3D",
    "BatchedExecutor3D",
    "MeshExecutor3D",
    "SpatialExecutor3D",
    "get_executor",
    "list_executors",
    "batch_devices",
    "replicate",
    "shard_batch",
]
