"""Multi-device inference and training: meshes of devices, process
groups, object collectives, the slice-parallel engine and z-sharded
multi-process orthoplane inference. ``replicate`` and ``shard_batch``
do what the JAX package's ``replicated_sharding`` and
``batch_sharding`` specs do under its jit."""

from empanada_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    initialize_distributed,
    replicate,
    shard_batch,
)

__all__ = ["Mesh", "create_mesh", "initialize_distributed", "replicate",
           "shard_batch"]
