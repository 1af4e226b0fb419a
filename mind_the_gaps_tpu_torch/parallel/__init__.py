"""Device meshes: sharding the batch axes over the cards of a node, and
over processes, one a card (``distributed``)."""
from mind_the_gaps_tpu_torch.parallel.distributed import (
    barrier,
    broadcast_bytes,
    initialize,
    is_initialized,
    process_allgather,
    process_any,
    process_mesh,
    shutdown,
)
from mind_the_gaps_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    gather,
    pad_to_multiple,
    shard_batch,
)

__all__ = ["Mesh", "default_mesh", "shard_batch", "pad_to_multiple", "gather", "initialize", "shutdown",
           "is_initialized", "process_mesh", "process_allgather", "process_any", "broadcast_bytes", "barrier"]
