"""Device meshes: sharding the batch axes over the cards of a node."""
from mind_the_gaps_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    gather,
    pad_to_multiple,
    shard_batch,
)

__all__ = ["Mesh", "default_mesh", "shard_batch", "pad_to_multiple", "gather"]
