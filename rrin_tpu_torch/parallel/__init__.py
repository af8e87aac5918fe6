"""Scale-out over several devices: a mesh with a ``data`` axis (frame-pair
batches, and training batches, cut over devices: each device runs the
one-device program on its shard) and an optional ``spatial`` axis (the
height of one frame cut over devices, ``parallel.spatial``).

The JAX package leaves the communication to XLA; here it is explicit and
small: shards are copied to their devices before any work is launched, the
results are gathered on the mesh's first device, a spatial shard takes its
conv halos from its neighbours, and training sums its gradients through the
copies of the params (``rrin_tpu_torch.train``).
"""

from rrin_tpu_torch.parallel.sharding import (
    batch_sharding,
    make_mesh,
    replicate,
    replicate_params,
    shard_pairs,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicate",
    "replicate_params",
    "shard_pairs",
]
