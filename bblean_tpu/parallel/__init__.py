r"""Multi-device (SPMD) clustering over ``jax.sharding`` meshes.

The device replacement for the reference's multiprocessing + files-on-disk
parallel pipeline (``bblean/multiround.py``): fingerprints stream through a
1-D data-parallel mesh in sharded windows, every device builds its own
sparse CF-forest with the batched engine (no collectives during the fit),
and ``ceil(log2(D))`` ``ppermute`` reduction rounds merge the forests with
group-granular exchange (bulk tile appends for shard-local groups,
row-level re-insertion only for cross-shard near-duplicates).
"""

from bblean_tpu.parallel.mesh import get_mesh
from bblean_tpu.parallel.sharded import (
    ShardedClusters,
    ShardedForest,
    sharded_fit,
)

__all__ = ["get_mesh", "sharded_fit", "ShardedClusters", "ShardedForest"]
