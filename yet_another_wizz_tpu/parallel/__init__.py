"""Multi-device execution: mesh construction and sharded pair counting.

The reference scales out with an MPI task farm over patch pairs
(/root/reference/src/yaw/utils/parallel.py:38-484). The device-native
replacement shards the flat tile-pair list over a ``jax.sharding.Mesh``:
every device runs the same pair-count program on its chunk
of the list and partial count tensors are combined with ``psum``. Host
coordination (process-0 I/O, result broadcast) follows jax.distributed
conventions.
"""

from yet_another_wizz_tpu.parallel.distributed import (
    barrier,
    broadcast,
    broadcasted,
    initialize,
    num_processes,
    on_root,
    process_index,
    run_on_root,
)
from yet_another_wizz_tpu.parallel.sharded import (
    auto_mesh,
    count_pairs_sharded,
    default_mesh,
)

__all__ = [
    "auto_mesh",
    "barrier",
    "broadcast",
    "broadcasted",
    "count_pairs_sharded",
    "default_mesh",
    "initialize",
    "num_processes",
    "on_root",
    "process_index",
    "run_on_root",
]
