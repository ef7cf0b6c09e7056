"""Scale-out over a device mesh, on torch tensors (the counterpart of
directxtex_tpu/parallel).

The workload is data parallel over images and blocks: a batch is split
over a 1-D mesh of devices and each shard is encoded on its own device
with no communication; only the MSE adds partial sums across shards.
`spatial` splits one image's rows and passes filter-tap halo rows between
neighbouring shards; `library` loads a folder in threads and encodes each
shard's images in one encoder call.

A mesh is held by one process, as JAX's single-controller mesh is, and a
device may repeat in it (`make_mesh(("cuda:0",) * 4)`), so the sharded
code runs with real shards on one card. Its `__all__` is the JAX
package's.
"""

from .sharding import (
    batch_sharding, make_mesh, replicated, shard_batch, sharded_compress_fn,
    sharded_mse,
)
from .spatial import (
    halo_exchange_rows, rows_sharding, sharded_box_mip, sharded_normal_map,
)
from .library import compress_library, compress_library_fn, load_library

__all__ = ["batch_sharding", "make_mesh", "replicated", "shard_batch",
           "sharded_compress_fn", "sharded_mse",
           "halo_exchange_rows", "rows_sharding", "sharded_box_mip",
           "sharded_normal_map",
           "compress_library", "compress_library_fn", "load_library"]
