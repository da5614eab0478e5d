"""Block-data-parallel sharding and collectives on ``torch.distributed``.

Port of ``lz4_sgori_tpu/parallel``. Every chunk compresses independently
with its own hash table and output slot (lz4e_bdev/lz4e_req.c:154-177),
so blocks shard over the ranks of a process group (``mesh.Mesh``), one
rank a card: per-shard sizes and payloads are all-gathered in rank order,
stats are all-reduced, and outputs keep the original block order.
"""

from .mesh import make_mesh  # noqa: F401
from .dist import (compress_blocks_sharded, decompress_blocks_sharded,  # noqa: F401
                   write_pipeline_sharded, initialize_multihost, stats_totals)
