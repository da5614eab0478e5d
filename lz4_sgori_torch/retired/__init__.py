"""The retired round-1 engines of ``tools/retired/`` (T1-T3): the greedy
``LZ4_compress_default`` encoder, the scalar decoder and the chained
decoder, each a CUDA kernel with a plain version beside it. The JAX
package routes none of them, so the port's routing does not either;
call them directly. T1 gives liblz4's bytes on the card for blocks of
64 KiB or less."""

from .decode_kernel import decompress_blocks_retired
from .encode_kernel import compress_blocks_retired
from .lockstep_v9 import decompress_blocks_lockstep_v9

__all__ = ["compress_blocks_retired", "decompress_blocks_retired",
           "decompress_blocks_lockstep_v9"]
