"""Batched device codec ops of the PyTorch port."""

from .decode import decompress_blocks_device  # noqa: F401
from .encode import compress_blocks_device  # noqa: F401
