"""lz4_sgori_torch — the PyTorch and CUDA port of ``lz4_sgori_tpu``.

The JAX package beside it is the reference. This package imports
``torch`` and never ``jax``; it reuses the JAX package's backend-neutral
modules (``format``, ``golden``, ``native``, ``utils``, and the container
classes of ``blocks``) by import.

Layer map (top-down):

- ``cli`` / ``store``        — the lz4j CLI, ProxyStore and CompressedStore
- ``blocks``                 — framing, write verify, container
- ``routing``                — the engine table (kernel column)
- ``ops.encode`` / ``ops.decode`` — batched device encode and decode
- ``ops.seg`` / ``ops.enc3`` — the seg, seg_big and enc3 engines' glue
  between kernels
- ``ops.kernels``            — one wrapper + plain version per CUDA kernel
- ``csrc``                   — the CUDA C++ kernels for sm_90a
"""

from . import blocks, routing  # noqa: F401
from .blocks import compress, decompress, from_device, to_device  # noqa: F401

__all__ = ["blocks", "routing", "compress", "decompress", "to_device",
           "from_device"]
