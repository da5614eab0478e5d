"""lz4_sgori_torch — the PyTorch and CUDA port of ``lz4_sgori_tpu``.

The JAX package beside it is the reference. This package imports
``torch`` and nothing of ``jax`` or the JAX package: it keeps its own
copies of the backend-neutral modules (``format``, ``golden``,
``native``, ``utils``, and the container of ``blocks``), under the same
names.

Layer map (top-down):

- ``cli`` / ``store``        — the lz4j CLI, ProxyStore and CompressedStore
- ``parallel``               — block-sharded encode, decode, write pipeline
  (verify and all-reduced stats) and ordered assembly over the ranks of a
  ``torch.distributed`` process group; not imported with the package
- ``blocks``                 — framing, write verify, container
- ``routing``                — the engine table (kernel column)
- ``ops.encode`` / ``ops.decode`` — batched device encode and decode; the
  ``xla`` engine (``impl="xla"``, the portable and exhaustive max-ratio
  mode) is PyTorch tensor ops here, with no kernel of its own
- ``ops.seg`` / ``ops.enc3`` — the seg, seg_big and enc3 engines' glue
  between kernels
- ``ops.kernels``            — one wrapper + plain version per CUDA kernel
- ``csrc``                   — the CUDA C++ kernels for sm_90a
- ``format`` / ``golden`` / ``native`` / ``utils`` — format constants, the
  scalar oracle, the C++ host codec, stats, the liblz4 oracle, and
  ``utils.logging`` (leveled logging from ``LZ4J_LOG``, a
  ``torch.profiler`` trace scope)
- ``config``                 — ``CodecConfig``, the codec's knobs
"""

from . import blocks, routing  # noqa: F401
from .blocks import compress, decompress, from_device, to_device  # noqa: F401

__version__ = "0.1.0"

__all__ = ["blocks", "routing", "compress", "decompress", "to_device",
           "from_device", "__version__"]
