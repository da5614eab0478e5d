"""Stats and the liblz4 oracle (the port's own copies)."""

from . import oracle, stats  # noqa: F401
