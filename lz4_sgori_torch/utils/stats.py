"""Request statistics — the analog of the reference's stats subsystem.

The port's own copy of ``lz4_sgori_tpu/utils/stats.py``.

The reference keeps 4 atomic64 counters per direction (reqs_total,
reqs_failed, vec_count, data_in_bytes; lz4e_bdev/include/lz4e_stats.h:17-22),
exposed as formatted sysfs text and resettable (lz4e_bdev/lz4e_stats.c:39-59,
lz4e_bdev/include/lz4e_static.h:41-58). Here the same counters live in a
small dataclass; `vec_count` becomes `block_count` (the dense analog of
bio_vec segments is blocks).
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class DirectionStats:
    reqs_total: int = 0
    reqs_failed: int = 0
    block_count: int = 0
    data_bytes: int = 0

    def update(self, ok: bool, blocks: int, nbytes: int) -> None:
        # Mirrors lz4e_stats_update: failed requests are counted but their
        # blocks/bytes are not (lz4e_bdev/lz4e_stats.c:39-52).
        self.reqs_total += 1
        if not ok:
            self.reqs_failed += 1
            return
        self.block_count += blocks
        self.data_bytes += nbytes

    def reset(self) -> None:
        self.reqs_total = self.reqs_failed = 0
        self.block_count = self.data_bytes = 0


class Stats:
    """Thread-safe read/write stats with the reference's text format."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.read = DirectionStats()
        self.write = DirectionStats()
        # Count of blocks re-encoded by the exact golden fallback after a
        # decode-verify failure (see blocks.compress_to_blocks). The
        # reference has no equivalent because its encoder is deterministic
        # scalar code; here it is the observability hook for the encoder's
        # probabilistically-exact match-length search.
        self.encode_fallbacks = 0

    def record_fallback(self) -> None:
        with self._lock:
            self.encode_fallbacks += 1

    def update(self, *, is_write: bool, ok: bool, blocks: int, nbytes: int) -> None:
        with self._lock:
            (self.write if is_write else self.read).update(ok, blocks, nbytes)

    def reset(self) -> None:
        with self._lock:
            self.read.reset()
            self.write.reset()

    def render(self) -> str:
        """Formatted text, analog of the sysfs `stats` param output
        (lz4e_bdev/include/lz4e_static.h:41-58)."""
        with self._lock:
            lines = []
            for name, d in (("read", self.read), ("write", self.write)):
                lines.append(f"{name} stats:")
                lines.append(f"\treqs_total: {d.reqs_total}")
                lines.append(f"\treqs_failed: {d.reqs_failed}")
                lines.append(f"\tblock_count: {d.block_count}")
                lines.append(f"\tdata_bytes: {d.data_bytes}")
            return "\n".join(lines) + "\n"

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "read": dataclasses.asdict(self.read),
                "write": dataclasses.asdict(self.write),
            }
