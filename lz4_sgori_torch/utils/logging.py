"""Leveled logging + profiling hooks.

The reference's observability is printk macros (LZ4E_PR_ERR/INFO/DEBUG,
lz4e_bdev/include/lz4e_static.h:29-38) and nothing else. Here: standard
logging with the same three levels, the level from ``LZ4J_LOG``, plus a
``torch.profiler`` trace scope for measuring the codec on the card.
"""

from __future__ import annotations

import contextlib
import logging
import os

log = logging.getLogger("lz4_sgori_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("lz4j %(levelname).1s %(message)s"))
    log.addHandler(_h)
    log.setLevel(os.environ.get("LZ4J_LOG", "WARNING").upper())

pr_err = log.error
pr_info = log.info
pr_debug = log.debug


@contextlib.contextmanager
def profile_trace(dirname: str | os.PathLike | None):
    """``torch.profiler`` scope over CPU activity, and CUDA activity when
    a card is present, writing a Chrome trace (``trace.json``) under
    ``dirname``; no-op when dirname is falsy."""
    if not dirname:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
