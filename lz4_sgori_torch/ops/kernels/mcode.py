"""K10a, the mlen mode's pass 1: verified candidates and match codes.
CUDA kernel wrapper and plain version.

``dense_mcode`` launches ``csrc/mcode.cu`` (the port of
``lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_cand_kernel`` with
``mlen_mode`` and ``mlen_hbm``, and of its payload sorts ``_sort_ref_p``
and ``_sort_ref_hbm``) for a CUDA tensor and runs ``dense_mcode_plain``
for a CPU tensor.

Both are a pointwise function of K2's candidate tape and the bytes: for
p with d = cand[p] in [1, p] and q = p - d, the candidate is kept when
read32(p) == read32(q), and its code packs the equal bytes of
[p+4, p+12) against [q+4, q+12) (lcp, up to 8) and the trailing equal
bytes of [p-4, p) against [q-4, q) (cu, up to 4); every byte outside
[0, raw_len) reads 0 on both sides. The kernel holds each block's
bytes in shared memory, zero-padded, and compares them a 32-bit word at
a time, four positions a thread. Contract: ``golden.dense_mcode``
(``lz4_sgori_tpu/golden.py:735-792``) for every row. Returns

  cand_v int32 [B, block_size]  cand with each unverified candidate 0;
  mcode  int32 [B, block_size]  more_f | lcp << 1 | more_b << 5 | cu << 6,
                                0 where cand_v is 0.
"""

from __future__ import annotations

import torch

from . import _build
from .cand import MAX_BLOCK

launches = 0
LCP_MAX = 8      # forward bytes past the verified 4 that a code holds
CU_MAX = 4       # backward bytes a code holds
ENTRIES = {"lz4t_mcode": "pppppiip"}   # the C entry


def load_kernel():
    """Build (once) and load csrc/mcode.cu."""
    return _build.load("mcode", ENTRIES)


def dense_mcode(cand: torch.Tensor, raw: torch.Tensor,
                raw_len: torch.Tensor):
    """Verified candidates and match codes of every position (K10a)."""
    global launches
    if raw.dtype != torch.uint8 or raw.dim() != 2:
        raise TypeError("raw must be uint8 [B, block_size]")
    if cand.dtype != torch.int32 or cand.shape != raw.shape:
        raise TypeError("cand must be int32 [B, block_size]")
    if raw_len.dtype != torch.int32 or raw_len.shape != raw.shape[:1]:
        raise TypeError("raw_len must be int32 [B]")
    if not (cand.device == raw.device == raw_len.device):
        raise ValueError("cand, raw and raw_len must be on one device")
    if raw.shape[1] > MAX_BLOCK:
        raise ValueError(f"the mlen mode serves blocks of at most "
                         f"{MAX_BLOCK} bytes")
    if raw.device.type == "cpu":
        return dense_mcode_plain(cand, raw, raw_len)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    cand, raw, raw_len = cand.contiguous(), raw.contiguous(), \
        raw_len.contiguous()
    nb, bs = raw.shape
    cand_v = torch.empty_like(cand)
    mcode = torch.empty_like(cand)
    lib = load_kernel()
    _build.check(lib.lz4t_mcode(
        cand.data_ptr(), raw.data_ptr(), raw_len.data_ptr(),
        cand_v.data_ptr(), mcode.data_ptr(), nb, bs,
        _build.stream(raw.device)), "mcode")
    launches += 1
    return cand_v, mcode


def dense_mcode_plain(cand: torch.Tensor, raw: torch.Tensor,
                      raw_len: torch.Tensor):
    """Plain PyTorch K10a: the sixteen byte pairs at p + k and q + k,
    k in [-4, 12), by gathers over a zero-padded int64 copy of the
    bytes (golden's ``bytes(4) + src + bytes(12)``)."""
    nb, bs = raw.shape
    dev = raw.device
    i64 = torch.int64
    pos = torch.arange(bs, dtype=i64, device=dev)[None, :]
    live = pos < raw_len.to(i64).clamp(0, bs)[:, None]
    lo, hi = CU_MAX, 4 + LCP_MAX
    b = torch.nn.functional.pad(torch.where(live, raw.to(i64), 0), (lo, hi))
    d = cand.to(i64)
    ok = (d > 0) & (d <= pos)
    q = torch.where(ok, pos - d, 0)
    eq = {k: b[:, lo + k:lo + k + bs] == torch.gather(b, 1, q + lo + k)
          for k in range(-CU_MAX, hi)}
    ok &= eq[0] & eq[1] & eq[2] & eq[3]
    lcp = torch.zeros_like(d)
    run = torch.ones_like(ok)
    for k in range(4, hi):
        run &= eq[k]
        lcp += run
    cu = torch.zeros_like(d)
    run = torch.ones_like(ok)
    for k in range(-1, -CU_MAX - 1, -1):
        run &= eq[k]
        cu += run
    code = ((lcp == LCP_MAX).to(i64) | (lcp << 1)
            | ((cu == CU_MAX).to(i64) << 5) | (cu << 6))
    return (torch.where(ok, d, 0).to(torch.int32),
            torch.where(ok, code, 0).to(torch.int32))
