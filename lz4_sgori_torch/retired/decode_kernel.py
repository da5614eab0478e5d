"""T2, the retired scalar LZ4 block decoder: CUDA kernel wrapper and
plain version.

``decompress_blocks_retired`` launches ``csrc/retired_decode.cu`` (the
port of ``tools/retired/decode_kernel.py:_decode_kernel``) for a CUDA
tensor and runs ``decompress_blocks_retired_plain`` for a CPU tensor.

Contract: that kernel's ``(out uint8 [B, out_size], out_len int32 [B],
err bool [B])``, error rows included. ``err`` and ``out_len`` are
``golden.decompress``'s (``out_len`` 0 on error), as K1's are, but an
error row keeps the bytes the walk wrote before the fault, where K1
zeroes it; see ``_decode_row`` and the CUDA source for the rules.
``out_size`` is at most 64 KiB, the retired kernel's bound.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import format as F
from ..ops.kernels import _build
from ..ops.kernels.lockstep_v7 import check_decode_args, launch_decode

launches = 0
# every position and LSIC sum of the walk stays an int below 2^31
MAX_SLOT = 1 << 23


def load_kernel():
    """Build (once) and load csrc/retired_decode.cu."""
    return _build.load("retired_decode", {"lz4t_retired_decode": "pppppiiip"})


def decompress_blocks_retired(comp: torch.Tensor, comp_len: torch.Tensor,
                              out_size: int):
    """Decode a batch of LZ4 blocks with the retired scalar decoder (T2)."""
    global launches
    check_decode_args(comp, comp_len, out_size)
    if out_size > F.RETIRED_MAX_BLOCK:
        raise ValueError(f"out_size above {F.RETIRED_MAX_BLOCK} (the retired "
                         f"decoder's bound): {out_size}")
    if comp.shape[1] > MAX_SLOT:
        raise ValueError(f"slot above {MAX_SLOT} bytes: {comp.shape[1]}")
    if comp.device.type == "cpu":
        return decompress_blocks_retired_plain(comp, comp_len, out_size)
    res = launch_decode(load_kernel().lz4t_retired_decode, comp, comp_len,
                        out_size)
    launches += 1
    return res


def _lsic(c: bytes, ip: int, length: int):
    """Adds bytes from ip while they are 255; past the row they read 0."""
    while True:
        b = c[ip] if ip < len(c) else 0
        ip += 1
        length += b
        if b != 255:
            return ip, length


def _decode_row(c: bytes, clen: int, n: int):
    """One row of the retired kernel: ``(bytes of the row, out_len,
    err)``. ``c`` is the whole slot; bytes past it read as 0."""
    out = bytearray(n + 4)

    def take(ip: int, k: int) -> bytes:
        seg = c[ip:ip + k]
        return seg + bytes(k - len(seg))

    ip = op = 0
    done = err = clen == 0
    while not done and not err and ip < clen:
        token = c[ip] if ip < len(c) else 0
        ip += 1
        lit = token >> F.ML_BITS
        if lit == F.RUN_MASK:
            ip, lit = _lsic(c, ip, lit)
        err = ip + lit > clen or op + lit > n
        lit_s = min(lit, clen - ip, n - op)
        if lit_s >= 0:
            out[op:op + lit_s] = take(ip, lit_s)
        else:
            # an LSIC run read past clen: the TPU's masked tail copy takes a
            # negative byte count, whose mask is all ones (a shift by a
            # negative count gives 0), so the 4 bytes at ip land at op
            out[op:op + 4] = take(ip, 4)
        ip += lit_s
        op += lit_s
        done = ip == clen
        if done:
            break
        off = take(ip, 2)
        off = off[0] | off[1] << 8
        ip += 2
        ml = token & F.ML_MASK
        if ml == F.ML_MASK:
            ip, ml = _lsic(c, ip, ml)
        ml += F.MINMATCH
        err = err or off == 0 or off > op or ip > clen or op + ml > n
        if not err:
            if off >= ml:
                out[op:op + ml] = out[op - off:op - off + ml]
            else:
                out[op:op + ml] = (out[op - off:op] * (ml // off + 1))[:ml]
        op += ml
    err = err or not done
    return bytes(out[:n]), (0 if err else op), err


def decompress_blocks_retired_plain(comp: torch.Tensor, comp_len: torch.Tensor,
                                    out_size: int):
    """Plain version: the retired kernel's walk, one row at a time in
    Python (on the input's device)."""
    rows = comp.cpu().numpy()
    lens = comp_len.tolist()
    out = np.zeros((len(lens), out_size), np.uint8)
    out_len = np.zeros(len(lens), np.int32)
    err = np.zeros(len(lens), bool)
    for j, cl in enumerate(lens):
        o, out_len[j], err[j] = _decode_row(rows[j].tobytes(), cl, out_size)
        out[j] = np.frombuffer(o, np.uint8)
    return tuple(torch.from_numpy(a).to(comp.device)
                 for a in (out, out_len, err))
