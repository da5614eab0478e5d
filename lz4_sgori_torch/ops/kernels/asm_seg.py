"""K4, segment assembly: CUDA kernel wrapper and plain version.

``assemble_segments`` launches ``csrc/asm_seg.cu`` (the port of
``lz4_sgori_tpu/ops/pallas/asm_seg.py:_asm_kernel``) for a CUDA tensor
and runs ``assemble_segments_plain`` for a CPU tensor. The kernel writes
each row in 16-byte words, a CTA an 8 KiB chunk of a row, each word's
bytes gathered from the piece or pieces it covers (zeros past the
length).

Contract (``golden.assemble_seg_parts``): block b's output is, for each
segment k in order, ``streams[b*nseg+k, :slen] + hdr[b*nseg+k, :hlen] +
raw[b, tail : tail + tl]`` with ``plan[b, k] = (slen, hlen, tail, tl)``.
Returns ``out uint8 [nb, ocap]`` (zero at and past the length) and the
total length ``out_len int32 [nb]``, which may exceed ``ocap``: the bytes
past ``ocap`` are then dropped and the caller treats the block as failed.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0
ENTRIES = {"lz4t_asm_seg": "ppppppiiiiiip"}   # the C entry's signature
MAX_SEG = 128


def load_kernel():
    """Build (once) and load csrc/asm_seg.cu."""
    return _build.load("asm_seg", ENTRIES)


def assemble_segments(streams: torch.Tensor, hdr: torch.Tensor,
                      raw: torch.Tensor, plan: torch.Tensor, ocap: int):
    """Concatenate each block's pieces into one LZ4 block (K4)."""
    global launches
    for name, t in (("streams", streams), ("hdr", hdr), ("raw", raw)):
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise TypeError(f"{name} must be a uint8 matrix")
    nb, bs = raw.shape
    if plan.dtype != torch.int32 or plan.dim() != 3 or plan.shape[0] != nb \
            or plan.shape[2] != 4:
        raise TypeError("plan must be int32 [nb, nseg, 4]")
    nseg = plan.shape[1]
    if streams.shape[0] != nb * nseg or hdr.shape[0] != nb * nseg:
        raise ValueError("streams and hdr need one row per segment")
    if not (streams.device == hdr.device == raw.device == plan.device):
        raise ValueError("all inputs must be on one device")
    if nseg > MAX_SEG:
        raise ValueError(f"at most {MAX_SEG} segments per block")
    if raw.device.type == "cpu":
        return assemble_segments_plain(streams, hdr, raw, plan, ocap)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    lib = load_kernel()
    streams, hdr, raw, plan = (t.contiguous()
                               for t in (streams, hdr, raw, plan))
    if plan.data_ptr() % 16:         # the kernel loads plan rows in 16 bytes
        plan = plan.clone()
    out = torch.empty((nb, ocap), dtype=torch.uint8, device=raw.device)
    out_len = torch.empty(nb, dtype=torch.int32, device=raw.device)
    _build.check(lib.lz4t_asm_seg(
        streams.data_ptr(), hdr.data_ptr(), raw.data_ptr(), plan.data_ptr(),
        out.data_ptr(), out_len.data_ptr(), nb, nseg, streams.shape[1],
        hdr.shape[1], bs, ocap, _build.stream(raw.device)), "asm_seg")
    launches += 1
    return out, out_len


def assemble_segments_plain(streams, hdr, raw, plan, ocap: int):
    """Plain PyTorch assembly: every output byte finds its piece with a
    search over the pieces' end offsets and gathers its source byte."""
    nb, bs = raw.shape
    nseg = plan.shape[1]
    dev = raw.device
    i64 = torch.int64
    p = plan.to(i64)
    lens = torch.stack([p[..., 0], p[..., 1], p[..., 3]],
                       dim=2).reshape(nb, 3 * nseg)
    ends = torch.cumsum(lens, dim=1)
    starts = ends - lens
    total = ends[:, -1]
    o = torch.arange(ocap, dtype=i64, device=dev).expand(nb, ocap)
    piece = torch.searchsorted(ends, o.contiguous(), right=True).clamp(
        max=3 * nseg - 1)
    rel = o - torch.gather(starts, 1, piece)
    kind = piece % 3
    row = torch.arange(nb, dtype=i64, device=dev)[:, None] * nseg \
        + piece // 3
    scap, hmax = streams.shape[1], hdr.shape[1]
    h_base = streams.numel()
    r_base = h_base + hdr.numel()
    tail = torch.gather(p[..., 2], 1, piece // 3)
    src_idx = torch.where(
        kind == 0, row * scap + rel,
        torch.where(kind == 1, h_base + row * hmax + rel,
                    r_base + torch.arange(nb, dtype=i64, device=dev)[:, None]
                    * bs + tail + rel))
    flat = torch.cat([streams.reshape(-1), hdr.reshape(-1),
                      raw.reshape(-1)])
    valid = o < total[:, None]
    out = torch.where(valid, flat[src_idx.clamp(0, flat.numel() - 1)], 0)
    return out.to(torch.uint8), total.to(torch.int32)
