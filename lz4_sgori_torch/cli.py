"""Admin and codec CLI of the PyTorch port (``lz4j``).

Port of ``lz4_sgori_tpu/cli.py``, the userspace analog of the reference's
sysfs surface (map, unmap, info, stats [--reset]) plus compress,
decompress and the fio-style ``verify`` sweep, with the same subcommands
and defaults. ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions), before or after the subcommand, takes the place of the
JAX CLI's ``--platform``.

    python -m lz4_sgori_torch.cli verify FILE --block-sizes 4 8 64 96 \
        --device cuda

The default ``verify`` sweep is the fio envelope, 4 KiB-4 MiB; every
size of it runs on the port's kernels, and ``compress --match-depth 3``
or ``5`` runs the deep modes, and ``LZ4J_ENC_MLEN=1`` the mlen mode where
it applies. Every engine of the routing table, ``xla`` included, runs
in the port. A malformed container, a bad size or an I/O fault ends with
a ``lz4j: error: ...`` line and exit code 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

from . import blocks
from . import store as S


def _cmd_map(args) -> int:
    st = S.map_store(args.backing, chunk_size=args.chunk_size,
                     capacity=args.capacity, compressed=args.compressed,
                     device=args.device)
    print(st.info())
    return 0


def _cmd_unmap(_args) -> int:
    S.unmap_store()
    print("unmapped")
    return 0


def _cmd_info(_args) -> int:
    print(S.get_store().info())
    return 0


def _cmd_stats(args) -> int:
    if args.reset:
        S.stats_reset()
    print(S.stats_text(), end="")
    return 0


def _cmd_compress(args) -> int:
    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    container = blocks.compress(data, args.block_size,
                                verify=not args.no_verify,
                                acceleration=args.acceleration,
                                match_depth=args.match_depth,
                                device=args.device)
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(container)
    ratio = len(data) / max(1, len(container))
    print(f"{len(data)} -> {len(container)} bytes "
          f"(ratio {ratio:.3f}, {len(data) / dt / 1e9:.3f} GB/s incl. host)")
    return 0


def _cmd_decompress(args) -> int:
    with open(args.input, "rb") as f:
        container = f.read()
    t0 = time.perf_counter()
    data = blocks.decompress(container, device=args.device)
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"{len(container)} -> {len(data)} bytes "
          f"({len(data) / dt / 1e9:.3f} GB/s incl. host)")
    return 0


def _cmd_verify(args) -> int:
    """Round-trip sweep across block sizes with sha256 verification (the
    fio suite's verify=sha256 over bs=4k..4m)."""
    with open(args.input, "rb") as f:
        data = f.read()
    ref = hashlib.sha256(data).hexdigest()
    results = []
    for bs_kib in args.block_sizes:
        bs = bs_kib * 1024
        container = blocks.compress(data, bs, verify=True, device=args.device)
        out = blocks.decompress(container, device=args.device)
        ok = hashlib.sha256(out).hexdigest() == ref
        results.append({"block_size": bs, "ok": ok,
                        "compressed": len(container)})
        print(f"bs={bs_kib}k: {'ok' if ok else 'FAIL'} "
              f"({len(container)} bytes)")
        if not ok:
            return 1
    if args.json:
        print(json.dumps(results))
    return 0


def main(argv=None) -> int:
    device_help = ("torch device: 'cuda' (the CUDA kernels) or 'cpu' "
                   "(their plain PyTorch versions)")
    p = argparse.ArgumentParser(prog="lz4j", description=__doc__)
    p.add_argument("--device", default="cuda", metavar="D", help=device_help)
    # --device is also accepted after the subcommand
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default=argparse.SUPPRESS, metavar="D",
                     help=device_help)
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("map", help="map a backing file as the store",
                       parents=[dev])
    m.add_argument("backing")
    m.add_argument("--chunk-size", type=int, default=4096)
    m.add_argument("--capacity", type=int, default=None)
    m.add_argument("--compressed", action="store_true",
                   help="store compressed chunks instead of proxy-verify")
    m.set_defaults(fn=_cmd_map)

    sub.add_parser("unmap", help="tear down the store",
                   parents=[dev]).set_defaults(fn=_cmd_unmap)
    sub.add_parser("info", help="describe the mapped store",
                   parents=[dev]).set_defaults(fn=_cmd_info)

    st = sub.add_parser("stats", help="print (and optionally reset) stats",
                        parents=[dev])
    st.add_argument("--reset", action="store_true")
    st.set_defaults(fn=_cmd_stats)

    c = sub.add_parser("compress", help="compress a file to a container",
                       parents=[dev])
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--block-size", type=int,
                   default=blocks.DEFAULT_BLOCK_SIZE)
    c.add_argument("--no-verify", action="store_true")
    c.add_argument("--acceleration", type=int, default=1,
                   help="LZ4_compress_fast-style speed/ratio knob (>=1)")
    c.add_argument("--match-depth", type=int, default=None,
                   help="1 = greedy level-1; >1 = deep-match engine; "
                        "default: engine-appropriate")
    c.set_defaults(fn=_cmd_compress)

    d = sub.add_parser("decompress", help="decompress a container to a file",
                       parents=[dev])
    d.add_argument("input")
    d.add_argument("output")
    d.set_defaults(fn=_cmd_decompress)

    v = sub.add_parser("verify", help="round-trip sweep with sha256 verify",
                       parents=[dev])
    v.add_argument("input")
    v.add_argument("--block-sizes", type=int, nargs="+",
                   default=[4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                            4096],
                   help="block sizes in KiB (the full fio sweep envelope, "
                        "test_4k.fio..test_4m.fio)")
    v.add_argument("--json", action="store_true")
    v.set_defaults(fn=_cmd_verify)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, OSError, NotImplementedError) as e:
        # a clean error surface (malformed container, bad sizes, io, a
        # request the routing refuses); unexpected exceptions still
        # traceback
        print(f"lz4j: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
