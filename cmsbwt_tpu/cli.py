"""Command-line interface, flag-compatible with the reference tool
(ref ``main.cpp:14-82``): ``cmsbwt [-p N] [-b GiB] [-r] [-o out] <inputlist>``.

The input list file has the reference path on line 1 and the collection path
on line 2. Outputs ``<out>.bwt`` or ``<out>.rl_bwt`` (with ``-r``) plus
``<out>.log``.
"""
from __future__ import annotations

import argparse
import sys
import time

from .config import UINT64_MAX, Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cmsbwt_tpu",
        description="BWT of a repetitive string collection via compressed "
                    "matching statistics against a reference (JAX "
                    "re-implementation of CMS-BWT).")
    p.add_argument("filename",
                   help="file containing the reference path (line 1) and the "
                        "collection path (line 2)")
    p.add_argument("-p", dest="prefix_length", type=int, default=UINT64_MAX,
                   help="read only a prefix of the collection file "
                        "(number of characters; default: whole file)")
    p.add_argument("-b", dest="buffer", type=int, default=2,
                   help="additional memory buffer size in GB (accepted for "
                        "reference CLI compatibility; memory here is bounded "
                        "by --block-chars instead)")
    p.add_argument("-r", dest="rle", action="store_true",
                   help="output the run-length encoded BWT")
    p.add_argument("-o", dest="outname", default="",
                   help="basename for the output files (default: input name)")
    p.add_argument("--backend",
                   choices=["auto", "host", "device", "dense", "jump",
                            ],
                   default="auto", help="compute backend (default auto)")
    p.add_argument("--lanes", type=int, default=256,
                   help="parallel MS cursors (device backend)")
    p.add_argument("--block-chars", type=int, default=None,
                   help="dense backend: stream the collection in blocks of "
                        "this many chars (bounded memory)")
    p.add_argument("--parallel", action="store_true",
                   help="fan dense blocks out over all local devices")
    p.add_argument("--merge-backend",
                   choices=["auto", "host", "device", "sharded"],
                   default="auto",
                   help="downstream merge engine (dense/jump): host "
                        "numpy/OpenMP, device sorted joins, or sharded "
                        "mesh joins (int64-safe, multi-device; default auto)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="phase-boundary checkpoint/resume directory")
    p.add_argument("--no-rle-quirk", action="store_true",
                   help="emit exact RLE(plain) instead of replicating the "
                        "reference RLE writer's multi-class residual bytes")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = Config(
        filename=args.filename,
        outname=args.outname,
        rle=args.rle,
        buffer_gib=args.buffer,
        prefix_length=args.prefix_length,
        backend=args.backend,
        lanes=args.lanes,
        dense_block_chars=args.block_chars,
        dense_parallel=args.parallel,
        merge_backend=args.merge_backend,
        checkpoint_dir=args.checkpoint_dir,
        replicate_reference_rle_quirk=not args.no_rle_quirk,
    )
    print("==== CMS-BWT (JAX)")
    print(f"Input file: {cfg.filename}")
    print(f"Output basename: {cfg.resolved_outname()}")
    print(f"Prefix length: {cfg.prefix_length}")
    print(f"Output format: {'RLE' if cfg.rle else 'FULL'}")
    t0 = time.time()
    from .engine.pipeline import compute_bwt
    out = compute_bwt(cfg)
    print(f"==== Wrote {out['out_path']} ({out['bytes']} bytes)")
    print(f"==== Time elapsed: {(time.time() - t0) * 1000:.0f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
