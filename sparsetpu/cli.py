"""CLI driver: ``python -m sparsetpu <matrix-file>``.

Reproduces the reference executable's run protocol (main.cpp:16-100):
banner with configuration -> read matrix -> random x -> timed CPU gold ->
timed repack -> device SpMV -> verification PASS/FAIL -> storage-overhead
report.  Usage matches ``./run.elf <matrix-file>`` (README.md:23-29), plus
flags replacing the reference's compile-time Makefile knobs (CU/DOUBLE,
Makefile:13-18).  It measures a GPU and fails without one.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


from .api.api import ROUTES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sparsetpu",
        description="GPU SpMV benchmark (main.cpp protocol)")
    p.add_argument("matrix", nargs="?",
                   help="matrix file (row-sorted triplet or .mtx); "
                        "omit with --random")
    p.add_argument("--random", type=str, default=None, metavar="RxCxD",
                   help="use a random matrix, e.g. 100000x100000x0.0005")
    p.add_argument("--double", action="store_true",
                   help="native float64 (DOUBLE=1, Makefile:18)")
    p.add_argument("--partitions", type=int, default=1,
                   help="row partitions (CU, Makefile:14; any >=1)")
    p.add_argument("--backend", default="auto",
                   choices=("auto",) + ROUTES,
                   help="SpMV route; auto picks the measured winner")
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--verbose", "-v", action="count", default=0)
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the benchmark "
                        "into DIR (view with tensorboard / xprof)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .utils.runtime import init_runtime, require_gpu
    init_runtime()
    require_gpu()
    from .formats.io import read_matrix
    from .formats.random import random_csr
    from .bench.harness import bench_spmv
    from .utils.config import SpmvConfig

    dtype = np.float64 if args.double else np.float32
    # banner (main.cpp:18-25)
    print(f"sparsetpu SpMV: partitions={args.partitions} "
          f"precision={'double' if args.double else 'single'} "
          f"backend={args.backend}")

    if args.random:
        r, c, d = args.random.split("x")
        matrix = random_csr(int(r), int(c), float(d), dtype=dtype, seed=0)
        name = f"random-{args.random}"
    elif args.matrix:
        matrix = read_matrix(args.matrix, dtype=dtype)
        name = args.matrix
    else:
        print("error: provide a matrix file or --random RxCxD",
              file=sys.stderr)
        return 2

    cfg = SpmvConfig(dtype=dtype, num_partitions=args.partitions)
    if args.profile:
        import jax
        with jax.profiler.trace(args.profile):
            result = bench_spmv(matrix, name=name, config=cfg,
                                repeats=args.repeats, backend=args.backend)
        print(f"profiler trace written to {args.profile}")
    else:
        result = bench_spmv(matrix, name=name, config=cfg,
                            repeats=args.repeats, backend=args.backend)
    print(result.report())
    return 0 if result.verify_errors == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
