"""SuiteSparse SpMV benchmark suite.

One command reproduces the reference's benchmark protocol
(/root/reference/README.md:23-29: one run per external matrix file) over
the classic SpMV set: per matrix PASS/FAIL, Gnnz/s, GFLOP/s, fraction of
the card's peak bandwidth, bytes per nonzero and pack time.

    python -m sparsetpu.bench.suite                 # whole classic set
    python -m sparsetpu.bench.suite scircuit pwtk   # a subset
    python -m sparsetpu.bench.suite --json          # machine-readable

Real matrices are fetched and cached (formats/suitesparse.py).  With
--synthetic nothing is downloaded: a pre-placed .mtx in the cache dir is
used, else a published-statistics stand-in (rows marked ``synthetic`` in
the table — they measure the engine, not the original operator).  The
command measures a GPU and fails without one.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def _structured_suite():
    """Deterministic REAL-pattern generators:
    genuine non-i.i.d. structure for air-gapped protocol runs — these
    measure the engine against the pattern CLASS of the named originals
    (clustered FEM bands, wrapped shell bands, netlist scatter), not
    synthetic i.i.d. stand-ins."""
    from ..formats.random import circuit_netlist, fem_poisson_3d, shell_3d
    import numpy as np
    return {
        "FEM-3D-poisson": lambda: fem_poisson_3d(55, dtype=np.float32),
        "shell-3d": lambda: shell_3d(64, 96, 3, dtype=np.float32),
        "netlist": lambda: circuit_netlist(170_000, dtype=np.float32),
    }


def _load(name: str, synthetic: bool):
    """(matrix, status) of a classic-suite entry; never touches the
    network when ``synthetic``."""
    from ..formats import suitesparse as ss
    if not synthetic:
        return ss.fetch(name)[0], "real"
    path = ss._find_cached_mtx(name)
    if path is not None:
        return ss.read_matrix(path), "real"
    return ss.synthetic_stand_in(name), "synthetic"


def run_suite(names: Optional[List[str]] = None,
              allow_synthetic: bool = False, verbose: bool = True):
    from ..formats.suitesparse import CLASSIC_SUITE
    from .harness import bench_spmv

    structured = _structured_suite()
    names = names or (list(CLASSIC_SUITE) + list(structured))
    rows = []
    for name in names:
        if name in structured:
            m, status = structured[name](), "structured"
        else:
            try:
                m, status = _load(name, allow_synthetic)
            except (ConnectionError, KeyError) as e:
                if verbose:
                    print(f"{name:18s} SKIP ({e})", flush=True)
                rows.append({"matrix": name, "status": "skip",
                             "reason": str(e)})
                continue
        import numpy as np
        m.values = m.values.astype(np.float32)
        from ..utils.config import SpmvConfig
        r = bench_spmv(m, name=name,
                       config=SpmvConfig(dtype=np.float32))
        rows.append({
            "matrix": name, "status": status,
            "rows": r.nr_rows, "cols": r.nr_cols, "nnz": r.nr_nzeros,
            "platform": r.platform, "device_kind": r.device_kind,
            "route": r.route, "pack_ms": r.pack_ms,
            "compile_ms": r.compile_ms, "spmv_ms": r.total_ms,
            "gnnz_s": r.gnnz_s, "gflop_s": r.gflop_s,
            "bytes_per_nnz": r.bytes_per_nnz,
            "roofline_frac": r.roofline_frac,
            "verify": "PASS" if r.verify_errors == 0 else "FAIL",
        })
        if verbose:
            roof = ("" if r.roofline_frac is None
                    else f"  {100 * r.roofline_frac:5.1f}% of peak")
            print(f"{name:18s} {r.nr_rows:9d}x{r.nr_cols:<9d} "
                  f"{r.nr_nzeros:10d}nnz  {r.gnnz_s:7.2f} Gnnz/s{roof}  "
                  f"{r.route}  "
                  f"{'PASS' if r.verify_errors == 0 else 'FAIL'}  "
                  f"[{status}]", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sparsetpu.bench.suite")
    ap.add_argument("names", nargs="*", help="matrix names (default all)")
    ap.add_argument("--synthetic", action="store_true",
                    help="download nothing: use pre-placed files, else "
                         "published-statistics stand-ins")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    from ..utils.runtime import init_runtime, require_gpu
    init_runtime()
    require_gpu()
    rows = run_suite(args.names or None, allow_synthetic=args.synthetic,
                     verbose=not args.json)
    if args.json:
        print(json.dumps(rows))
    failed = any(r.get("verify") == "FAIL" for r in rows)
    return 1 if failed else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
