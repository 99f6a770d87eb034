"""Weak-scaling report: nnz/s at 1, 2, 4, ... devices.

Runs the mesh-sharded SpMV (dist/spmv_dist.py) at each device count with
constant work per device and reports throughput and efficiency against
the 1-device run.  Each time is the median of ``A @ x`` calls finished
with ``block_until_ready``.

The command measures GPUs and fails without one.  The function also runs
on a virtual CPU mesh (JAX_PLATFORMS=cpu with
--xla_force_host_platform_device_count=N), where it checks the protocol and
the collectives; its rows then carry platform "cpu" and their times are
the CPU's.

Usage:  python -m sparsetpu.bench.scaling [--rows-per-dev 50000]
        [--nnz-per-row 32] [--devices 4]
"""

from __future__ import annotations

import argparse
import json


def scaling_report(rows_per_dev: int = 50_000, nnz_per_row: int = 32,
                   max_devices: int = None, verbose: bool = True,
                   multihost: bool = False, repeats: int = 20):
    import jax
    import numpy as np
    from ..dist.spmv_dist import make_mesh, shard_spmv
    from ..formats.gold import spmv_gold, verification
    from ..formats.random import random_csr
    from .harness import median_call_s

    if multihost and jax.process_count() == 1:
        # the per-host code path itself is CPU-mesh tested in
        # tests/test_multihost.py
        print("--multihost: jax.process_count() == 1 (no cluster: start "
              "every process with sparsetpu.dist.multihost.init_multihost)."
              "  Using the single-process path over all local devices.",
              flush=True)
        multihost = False

    devs = jax.devices()
    n = len(devs) if max_devices is None else min(max_devices, len(devs))
    counts = [p for p in (1, 2, 4, 8, 16, 32) if p <= n]

    rows = []
    base = None
    for p in counts:
        r = rows_per_dev * p
        m = random_csr(r, r, density=nnz_per_row / r, seed=11,
                       dtype=np.float32)
        mesh = make_mesh(p)
        if multihost:
            from ..dist.multihost import shard_spmv_multihost
            sh = shard_spmv_multihost(m, mesh)
        else:
            sh = shard_spmv(m, mesh)
        x = np.random.default_rng(4).standard_normal(r)
        y = np.asarray(sh.spmv(x))
        errs = verification(spmv_gold(m, x), y, diff_thres=1e-3,
                            rel_thres=1e-3)
        step = jax.jit(lambda s, xi: s.spmv(xi))
        t = median_call_s(step, sh, jax.numpy.asarray(x, np.float32),
                          repeats=repeats)
        gnnz = m.nr_nzeros / t / 1e9
        if base is None:
            base = gnnz
        eff = gnnz / (base * p)
        rows.append({"devices": p, "rows": r, "nnz": m.nr_nzeros,
                     "route": sh.route, "gnnz_s": gnnz,
                     "weak_scaling_eff": eff, "verify_errors": int(errs)})
        if verbose:
            print(f"P={p:3d}  rows={r:9d}  {gnnz:8.3f} Gnnz/s  "
                  f"eff={eff:6.1%}  verify="
                  f"{'PASS' if errs == 0 else 'FAIL'}", flush=True)
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "weak_scaling": rows}


def main(argv=None) -> int:
    from ..utils.runtime import init_runtime, require_gpu
    ap = argparse.ArgumentParser(prog="sparsetpu.bench.scaling")
    ap.add_argument("--rows-per-dev", type=int, default=50_000)
    ap.add_argument("--nnz-per-row", type=int, default=32)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--multihost", action="store_true",
                    help="per-host partition path (requires a "
                         "jax.distributed cluster; see dist/multihost.py)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    init_runtime()
    require_gpu()
    rep = scaling_report(args.rows_per_dev, args.nnz_per_row, args.devices,
                         verbose=not args.json, multihost=args.multihost)
    if args.json:
        print(json.dumps(rep))
    return 0 if all(r["verify_errors"] == 0
                    for r in rep["weak_scaling"]) else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
