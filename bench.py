"""Headline benchmark: prints ONE JSON line.

Headline: SpMV throughput in Gnnz/s of ``A @ x`` through ``SparseMatrix``
on a random 200,000 x 100,000 matrix with density 0.0005 (10M nnz, 50
nnz/row), float32, on one GPU.  The time is the median of 20 calls, each
finished with ``block_until_ready``, after a warm-up call.  The result is
checked against the CPU gold first; a wrong result exits non-zero.

vs_baseline is the speedup over the reference hardware's bandwidth ceiling:
the ZCU102's HP ports move ~10 GB/s and its packed stream costs ~10 B/nnz
for f32 (util.h:61, README.md:61-63) => ~1.0 Gnnz/s.  The reference
publishes no measured numbers (BASELINE.md), so its roofline is the
fairest stand-in.

Without a GPU the script fails: there is no CPU fallback.
"""

import json
import sys

import numpy as np

REFERENCE_CEILING_GNNZ_S = 1.0  # ZCU102 HP ports ~10 GB/s / ~10 B per nnz


def main() -> int:
    from sparsetpu.utils.runtime import (gpu_name_and_power_limit,
                                         init_runtime, require_gpu)
    init_runtime()
    dev = require_gpu()
    import jax
    from sparsetpu.api.api import SparseMatrix
    from sparsetpu.bench.harness import median_call_s, peak_hbm_bytes_s
    from sparsetpu.formats.gold import (default_tolerance, spmv_gold,
                                        verification)
    from sparsetpu.formats.random import random_csr

    m = random_csr(200_000, 100_000, density=0.0005, seed=1,
                   dtype=np.float32)
    sm = SparseMatrix(m)
    x = sm.prepare_x(np.random.default_rng(0).standard_normal(m.nr_cols))
    y = np.asarray(jax.block_until_ready(sm.spmv(x)))
    atol, rtol = default_tolerance(np.float32, m.row_nnz())
    errors = verification(spmv_gold(m, np.asarray(x)), y, atol, rtol)
    if errors or y.dtype != np.float32:
        print(f"verification failed: {errors} errors, dtype {y.dtype}",
              file=sys.stderr)
        return 1
    t = median_call_s(sm.spmv, x, repeats=20)
    gnnz = m.nr_nzeros / t / 1e9
    moved = sm.spmv_bytes()
    print(json.dumps({
        "metric": "spmv_throughput",
        "value": gnnz,
        "unit": "Gnnz/s",
        "vs_baseline": gnnz / REFERENCE_CEILING_GNNZ_S,
        "spmv_ms": t * 1e3,
        "bytes_per_nnz": moved / m.nr_nzeros,
        "roofline_frac": moved / peak_hbm_bytes_s(dev) / t,
        "route": sm.route,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": gpu_name_and_power_limit(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
