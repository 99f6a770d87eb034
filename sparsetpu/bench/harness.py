"""Benchmark harness: the main.cpp measurement protocol, extended.

Reproduces the numbers the reference prints per run (SURVEY.md section 6):
  SW (gold) time           main.cpp:61-65
  repack time              main.cpp:67-72
  total SpMV time          csr_hw_wrapper.cpp:285
  data moved (MB)          csr_hw.cpp:420-421
  storage overhead         main.cpp:84-88
  verification PASS/FAIL   main.cpp:77-82
plus what the reference lacks: compile time (set-up), bytes per nonzero,
nnz/s, GFLOP/s and the share of the card's peak memory bandwidth.

An SpMV time is the median over ``repeats`` calls of ``A @ x`` each
finished with ``block_until_ready``, after a warm-up call.  The roofline
share is reported only for a GPU in ``PEAK_HBM_BYTES_S``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..formats.csr import CSRMatrix
from ..formats.gold import spmv_gold, verification, default_tolerance
from ..utils.config import SpmvConfig
from ..utils.timing import PhaseTimer

# Peak memory bandwidth by jax ``device_kind``, bytes/s.  Source: NVIDIA
# H100 Tensor Core GPU data sheet (SXM5 80 GB HBM3: 3.35 TB/s; PCIe 80 GB
# HBM2e: 2.0 TB/s), at the card's full power limit.
PEAK_HBM_BYTES_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def peak_hbm_bytes_s(device) -> Optional[float]:
    """The peak bandwidth of ``device``; None on the CPU, which has no
    roofline here.  An unknown GPU is an error, never a default."""
    if device.platform == "cpu":
        return None
    try:
        return PEAK_HBM_BYTES_S[device.device_kind]
    except KeyError:
        raise KeyError(f"no peak bandwidth recorded for {device.platform} "
                       f"device {device.device_kind!r}; add it to "
                       "PEAK_HBM_BYTES_S with its source") from None


def median_call_s(fn, *args, repeats: int = 20) -> float:
    """Median seconds of ``fn(*args)`` finished with block_until_ready,
    after one warm-up call (which compiles)."""
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


@dataclasses.dataclass
class BenchResult:
    matrix: str
    nr_rows: int
    nr_cols: int
    nr_nzeros: int
    route: str
    platform: str
    device_kind: str
    gold_ms: float
    pack_ms: float
    compile_ms: float
    total_ms: float
    data_mb: float
    bytes_per_nnz: float
    storage_overhead: float
    gnnz_s: float
    gflop_s: float
    roofline_frac: Optional[float]
    verify_errors: int

    def report(self) -> str:
        status = "PASS" if self.verify_errors == 0 else "FAIL"
        roof = ("no roofline on this platform"
                if self.roofline_frac is None
                else f"{100 * self.roofline_frac:.1f}% of peak bandwidth")
        return "\n".join([
            f"Matrix {self.matrix}: {self.nr_rows} x {self.nr_cols}, "
            f"{self.nr_nzeros} non-zeros",
            f"Device {self.platform} {self.device_kind}, route {self.route}",
            f"SW (gold) execution time {self.gold_ms:.3f} msec",
            f"Matrix repack time {self.pack_ms:.3f} msec",
            f"Compile + upload time {self.compile_ms:.3f} msec",
            f"Total SpMV time {self.total_ms:.3f} msec",
            f"Data moved {self.data_mb:.2f} MB "
            f"({self.bytes_per_nnz:.2f} B/nnz)",
            f"Storage overhead vs CSR "
            f"{100 * (self.storage_overhead - 1):+.1f}%",
            f"Throughput {self.gnnz_s:.2f} Gnnz/s, {self.gflop_s:.2f} "
            f"GFLOP/s ({roof})",
            f"Verification: {status} ({self.verify_errors} errors)",
        ])


def bench_spmv(matrix: CSRMatrix, name: str = "random",
               config: Optional[SpmvConfig] = None, repeats: int = 20,
               backend: str = "auto") -> BenchResult:
    import jax
    from ..api.api import SparseMatrix

    timer = PhaseTimer()
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 1.0, matrix.nr_cols)  # init_vector_rand, csr.cpp:170

    with timer.phase("gold"):
        y_gold = spmv_gold(matrix, x)

    cfg = config or SpmvConfig(dtype=matrix.dtype)
    with timer.phase("pack"):
        # host repack + upload (the reference's timed phase, main.cpp:67-72)
        sm = SparseMatrix(matrix, cfg, backend=backend)
        jax.block_until_ready(sm.values)
    with timer.phase("compile"):
        xp = sm.prepare_x(x)
        y = np.asarray(jax.block_until_ready(sm.spmv_packed_x(xp)))
    total_s = median_call_s(sm.spmv_packed_x, xp, repeats=repeats)

    atol, rtol = default_tolerance(sm.dtype, matrix.row_nnz())
    errors = verification(y_gold, y, diff_thres=atol, rel_thres=rtol)

    nnz = matrix.nr_nzeros
    moved = sm.spmv_bytes()
    dev = jax.devices()[0]
    peak = peak_hbm_bytes_s(dev)
    return BenchResult(
        matrix=name, nr_rows=matrix.nr_rows, nr_cols=matrix.nr_cols,
        nr_nzeros=nnz, route=sm.route, platform=dev.platform,
        device_kind=dev.device_kind,
        gold_ms=timer.ms("gold"), pack_ms=timer.ms("pack"),
        compile_ms=timer.ms("compile"), total_ms=total_s * 1e3,
        data_mb=moved / 1e6, bytes_per_nnz=moved / max(nnz, 1),
        storage_overhead=sm.storage_overhead(),
        gnnz_s=nnz / total_s / 1e9,
        gflop_s=2 * nnz / total_s / 1e9,
        roofline_frac=None if peak is None else moved / peak / total_s,
        verify_errors=errors)
