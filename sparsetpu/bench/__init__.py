"""Benchmark protocol (the reference main.cpp run report, extended).

``python -m sparsetpu.bench.suite`` and ``python -m sparsetpu.bench.scaling``
are the commands; both measure a GPU and fail without one."""

from .harness import (PEAK_HBM_BYTES_S, BenchResult, bench_spmv,
                      median_call_s, peak_hbm_bytes_s)

__all__ = ["PEAK_HBM_BYTES_S", "BenchResult", "bench_spmv",
           "median_call_s", "peak_hbm_bytes_s"]
