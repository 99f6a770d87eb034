"""CPU golden models and verification.

``spmv_gold`` is the semantic contract every device kernel must match
(csr.cpp:184-194: ``y[i] = sum_j values[j] * x[col_ind[j]]``), and
``verification`` is the reference's always-on differential test
(csr_hw.cpp:1571-1590: elementwise ``|sw - hw| < 1e-5`` with a NaN guard
``diff != diff``, error count, verbosity 0/1/2).

Extended with SpMM / SpGEMM / BSR golds (capability extensions) and
per-dtype tolerances (the reference hardcodes an absolute 1e-5 for f64,
which a float32 result also passes; here both dtypes get a relative
criterion).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .csr import BSRMatrix, CSRMatrix

DIFF_THRES = 1e-5  # csr_hw.cpp:1573


def spmv_gold(matrix: CSRMatrix, x: np.ndarray,
              out: Optional[np.ndarray] = None) -> np.ndarray:
    """Canonical CSR SpMV oracle (csr.cpp:184-194), vectorized."""
    x = np.asarray(x)
    if out is None:
        out = np.zeros(matrix.nr_rows, dtype=np.result_type(matrix.dtype, x.dtype))
    prod = matrix.values.astype(np.float64) * x[matrix.col_ind]
    # per-row float64 sums in row order (a global running sum would lose
    # the low digits of small rows to cancellation)
    rows = np.repeat(np.arange(matrix.nr_rows), matrix.row_nnz())
    out[...] = np.bincount(rows, weights=prod, minlength=matrix.nr_rows)
    return out


def spmm_gold(matrix: CSRMatrix, x: np.ndarray) -> np.ndarray:
    """Multi-RHS oracle: Y = A @ X with X of shape (nr_cols, k)."""
    return np.asarray(matrix.to_scipy() @ x)


def spgemm_gold(a: CSRMatrix, b: CSRMatrix) -> CSRMatrix:
    """SpGEMM oracle C = A @ B via scipy."""
    return CSRMatrix.from_scipy(a.to_scipy() @ b.to_scipy())


def bsr_spmv_gold(matrix: BSRMatrix, x: np.ndarray) -> np.ndarray:
    return spmv_gold(matrix.to_csr(), x)


def verification(y_sw: np.ndarray, y_hw: np.ndarray,
                 diff_thres: float = DIFF_THRES,
                 rel_thres: float = 0.0,
                 verbose: int = 0) -> int:
    """Differential check (csr_hw.cpp:1571-1590 semantics).

    Returns the number of mismatching elements; 0 means PASS.  An element
    fails when both the absolute diff exceeds ``diff_thres`` and the
    relative diff exceeds ``rel_thres`` (reference behaviour is
    ``rel_thres=0``), or when it is NaN (``diff != diff`` guard).
    """
    y_sw = np.asarray(y_sw, dtype=np.float64)
    y_hw = np.asarray(y_hw, dtype=np.float64)
    if y_sw.shape != y_hw.shape:
        raise ValueError(f"shape mismatch {y_sw.shape} vs {y_hw.shape}")
    diff = np.abs(y_sw - y_hw)
    denom = np.maximum(np.abs(y_sw), np.abs(y_hw))
    bad = (diff >= diff_thres) & (diff >= rel_thres * np.maximum(denom, 1e-300))
    bad |= np.isnan(diff)  # the reference's diff != diff NaN check
    errors = int(np.count_nonzero(bad))
    if verbose >= 1 and errors:
        idx = np.flatnonzero(bad)
        show = idx if verbose >= 2 else idx[:16]
        for i in show:
            print(f"  mismatch @ {i}: sw={y_sw[i]!r} hw={y_hw[i]!r} "
                  f"diff={diff[i]:.3e}")
    return errors


def default_tolerance(dtype, nnz_per_row_hint=64.0) -> tuple:
    """(abs, rel) tolerance per dtype, scaled by sqrt(nnz per row) (the
    growth of a sum of k rounding errors of random sign).  The hint may be
    an array of row lengths, which gives per-row bounds.

    A device sums a row in another order than the gold does (a GPU kernel
    splits it across threads; with atomics the order changes between
    runs), so results differ in the last bits.  float64 is computed
    natively: its bound, 1e-12 * sqrt(k), is relative and far below what
    float32 reaches, so a float32 downcast fails it.  float32 allows
    1e-5 * sqrt(k); bf16 values (8-bit mantissa) 1.5e-2 * sqrt(k).
    """
    dtype = np.dtype(dtype)
    scale = np.sqrt(np.maximum(nnz_per_row_hint, 1.0))
    if dtype == np.float64:
        return (1e-12 * scale, 1e-12 * scale)
    if dtype.itemsize == 2:          # bf16 value plane: 8-bit mantissa
        return (1.5e-2 * scale, 1.5e-2 * scale)
    return (1e-5 * scale, 1e-5 * scale)
