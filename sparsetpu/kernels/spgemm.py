"""SpGEMM: C = A @ B for two sparse matrices, numeric phase on device.

Capability extension scoped by BASELINE.json ("SpMM, SpGEMM, and BSR/COO
format conversion"); the reference has no SpGEMM analogue, so per
SURVEY.md section 7 the target is "correct, format-complete", with reuse
of the packed-SpMV machinery rather than a bespoke kernel.

Design (row-merge formulation):
  * symbolic phase (host, once): compute C's sparsity pattern and expand
    the multiplication events — every (i,k,j) with A[i,k] != 0 and
    B[k,j] != 0 contributes A[i,k]*B[k,j] to C[i,j].
  * The numeric phase is then exactly an SpMV:  c = M @ b  where
      b = B.values                      (vector of length nnz(B))
      M[o, e] = A[i,k]                  (o = output-nnz index of (i,j),
                                         e = B-nnz index of (k,j))
    M is packed once as a ``SparseMatrix`` and the multiply runs on the
    device on the same SpMV route as every other product.  Re-multiplying with
    new numeric values (same structure) costs one device SpMV — the
    "repack once, execute many" contract of the reference's
    create_csr_hw_matrix / spmv_hw split (csr_hw_wrapper.cpp:193-288).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..formats.csr import CSRMatrix


def _expand_events(a: CSRMatrix, b: CSRMatrix):
    """All multiplication events: returns (ea, eb, out_idx, c_pattern)
    where ea/eb index A/B nnz, out_idx indexes C nnz, and c_pattern is
    (row_ptr, col_ind) of C."""
    deg_b = np.diff(b.row_ptr).astype(np.int64)        # nnz per B row
    acol = a.col_ind.astype(np.int64)
    # per A-event fanout = deg_b[A.col]
    fan = deg_b[acol]
    ea = np.repeat(np.arange(a.nr_nzeros, dtype=np.int64), fan)
    # eb = concat of B row ranges per A event (CSR range expansion)
    starts = b.row_ptr[acol].astype(np.int64)
    total = int(fan.sum())
    if total == 0:
        return (ea, np.zeros(0, np.int64), np.zeros(0, np.int64),
                (np.zeros(a.nr_rows + 1, np.int64),
                 np.zeros(0, np.int64)))
    first = np.repeat(starts, fan)
    run_starts = np.concatenate([[0], np.cumsum(fan)[:-1]])
    offs = np.arange(total, dtype=np.int64) - np.repeat(run_starts, fan)
    eb = first + offs

    arow = np.repeat(np.arange(a.nr_rows, dtype=np.int64),
                     np.diff(a.row_ptr).astype(np.int64))
    i = np.repeat(arow, fan)                            # C row per event
    j = b.col_ind.astype(np.int64)[eb]                  # C col per event

    # C pattern: unique (i, j)
    key = i * b.nr_cols + j
    uniq, out_idx = np.unique(key, return_inverse=True)
    c_rows = (uniq // b.nr_cols).astype(np.int64)
    c_cols = (uniq % b.nr_cols).astype(np.int64)
    c_row_ptr = np.zeros(a.nr_rows + 1, dtype=np.int64)
    np.add.at(c_row_ptr, c_rows + 1, 1)
    c_row_ptr = np.cumsum(c_row_ptr)
    return ea, eb, out_idx, (c_row_ptr, c_cols)


class SpGEMMPlan:
    """Structural plan for C = A @ B: pattern + packed event matrix.

    Reusable: ``plan(new_b_values)`` recomputes C's values on device for
    any B with the same sparsity structure (and A's values baked in; build
    a new plan if A's values change — they are the event-matrix entries).
    """

    def __init__(self, a: CSRMatrix, b: CSRMatrix):
        from ..api.api import SparseMatrix

        self.nr_rows, self.nr_cols = a.nr_rows, b.nr_cols
        self.dtype = np.result_type(a.dtype, b.dtype)
        ea, eb, out_idx, (c_row_ptr, c_cols) = _expand_events(a, b)
        self.c_row_ptr = c_row_ptr
        self.c_col_ind = c_cols.astype(np.int32)
        self.nnz_c = int(c_cols.shape[0])
        self.flops = 2 * int(ea.shape[0])
        if self.nnz_c == 0 or ea.shape[0] == 0:
            self._event_matrix = None
            return
        m = CSRMatrix.from_coo(out_idx, eb,
                               a.values[ea].astype(self.dtype),
                               self.nnz_c, b.nr_nzeros,
                               sum_duplicates=True)
        self._event_matrix = SparseMatrix(m)

    def __call__(self, b_values) -> jnp.ndarray:
        """C.values for the given B values (device numeric phase)."""
        if self._event_matrix is None:
            return jnp.zeros((self.nnz_c,), self.dtype)
        return self._event_matrix.spmv(np.asarray(b_values,
                                                  dtype=self.dtype))

    def to_csr(self, c_values) -> CSRMatrix:
        return CSRMatrix(self.c_row_ptr.astype(np.int64),
                         self.c_col_ind.astype(np.int32),
                         np.asarray(c_values, dtype=self.dtype),
                         self.nr_rows, self.nr_cols)


def spgemm(a: CSRMatrix, b: CSRMatrix) -> CSRMatrix:
    """C = A @ B with the numeric phase on device; returns CSR in the
    promoted dtype of A and B."""
    if a.nr_cols != b.nr_rows:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    plan = SpGEMMPlan(a, b)
    return plan.to_csr(np.asarray(plan(b.values)))
