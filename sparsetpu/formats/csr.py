"""Host-side sparse containers: CSR / COO / BSR.

Re-design of the reference's L1 structs (csr.h:7-29:
``csr_matrix {row_ptr, col_ind, values, nr_rows, nr_cols, nr_nzeros}`` and
``csr_vector``).  These are plain NumPy containers used for ingest, the gold
oracle and the input of ``SparseMatrix``, which holds the device copy.

The reference only has CSR; COO and BSR are capability extensions scoped by
BASELINE.json ("SpMM, SpGEMM, and BSR/COO format conversion").
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

INDEX_DTYPE = np.int32  # IndexType = ap_uint<32> (util.h:9-11)


def _as_1d(a, dtype, name):
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.ndim != 1:
        raise ValueError(f"{name} must be 1-D, got shape {a.shape}")
    return a


@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse row matrix (csr.h:7-16 analogue)."""

    row_ptr: np.ndarray   # (nr_rows + 1,) int32
    col_ind: np.ndarray   # (nnz,) int32
    values: np.ndarray    # (nnz,) float32/float64
    nr_rows: int
    nr_cols: int

    def __post_init__(self):
        self.row_ptr = _as_1d(self.row_ptr, INDEX_DTYPE, "row_ptr")
        self.col_ind = _as_1d(self.col_ind, INDEX_DTYPE, "col_ind")
        self.values = np.ascontiguousarray(self.values)
        if self.values.ndim != 1:
            raise ValueError("values must be 1-D")
        if self.row_ptr.shape[0] != self.nr_rows + 1:
            raise ValueError("row_ptr must have nr_rows + 1 entries")
        if self.col_ind.shape[0] != self.values.shape[0]:
            raise ValueError("col_ind and values length mismatch")

    @property
    def nr_nzeros(self) -> int:
        return int(self.values.shape[0])

    @property
    def dtype(self) -> np.dtype:
        return self.values.dtype

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nr_rows, self.nr_cols)

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def to_coo(self) -> "COOMatrix":
        rows = np.repeat(
            np.arange(self.nr_rows, dtype=INDEX_DTYPE), self.row_nnz())
        return COOMatrix(rows, self.col_ind.copy(), self.values.copy(),
                         self.nr_rows, self.nr_cols)

    def to_dense(self) -> np.ndarray:
        d = np.zeros(self.shape, dtype=self.dtype)
        coo = self.to_coo()
        # duplicate-safe accumulate
        np.add.at(d, (coo.row_ind, coo.col_ind), coo.values)
        return d

    def row_slice(self, start: int, end: int) -> "CSRMatrix":
        """Rows [start, end) as a CSR of shape (end-start, nr_cols) —
        the sub-matrix handed to one compute unit by the balanced row
        split (csr_hw.cpp:459-468)."""
        lo = int(self.row_ptr[start])
        hi = int(self.row_ptr[end])
        return CSRMatrix(
            (self.row_ptr[start:end + 1] - lo).astype(self.row_ptr.dtype),
            self.col_ind[lo:hi], self.values[lo:hi],
            end - start, self.nr_cols)

    def transpose(self) -> "CSRMatrix":
        """A^T as CSR (host-side index swap + re-sort)."""
        coo = self.to_coo()
        return CSRMatrix.from_coo(coo.col_ind, coo.row_ind, coo.values,
                                  self.nr_cols, self.nr_rows,
                                  sum_duplicates=False)

    @property
    def T(self) -> "CSRMatrix":
        return self.transpose()

    def to_scipy(self):
        from scipy.sparse import csr_matrix
        return csr_matrix((self.values, self.col_ind, self.row_ptr),
                          shape=self.shape)

    @staticmethod
    def from_scipy(m) -> "CSRMatrix":
        m = m.tocsr()
        return CSRMatrix(m.indptr.astype(INDEX_DTYPE),
                         m.indices.astype(INDEX_DTYPE),
                         np.asarray(m.data), m.shape[0], m.shape[1])

    @staticmethod
    def from_coo(rows, cols, vals, nr_rows, nr_cols,
                 sum_duplicates: bool = True) -> "CSRMatrix":
        rows = _as_1d(rows, INDEX_DTYPE, "rows")
        cols = _as_1d(cols, INDEX_DTYPE, "cols")
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and rows.size:
            keep = np.ones(rows.size, dtype=bool)
            keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            if not keep.all():
                seg = np.cumsum(keep) - 1
                out_vals = np.zeros(int(seg[-1]) + 1, dtype=vals.dtype)
                np.add.at(out_vals, seg, vals)
                rows, cols, vals = rows[keep], cols[keep], out_vals
        row_ptr = np.zeros(nr_rows + 1, dtype=np.int64)
        np.add.at(row_ptr, rows + 1, 1)
        row_ptr = np.cumsum(row_ptr).astype(INDEX_DTYPE)
        return CSRMatrix(row_ptr, cols, vals, nr_rows, nr_cols)


@dataclasses.dataclass
class COOMatrix:
    """Coordinate-format matrix (extension; no reference analogue)."""

    row_ind: np.ndarray
    col_ind: np.ndarray
    values: np.ndarray
    nr_rows: int
    nr_cols: int

    def __post_init__(self):
        self.row_ind = _as_1d(self.row_ind, INDEX_DTYPE, "row_ind")
        self.col_ind = _as_1d(self.col_ind, INDEX_DTYPE, "col_ind")
        self.values = np.ascontiguousarray(self.values)

    @property
    def nr_nzeros(self) -> int:
        return int(self.values.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def shape(self):
        return (self.nr_rows, self.nr_cols)

    def to_csr(self) -> CSRMatrix:
        return CSRMatrix.from_coo(self.row_ind, self.col_ind, self.values,
                                  self.nr_rows, self.nr_cols)


@dataclasses.dataclass
class BSRMatrix:
    """Block sparse row matrix with dense (bh, bw) blocks (extension).

    Dense blocks carry one column index per block (kernels/bsr.py).
    """

    row_ptr: np.ndarray    # (nr_block_rows + 1,)
    col_ind: np.ndarray    # (n_blocks,) block-column indices
    values: np.ndarray     # (n_blocks, bh, bw)
    nr_rows: int
    nr_cols: int

    def __post_init__(self):
        self.row_ptr = _as_1d(self.row_ptr, INDEX_DTYPE, "row_ptr")
        self.col_ind = _as_1d(self.col_ind, INDEX_DTYPE, "col_ind")
        self.values = np.ascontiguousarray(self.values)
        if self.values.ndim != 3:
            raise ValueError("BSR values must be (n_blocks, bh, bw)")

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (int(self.values.shape[1]), int(self.values.shape[2]))

    @property
    def nr_block_rows(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def nr_nzeros(self) -> int:
        """Stored entries (incl. explicit zeros inside blocks)."""
        return int(self.values.size)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def shape(self):
        return (self.nr_rows, self.nr_cols)

    def to_csr(self) -> CSRMatrix:
        bh, bw = self.block_shape
        nb = self.values.shape[0]
        if nb == 0:
            return CSRMatrix(np.zeros(self.nr_rows + 1, INDEX_DTYPE),
                             np.zeros(0, INDEX_DTYPE),
                             np.zeros(0, self.dtype),
                             self.nr_rows, self.nr_cols)
        brow = np.repeat(np.arange(self.nr_block_rows, dtype=np.int64),
                         np.diff(self.row_ptr))
        rows = (brow[:, None, None] * bh
                + np.arange(bh)[None, :, None]
                + np.zeros((1, 1, bw), dtype=np.int64))
        cols = (self.col_ind[:, None, None].astype(np.int64) * bw
                + np.arange(bw)[None, None, :]
                + np.zeros((1, bh, 1), dtype=np.int64))
        mask = ((rows < self.nr_rows) & (cols < self.nr_cols)
                & (self.values != 0))
        return CSRMatrix.from_coo(rows[mask], cols[mask], self.values[mask],
                                  self.nr_rows, self.nr_cols)


@dataclasses.dataclass
class DenseVector:
    """csr_vector analogue (csr.h:18-22)."""

    values: np.ndarray

    @property
    def nr_values(self) -> int:
        return int(self.values.shape[0])


def create_csr_vector(n: int, dtype=np.float64) -> DenseVector:
    """create_csr_vector (csr.cpp:141-152)."""
    return DenseVector(np.zeros(n, dtype=dtype))


def init_vector_rand(v: DenseVector, max_value: float = 1.0,
                     seed=None) -> None:
    """init_vector_rand (csr.cpp:170-179): uniform [0, max_value)."""
    rng = np.random.default_rng(seed)
    v.values[...] = rng.uniform(0.0, max_value,
                                size=v.values.shape).astype(v.values.dtype)
