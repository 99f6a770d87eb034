"""Public user API.

Mirrors the reference's documented programmer surface (README.md:34-46,
csr_hw_wrapper.h:9-17):

  reference                              sparsetpu
  -------------------------------------  ----------------------------------
  create_csr_hw_matrix(m, hw, bitmap)    pack(matrix, config) -> SparseMatrix
  create_csr_hw_x_vector(hw_x, x, ...)   SparseMatrix.prepare_x(x)
  create_csr_hw_y_vector(...)            (internal: y is a device array)
  spmv_hw(hw, hw_x, y, bitmap)           SparseMatrix.spmv(x) / spmv(m, x)
  delete_csr_hw_matrix / _x / _y         (no-ops: GC + XLA allocator)

The aliases with reference names are provided for drop-in familiarity; the
idiomatic surface is ``pack``/``spmv``/``SparseMatrix``.

The device format is CSR: ``row_ptr``, ``col_ind`` and ``values`` live on
the device, plus the sorted row id of each nonzero, which the XLA route and
SpMM read.  Which kernel runs an SpMV (the *route*) is decided once, in
``choose_route``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.csr import CSRMatrix
from ..kernels import spmv_cusparse, spmv_triton
from ..kernels.spmv_xla import spmm_coo_xla, spmv_coo_xla
from ..utils.config import SpmvConfig

ROUTES = ("xla", "cusparse", "triton")

X64_MESSAGE = (
    "float64 matrices need JAX's 64-bit mode, which is off: call "
    "sparsetpu.utils.init_runtime() or jax.config.update("
    "'jax_enable_x64', True) (or set JAX_ENABLE_X64=1) before packing, or "
    "pass SpmvConfig(dtype=np.float32) to compute in float32")


def choose_route(matrix: CSRMatrix, backend: str = "auto",
                 config: Optional[SpmvConfig] = None) -> str:
    """The SpMV route for ``matrix`` under ``config`` (default: its own
    dtype): ``backend`` itself when it names one, else the plain XLA
    route on the CPU.  On a GPU (PERF.md, "Kernel routes"): the Triton
    row-block kernel for uniform short rows, where it beat cuSPARSE (FEM
    rows; with bf16 values also uniform random rows), and cuSPARSE for
    the rest (long, skewed or scattered rows).  A cuSPARSE route is
    returned only if its program compiles to the cuSPARSE call."""
    cfg = config or SpmvConfig(dtype=matrix.dtype)
    if backend != "auto":
        if backend not in ROUTES:
            raise ValueError(
                f"backend must be 'auto' or one of {ROUTES}, got {backend!r}")
        if backend == "triton" and jax.default_backend() != "gpu":
            raise ValueError("the triton route needs a GPU")
        route = backend
    elif jax.default_backend() != "gpu":
        route = "xla"
    else:
        cap = (spmv_triton.MAX_UNIFORM_ROW_NNZ_BF16 if cfg.is_bf16
               else spmv_triton.MAX_UNIFORM_ROW_NNZ)
        route = ("triton"
                 if spmv_triton.uniform_short_rows(matrix.row_nnz(), cap)
                 else "cusparse")
    if route == "cusparse":
        spmv_cusparse.require_cusparse(cfg.dtype, cfg.compute_dtype)
    return route


def route_spmv(route: str, row_ptr, col_ind, values, row_ids, x,
               shape) -> jax.Array:
    """y = A @ x for CSR arrays on ``route`` (also the per-shard product of
    ``dist``); only the XLA route reads ``row_ids``."""
    if route == "xla":
        return spmv_coo_xla(row_ids, col_ind, values, x, shape[0])
    if route == "cusparse":
        return spmv_cusparse.spmv_cusparse(row_ptr, col_ind, values, x,
                                           shape)
    return spmv_triton.spmv_triton(row_ptr, col_ind, values, x,
                                   nr_rows=shape[0])


def _check_csr(matrix: CSRMatrix) -> None:
    """Reject structure the device gathers would silently clamp."""
    rp = matrix.row_ptr
    if rp[0] != 0 or rp[-1] != matrix.nr_nzeros or \
            (matrix.nr_rows and np.any(np.diff(rp) < 0)):
        raise ValueError("row_ptr must start at 0, be non-decreasing and "
                         "end at nnz")
    if matrix.nr_nzeros and (matrix.col_ind.min() < 0 or
                             matrix.col_ind.max() >= matrix.nr_cols):
        raise ValueError("column index out of range")


class SparseMatrix:
    """A device-resident CSR matrix with an ``@`` operator.

    The user-facing handle combining the reference's csr_hw_matrix array +
    per-CU bookkeeping (README.md:38) into one object.  It is a pytree:
    its device arrays are the children, so it crosses ``jit`` as an
    argument.
    """

    def __init__(self, matrix: CSRMatrix, config: Optional[SpmvConfig] = None,
                 backend: str = "auto"):
        self.config = config or SpmvConfig(dtype=matrix.dtype)
        if self.config.is_double and not jax.config.jax_enable_x64:
            raise ValueError(X64_MESSAGE)
        _check_csr(matrix)
        self.nr_rows = matrix.nr_rows
        self.nr_cols = matrix.nr_cols
        self.nr_nzeros = matrix.nr_nzeros
        self.dtype = self.config.compute_dtype
        self.route = choose_route(matrix, backend, self.config)
        self._parts = None
        self.row_ptr = self.col_ind = self.values = self.row_ids = None
        if self.config.num_partitions > 1:
            # CU parity (util.h:41-59): nnz-balanced contiguous row
            # partitions, each a CSR matrix on the same route
            from ..pack.balance import balance_rows
            part = balance_rows(matrix, self.config.num_partitions)
            one = dataclasses.replace(self.config, num_partitions=1)
            self._parts = [SparseMatrix(matrix.row_slice(int(s), int(e)),
                                        one, backend=self.route)
                           for s, e in zip(part.row_start, part.row_end)]
            return
        vdt = self.config.dtype if self.config.is_bf16 else self.dtype
        self.row_ptr = jnp.asarray(matrix.row_ptr)
        self.col_ind = jnp.asarray(matrix.col_ind)
        self.values = jnp.asarray(matrix.values.astype(vdt))
        self.row_ids = jnp.asarray(np.repeat(
            np.arange(self.nr_rows, dtype=np.int32), matrix.row_nnz()))

    @property
    def shape(self):
        return (self.nr_rows, self.nr_cols)

    def _operand(self, x, ndim: int) -> jax.Array:
        x = jnp.asarray(x, dtype=self.dtype)
        if x.ndim != ndim or x.shape[0] != self.nr_cols:
            raise ValueError(f"operand of shape {x.shape} does not fit a "
                             f"{self.shape} matrix")
        return x

    def spmv(self, x) -> jax.Array:
        """y = A @ x (spmv_hw analogue, csr_hw_wrapper.cpp:193-288, with
        the per-block device calls and host accumulation fused into one
        device program).  x is cast to the matrix's compute dtype, so a
        float32 matrix stays float32 under x64 and y has that dtype."""
        x = self._operand(x, 1)
        if self._parts is not None:
            return jnp.concatenate([p.spmv(x) for p in self._parts])
        return route_spmv(self.route, self.row_ptr, self.col_ind,
                          self.values, self.row_ids, x, self.shape)

    def spmm(self, x) -> jax.Array:
        """Y = A @ X for X of shape (nr_cols, k) (multi-RHS extension):
        one pass over A serves all k right-hand sides, on the XLA route
        whatever the SpMV route (it beat cuSPARSE's csr_matmat at k=8 on
        the H100, PERF.md)."""
        x = self._operand(x, 2)
        if self._parts is not None:
            return jnp.concatenate([p.spmm(x) for p in self._parts])
        return spmm_coo_xla(self.row_ids, self.col_ind, self.values, x,
                            self.nr_rows)

    def __matmul__(self, x):
        if isinstance(x, (SparseMatrix, CSRMatrix)):
            # sparse @ sparse -> SpGEMM (numeric phase on device)
            from ..kernels.spgemm import spgemm
            other = x.unpack() if isinstance(x, SparseMatrix) else x
            return spgemm(self.unpack(), other)
        ndim = np.ndim(x)
        if ndim == 1:
            return self.spmv(x)
        if ndim == 2:
            return self.spmm(x)
        raise ValueError("operand must be a vector or matrix")

    def prepare_x(self, x) -> jax.Array:
        """x as a device array of the compute dtype, for repeated calls
        (create_csr_hw_x_vector, csr_hw_wrapper.cpp:187-191)."""
        return self._operand(x, 1)

    def spmv_packed_x(self, x_packed) -> jax.Array:
        return self.spmv(x_packed)

    def unpack(self) -> CSRMatrix:
        """The host CSR matrix, read back from the device arrays."""
        if self._parts is not None:
            subs = [p.unpack() for p in self._parts]
            offs = np.cumsum([0] + [s.nr_nzeros for s in subs[:-1]])
            ptr = np.concatenate(
                [[0]] + [s.row_ptr[1:].astype(np.int64) + o
                         for s, o in zip(subs, offs)])
            return CSRMatrix(ptr, np.concatenate([s.col_ind for s in subs]),
                             np.concatenate([s.values for s in subs]),
                             self.nr_rows, self.nr_cols)
        return CSRMatrix(np.asarray(self.row_ptr), np.asarray(self.col_ind),
                         np.asarray(self.values).astype(self.dtype),
                         self.nr_rows, self.nr_cols)

    def transpose(self) -> "SparseMatrix":
        """A^T, packed on first access (cached)."""
        if getattr(self, "_transposed", None) is None:
            self._transposed = SparseMatrix(self.unpack().transpose(),
                                            self.config, backend=self.route)
        return self._transposed

    @property
    def T(self) -> "SparseMatrix":
        return self.transpose()

    def _leaves(self):
        if self._parts is not None:
            return [a for p in self._parts for a in p._leaves()]
        return [a for a in (self.row_ptr, self.col_ind, self.values,
                            self.row_ids) if a is not None]

    # reporting (main.cpp:84-88)
    def storage_bytes(self) -> int:
        """Bytes the matrix holds on the device."""
        return int(sum(a.nbytes for a in self._leaves()))

    def storage_overhead(self) -> float:
        """Device bytes over plain CSR bytes (values + 4-byte indices)."""
        csr = (self.nr_nzeros * (np.dtype(self.config.dtype).itemsize + 4)
               + 4 * (self.nr_rows + 1))
        return self.storage_bytes() / max(csr, 1)

    def fill_factor(self) -> float:
        """Nonzeros over stored slots: CSR pads nothing."""
        return 1.0

    def spmv_bytes(self) -> int:
        """Bytes one SpMV must move on this route: the arrays it reads,
        x once and y once."""
        vb = np.dtype(self.config.dtype).itemsize
        per_nnz = vb + 4 + (4 if self.route == "xla" else 0)
        if self.route == "cusparse" and self.config.is_bf16:
            # cuSPARSE takes x's dtype: each call writes a widened copy of
            # the values and reads it back
            per_nnz += 2 * self.dtype.itemsize
        ptr = 0 if self.route == "xla" else 4 * (self.nr_rows + 1)
        xy = self.dtype.itemsize * (self.nr_rows + self.nr_cols)
        return self.nr_nzeros * per_nnz + ptr + xy


def _sm_flatten(sm):
    parts = tuple(sm._parts) if sm._parts is not None else None
    children = (sm.row_ptr, sm.col_ind, sm.values, sm.row_ids, parts)
    aux = (sm.config, sm.nr_rows, sm.nr_cols, sm.nr_nzeros, sm.dtype,
           sm.route)
    return children, aux


def _sm_unflatten(aux, children):
    sm = object.__new__(SparseMatrix)
    (sm.config, sm.nr_rows, sm.nr_cols, sm.nr_nzeros, sm.dtype,
     sm.route) = aux
    sm.row_ptr, sm.col_ind, sm.values, sm.row_ids, parts = children
    sm._parts = list(parts) if parts is not None else None
    return sm


jax.tree_util.register_pytree_node(SparseMatrix, _sm_flatten, _sm_unflatten)


def pack(matrix: CSRMatrix, config: Optional[SpmvConfig] = None,
         backend: str = "auto") -> SparseMatrix:
    """create_csr_hw_matrix analogue (README.md:38)."""
    return SparseMatrix(matrix, config, backend=backend)


def spmv(matrix: Union[SparseMatrix, CSRMatrix], x,
         config: Optional[SpmvConfig] = None) -> jax.Array:
    if isinstance(matrix, CSRMatrix):
        matrix = pack(matrix, config)
    return matrix.spmv(x)


def unpack(matrix: SparseMatrix) -> CSRMatrix:
    return matrix.unpack()


# --- reference-named aliases (README.md:34-46) ------------------------------

def create_csr_hw_matrix(matrix: CSRMatrix,
                         config: Optional[SpmvConfig] = None) -> SparseMatrix:
    return pack(matrix, config)


def create_csr_hw_x_vector(hw_matrix: SparseMatrix, x) -> jax.Array:
    return hw_matrix.prepare_x(x)


def spmv_hw(hw_matrix: SparseMatrix, hw_x) -> jax.Array:
    return hw_matrix.spmv_packed_x(hw_x)


def delete_csr_hw_matrix(hw_matrix) -> None:
    """No-op: device buffers are freed by GC / the XLA allocator.  Kept so
    reference-shaped programs port line-for-line."""


def delete_csr_hw_x_vector(hw_x) -> None:
    """No-op (see delete_csr_hw_matrix)."""
