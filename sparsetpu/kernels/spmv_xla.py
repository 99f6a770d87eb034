"""Plain-XLA SpMV/SpMM: the reference route, and the one the CPU runs.

Semantics contract: spmv_gold (csr.cpp:184-194).  Products are an
elementwise multiply of the gathered x and a sorted segment sum, so no
matrix product (and no TF32 rounding) is involved.  Values may be stored in
bfloat16: the multiply promotes them to the dtype of x, so sums accumulate
in float32 or float64.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("nr_rows",))
def spmv_coo_xla(row_ind: jax.Array, col_ind: jax.Array, values: jax.Array,
                 x: jax.Array, nr_rows: int) -> jax.Array:
    """y[r] = sum over e of values[e] * x[col_ind[e]] for row_ind[e] == r.

    Gather + segment sum over the sorted row id of each nonzero; XLA
    lowers the segment sum to a scatter-add.  Indices must be in bounds
    (``SparseMatrix`` checks them on the host).
    """
    prod = values * jnp.take(x, col_ind, mode="clip")
    return jax.ops.segment_sum(prod, row_ind, num_segments=nr_rows,
                               indices_are_sorted=True)


@functools.partial(jax.jit, static_argnames=("nr_rows",))
def spmm_coo_xla(row_ind: jax.Array, col_ind: jax.Array, values: jax.Array,
                 x: jax.Array, nr_rows: int) -> jax.Array:
    """Multi-RHS: Y = A @ X with X (nr_cols, k): gather rows of X, scale,
    sorted segment sum."""
    prod = values[:, None] * jnp.take(x, col_ind, axis=0, mode="clip")
    return jax.ops.segment_sum(prod, row_ind, num_segments=nr_rows,
                               indices_are_sorted=True)
