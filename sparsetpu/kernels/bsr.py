"""BSR SpMV in plain ``jax.numpy``: dense (bh, bw) blocks.

Extension scoped by BASELINE.json ("BSR SpMV").  For matrices with
clustered structure (dof-blocked FEM), dense blocks carry one column index
per block instead of one per nonzero.  The product gathers the x segment
of each block, multiplies each block with it and sums the block partials
by block row with a sorted segment sum.  The block shape is whatever
``csr_to_bsr`` was given.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.csr import BSRMatrix


class BSRDevice:
    """Device-resident BSR matrix."""

    def __init__(self, m: BSRMatrix, dtype=None):
        self.nr_rows, self.nr_cols = m.shape
        self.bh, self.bw = m.block_shape
        self.nr_block_rows = m.nr_block_rows
        self.dtype = np.dtype(dtype or m.dtype)
        self.blocks = jnp.asarray(m.values.astype(self.dtype))
        self.bcol = jnp.asarray(m.col_ind.astype(np.int32))
        self.brow = jnp.asarray(np.repeat(
            np.arange(m.nr_block_rows, dtype=np.int32), np.diff(m.row_ptr)))
        self.padded_cols = -(-self.nr_cols // self.bw) * self.bw

    def spmv(self, x) -> jax.Array:
        return _bsr_apply(self.blocks, self.bcol, self.brow,
                          jnp.asarray(x, self.dtype),
                          nr_rows=self.nr_rows,
                          nr_block_rows=self.nr_block_rows,
                          padded_cols=self.padded_cols)


@functools.partial(jax.jit, static_argnames=("nr_rows", "nr_block_rows",
                                             "padded_cols"))
def _bsr_apply(blocks, bcol, brow, x, *, nr_rows, nr_block_rows,
               padded_cols):
    bw = blocks.shape[2]
    x2 = jnp.pad(x, (0, padded_cols - x.shape[0])).reshape(-1, bw)
    # float32 products would otherwise be allowed to run in TF32
    part = jnp.einsum("bij,bj->bi", blocks, x2[bcol],
                      precision=jax.lax.Precision.HIGHEST)
    y = jax.ops.segment_sum(part, brow, num_segments=nr_block_rows,
                            indices_are_sorted=True)
    return y.reshape(-1)[:nr_rows]


def bsr_spmv(m: BSRMatrix, x) -> jax.Array:
    return BSRDevice(m).spmv(x)
