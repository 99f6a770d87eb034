"""Row-block CSR SpMV for Hopper, written in Pallas through Triton.

Each program owns ``block_rows`` consecutive rows.  It loads their row
pointers itself, then walks the rows' nonzeros ``width`` at a time as a
(block_rows, width) tile: masked loads of column indices and values, the
gather ``x[col]`` (x sits in L2), a multiply and a row sum kept in
registers.  The loop runs as many steps as the longest row of the block
needs, and each y entry is written once, with no atomics.

``interpret=True`` runs the kernel in the Pallas interpreter; it exists
for the CPU tests only and nothing in ``SparseMatrix`` sets it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tile of one loop step: 32 rows x 16 nonzeros, 4 warps.  Chosen on an H100
# by the tile sweep of ``chip_smoke.py --routes`` (PERF.md, "Kernel
# routes").
BLOCK_ROWS = 32
WIDTH = 16
NUM_WARPS = 4
# Rows the kernel takes well: all of about one length (a program walks
# its longest row, so one long row stalls a block), none longer than the
# longest row on which it beat cuSPARSE on the H100: FEM rows of 27 in
# float32 and float64 (random rows of ~50 lost); with bf16 values, whose
# widened copy costs cuSPARSE 6 B per nonzero, also random rows of mean
# 50 and 128 (PERF.md, "Kernel routes").
MAX_UNIFORM_ROW_NNZ = 32
MAX_UNIFORM_ROW_NNZ_BF16 = 192


def uniform_short_rows(row_nnz: np.ndarray,
                       max_row_nnz: int = MAX_UNIFORM_ROW_NNZ) -> bool:
    """True when every row is at most ``max_row_nnz`` long and at most
    twice the mean: the class of matrices on which this kernel beat
    cuSPARSE on the H100."""
    if row_nnz.size == 0:
        return False
    longest = int(row_nnz.max())
    return (longest <= max_row_nnz
            and longest <= 2 * float(row_nnz.mean()))


def _kernel(rp_ref, col_ref, val_ref, x_ref, y_ref, *, block_rows, width,
            nr_rows):
    r0 = pl.program_id(0) * jnp.int32(block_rows)
    rows = r0 + jnp.arange(block_rows, dtype=jnp.int32)
    live = rows < nr_rows
    start = plgpu.load(rp_ref.at[pl.ds(r0, block_rows)], mask=live,
                       other=0)
    end = plgpu.load(rp_ref.at[pl.ds(r0 + 1, block_rows)], mask=live,
                     other=0)
    steps = (jnp.max(end - start) + (width - 1)) // jnp.int32(width)
    lane = jnp.arange(width, dtype=jnp.int32)

    def body(i, acc):
        idx = start[:, None] + i * jnp.int32(width) + lane[None, :]
        m = idx < end[:, None]
        c = plgpu.load(col_ref.at[idx], mask=m, other=0)
        v = plgpu.load(val_ref.at[idx], mask=m, other=0)
        xv = plgpu.load(x_ref.at[c], mask=m, other=0)
        return acc + jnp.sum(v.astype(acc.dtype) * xv, axis=1)

    acc = lax.fori_loop(0, steps, body,
                        jnp.zeros((block_rows,), y_ref.dtype))
    plgpu.store(y_ref.at[pl.ds(r0, block_rows)], acc, mask=live)


@functools.partial(jax.jit, static_argnames=("nr_rows", "block_rows",
                                             "width", "num_warps",
                                             "interpret"))
def spmv_triton(row_ptr: jax.Array, col_ind: jax.Array, values: jax.Array,
                x: jax.Array, *, nr_rows: int, block_rows: int = BLOCK_ROWS,
                width: int = WIDTH, num_warps: int = NUM_WARPS,
                interpret: bool = False) -> jax.Array:
    """y = A @ x; y has the dtype of x (bf16 values accumulate in it).
    ``block_rows`` and ``width`` (powers of two) and ``num_warps`` set the
    tile."""
    if values.shape[0] == 0:          # nothing to launch over
        return jnp.zeros((nr_rows,), x.dtype)
    grid = (pl.cdiv(nr_rows, block_rows),)
    kernel = functools.partial(_kernel, block_rows=block_rows, width=width,
                               nr_rows=nr_rows)
    return pl.pallas_call(
        kernel, grid=grid, backend="triton", interpret=interpret,
        out_shape=jax.ShapeDtypeStruct((nr_rows,), x.dtype),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        name="spmv_csr_rowblock",
    )(row_ptr, col_ind, values, x)
