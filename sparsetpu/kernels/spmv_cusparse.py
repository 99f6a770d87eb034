"""SpMV through cuSPARSE, reached via ``jax.experimental.sparse``.

A library's kernel, not one this repository wrote.  On a CUDA device
``csr_matvec`` lowers to the ``cusparse_csr_matvec_ffi`` custom call for
float32 and float64; for any other dtype, or when cuSPARSE is missing,
``jax.experimental.sparse`` falls back to a generic lowering with only a
warning, so ``uses_cusparse`` checks the compiled program for the custom
call, and ``require_cusparse`` refuses a GPU route that lacks it.  On the
CPU the same function runs that generic lowering (gather +
segment sum), which is what the CPU tests exercise.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import sparse as jsparse

CUSPARSE_TARGET = "cusparse_csr_matvec_ffi"


@functools.partial(jax.jit, static_argnames=("shape",))
def spmv_cusparse(row_ptr: jax.Array, col_ind: jax.Array, values: jax.Array,
                  x: jax.Array, shape: tuple) -> jax.Array:
    """y = A @ x with A given by CSR arrays (int32 indices).  cuSPARSE
    takes values in the dtype of x, so bf16 values are widened first."""
    if values.shape[0] == 0:          # cuSPARSE is not called without nnz
        return jnp.zeros((shape[0],), x.dtype)
    a = jsparse.CSR((values.astype(x.dtype), col_ind, row_ptr), shape=shape)
    return jsparse.csr_matvec(a, x)


def uses_cusparse(compiled_text: str) -> bool:
    """True when a compiled program's HLO text calls cuSPARSE."""
    return CUSPARSE_TARGET in compiled_text


@functools.lru_cache(maxsize=None)
def require_cusparse(value_dtype: np.dtype, dtype: np.dtype) -> None:
    """On a GPU, raise unless ``spmv_cusparse`` with these value and x
    dtypes compiles to the cuSPARSE custom call (checked once per pair, on
    a 2 x 2 matrix: the lowering's choice depends on the dtypes and the
    installed cuSPARSE, not on the shape).  Nothing to check elsewhere."""
    if jax.default_backend() != "gpu":
        return
    idx = jax.ShapeDtypeStruct((2,), jnp.int32)
    text = spmv_cusparse.lower(
        jax.ShapeDtypeStruct((3,), jnp.int32), idx,
        jax.ShapeDtypeStruct((2,), value_dtype),
        jax.ShapeDtypeStruct((2,), dtype), shape=(2, 2)).compile().as_text()
    if not uses_cusparse(text):
        raise RuntimeError(
            f"csr_matvec with {np.dtype(value_dtype).name} values and "
            f"{np.dtype(dtype).name} x does not compile to cuSPARSE on this "
            "GPU; pick backend='triton' or 'xla'")
