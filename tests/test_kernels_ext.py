"""Extension kernels: SpMM (multi-RHS) and BSR SpMV."""

import numpy as np
import pytest

from sparsetpu import SparseMatrix
from sparsetpu.formats import (banded_csr, csr_to_bsr, default_tolerance,
                               random_csr, spmm_gold, spmv_gold,
                               verification)
from sparsetpu.kernels.bsr import BSRDevice, bsr_spmv


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmm(k, dtype):
    m = random_csr(200, 1500, density=0.02, seed=70, dtype=dtype)
    x = np.random.default_rng(1).standard_normal((m.nr_cols, k))
    sm = SparseMatrix(m)
    y = np.asarray(sm.spmm(x))
    assert y.shape == (m.nr_rows, k) and y.dtype == dtype
    yg = spmm_gold(m, x.astype(dtype).astype(np.float64))
    tol = default_tolerance(dtype, m.row_nnz())
    for kk in range(k):
        assert verification(yg[:, kk], y[:, kk], *tol) == 0


def test_spmm_operator():
    m = random_csr(50, 60, density=0.1, seed=71)
    sm = SparseMatrix(m)
    x = np.random.default_rng(2).standard_normal((60, 2))
    y = np.asarray(sm @ x)
    assert np.allclose(y, m.to_dense() @ x, atol=1e-12, rtol=1e-12)
    with pytest.raises(ValueError):
        sm @ np.ones((60, 2, 2))


@pytest.mark.parametrize("shape,bandwidth", [((300, 300), 10),
                                             ((1000, 700), 40)])
def test_bsr_spmv(shape, bandwidth):
    m = banded_csr(*shape, bandwidth=bandwidth)
    b = csr_to_bsr(m, block_shape=(8, 128))
    x = np.random.default_rng(3).standard_normal(m.nr_cols)
    y = np.asarray(bsr_spmv(b, x))
    assert verification(spmv_gold(m, x), y,
                        *default_tolerance(np.float64, m.row_nnz())) == 0


def test_bsr_spmv_random():
    m = random_csr(200, 500, density=0.05, seed=72)
    b = csr_to_bsr(m, block_shape=(8, 128))
    x = np.random.default_rng(4).standard_normal(m.nr_cols)
    y = np.asarray(bsr_spmv(b, x))
    assert verification(spmv_gold(m, x), y,
                        *default_tolerance(np.float64, m.row_nnz())) == 0


@pytest.mark.parametrize("block_shape", [(3, 3), (4, 4), (2, 16)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bsr_block_shapes(block_shape, dtype):
    """Block shapes are free parameters (dof-blocked FEM uses dof x dof)."""
    from sparsetpu.formats import shell_3d
    m = shell_3d(6, 8, 3, dof=3, dtype=dtype)
    b = csr_to_bsr(m, block_shape=block_shape)
    x = np.random.default_rng(5).standard_normal(m.nr_cols).astype(dtype)
    y = np.asarray(BSRDevice(b).spmv(x))
    assert y.dtype == dtype
    assert verification(spmv_gold(m, x), y,
                        *default_tolerance(dtype, m.row_nnz())) == 0
