"""Native float64 under jit: traced SpMV, f64 SpMM, CG/PCG inside
lax.while_loop, and the f64 checkpoint (the reference's DOUBLE=1 build,
Makefile:18, computed natively)."""

import numpy as np
import pytest

import jax

from sparsetpu import SparseMatrix
from sparsetpu.formats.gold import default_tolerance, spmv_gold, verification
from sparsetpu.formats.random import laplace_2d, random_csr
from sparsetpu.solvers.cg import cg, jacobi_preconditioner, pcg


def test_f64_spmv_traced_matches_eager():
    m = random_csr(400, 700, density=0.01, seed=3)     # float64 values
    A = SparseMatrix(m)
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    y_eager = np.asarray(A.spmv(x))
    y_traced = jax.jit(lambda A, xd: A.spmv(xd))(A, x)
    assert y_traced.dtype == np.float64
    assert np.array_equal(np.asarray(y_traced), y_eager)


def test_matmul_keeps_f64_precision():
    # A @ x must not truncate float64 x to f32
    m = random_csr(300, 500, density=0.02, seed=5)
    A = SparseMatrix(m)
    x = np.random.default_rng(1).standard_normal(m.nr_cols)
    gold = m.to_scipy() @ x
    assert np.abs(np.asarray(A @ x) - gold).max() < 1e-13


def test_f64_tolerance_rejects_an_f32_result():
    """The float64 bound is relative and tight: a float32 downcast of the
    same product fails it."""
    m = random_csr(500, 600, density=0.05, seed=7)
    x = np.random.default_rng(2).standard_normal(m.nr_cols)
    gold = spmv_gold(m, x)
    tol = default_tolerance(np.float64, m.row_nnz())
    assert verification(gold, np.asarray(SparseMatrix(m) @ x), *tol) == 0
    y32 = gold.astype(np.float32).astype(np.float64)
    assert verification(gold, y32, *tol) > 0


def test_cg_f64_in_while_loop():
    L = laplace_2d(20)
    A = SparseMatrix(L)
    b = np.ones(L.nr_rows, np.float64)
    res = jax.jit(lambda A, b: cg(A.spmv, b, tol=1e-12, maxiter=400))(A, b)
    x = np.asarray(res.x)
    assert x.dtype == np.float64
    resid = np.linalg.norm(L.to_scipy() @ x - b)
    assert resid < 1e-11 * np.linalg.norm(b)
    # accuracy well beyond f32: compare to a float64 host solve
    import scipy.sparse.linalg as spla
    xg, _ = spla.cg(L.to_scipy(), b, rtol=1e-13)
    assert np.abs(x - xg).max() < 1e-9


def test_spmm_f64():
    m = random_csr(500, 600, density=0.01, seed=4)
    A = SparseMatrix(m)
    X = np.random.default_rng(2).standard_normal((m.nr_cols, 4))
    Y = np.asarray(A.spmm(X))
    assert Y.dtype == np.float64
    assert np.abs(Y - m.to_scipy() @ X).max() < 1e-13


def test_f64_device_checkpoint(tmp_path):
    from sparsetpu.pack.serialize import load_device, save_device
    m = random_csr(300, 400, density=0.02, seed=6)
    A = SparseMatrix(m)
    p = str(tmp_path / "f64.npz")
    save_device(p, A)
    d2 = load_device(p)
    x = np.random.default_rng(3).standard_normal(m.nr_cols)
    y = np.asarray(d2 @ x)
    assert y.dtype == np.float64
    assert np.abs(y - m.to_scipy() @ x).max() < 1e-13


def test_save_device_rejects_unknown():
    from sparsetpu.pack.serialize import save_device
    with pytest.raises(TypeError):
        save_device("unused.npz", object())


def test_pcg_f64():
    L = laplace_2d(16)
    A = SparseMatrix(L)
    b = np.ones(L.nr_rows, np.float64)
    m_inv = jacobi_preconditioner(L)
    res = jax.jit(lambda A, b: pcg(A.spmv, b, m_inv, tol=1e-12,
                                   maxiter=300))(A, b)
    x = np.asarray(res.x)
    assert x.dtype == np.float64
    resid = np.linalg.norm(L.to_scipy() @ x - b)
    assert resid < 1e-11 * np.linalg.norm(b)
