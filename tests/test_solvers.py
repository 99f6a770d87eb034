"""Solvers on top of SpMV (CG / BiCGSTAB / power iteration)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sparsetpu import SparseMatrix
from sparsetpu.formats import laplace_2d, random_csr
from sparsetpu.solvers.cg import bicgstab, cg, power_iteration


def _xla_spmv(m):
    sm = SparseMatrix(m, backend="xla")
    return sm.spmv, sm


def test_cg_laplace():
    m = laplace_2d(12)
    spmv, _ = _xla_spmv(m)
    b = jnp.ones((m.nr_rows,), jnp.float32)
    res = cg(spmv, b, tol=1e-5, maxiter=2000)
    x = np.asarray(res.x)
    assert np.allclose(m.to_dense() @ x, np.ones(m.nr_rows), atol=1e-2)
    assert int(res.iterations) < 2000


def test_bicgstab_nonsymmetric():
    rng = np.random.default_rng(0)
    m = random_csr(80, 80, density=0.2, seed=30)
    # diagonally dominate to guarantee convergence
    d = np.abs(m.to_dense()).sum(axis=1) + 1.0
    dense = m.to_dense() + np.diag(d)
    from sparsetpu.formats import CSRMatrix
    coo = np.nonzero(dense)
    m2 = CSRMatrix.from_coo(coo[0], coo[1], dense[coo], 80, 80)
    spmv, _ = _xla_spmv(m2)
    b = jnp.asarray(rng.standard_normal(80).astype(np.float32))
    res = bicgstab(spmv, b, tol=1e-6, maxiter=500)
    x = np.asarray(res.x)
    assert np.allclose(dense @ x, np.asarray(b), atol=1e-3)


def test_power_iteration():
    m = laplace_2d(8)
    spmv, _ = _xla_spmv(m)
    lam, v = power_iteration(spmv, m.nr_rows, iters=200)
    w = np.linalg.eigvalsh(m.to_dense())
    assert abs(float(lam) - w[-1]) < 1e-2 * abs(w[-1])


def test_pcg_jacobi_converges_faster():
    """Jacobi-preconditioned CG on an ill-scaled SPD system converges in
    fewer iterations than plain CG."""
    import numpy as np
    from sparsetpu.api.api import SparseMatrix
    from sparsetpu.formats.csr import CSRMatrix
    from sparsetpu.formats.random import laplace_2d
    from sparsetpu.solvers.cg import cg, jacobi_preconditioner, pcg

    base = laplace_2d(24)
    # scale rows/cols to worsen conditioning
    n = base.nr_rows
    s = np.exp(np.linspace(0, 4, n))
    sp = base.to_scipy().astype(np.float64)
    import scipy.sparse as ssp
    d = ssp.diags(s)
    m = CSRMatrix.from_scipy((d @ sp @ d).tocsr().astype(np.float32))
    A = SparseMatrix(m)
    b = np.ones(n, np.float32)
    r1 = cg(A.spmv, b, tol=1e-5, maxiter=3000)
    r2 = pcg(A.spmv, b, jacobi_preconditioner(m), tol=1e-5, maxiter=3000)
    assert int(r2.iterations) < int(r1.iterations)
    assert float(r2.residual_norm) < 1e-4 * np.linalg.norm(b)


def test_jacobi_iteration_reduces_residual():
    import numpy as np
    from sparsetpu.api.api import SparseMatrix
    from sparsetpu.formats.random import laplace_2d
    from sparsetpu.solvers.cg import jacobi_iteration

    m = laplace_2d(16)
    import numpy as _np
    m.values = m.values.astype(_np.float32)
    A = SparseMatrix(m)
    b = np.ones(m.nr_rows, np.float32)
    x = np.asarray(jacobi_iteration(A.spmv, m, b, iters=200, omega=0.6))
    res = np.linalg.norm(b - np.asarray(A.spmv(x)))
    assert res < 0.5 * np.linalg.norm(b)


def test_gmres_nonsymmetric():
    from sparsetpu.solvers.cg import gmres
    from sparsetpu.api.api import SparseMatrix
    from sparsetpu.utils.config import SpmvConfig
    import scipy.sparse as sp
    from sparsetpu.formats.csr import CSRMatrix
    rng = np.random.default_rng(3)
    n = 400
    # well-conditioned non-symmetric: I + small random sparse
    s = sp.random(n, n, density=0.02, random_state=5,
                  data_rvs=lambda k: 0.1 * rng.standard_normal(k))
    a = (sp.eye(n) + s).tocsr().astype(np.float32)
    m = CSRMatrix(a.indptr.astype(np.int32), a.indices.astype(np.int32),
                  a.data, n, n)
    A = SparseMatrix(m, SpmvConfig(dtype=np.float32))
    b = rng.standard_normal(n).astype(np.float32)
    res = gmres(A.spmv, b, restart=25, tol=1e-5, maxiter=300)
    x = np.asarray(res.x)
    assert np.linalg.norm(a @ x - b) < 1e-3 * np.linalg.norm(b)


def _nonsymmetric(n=300, seed=3):
    import scipy.sparse as sp
    from sparsetpu.formats.csr import CSRMatrix
    rng = np.random.default_rng(seed)
    s = sp.random(n, n, density=0.02, random_state=seed,
                  data_rvs=lambda k: 0.1 * rng.standard_normal(k))
    return CSRMatrix.from_scipy((sp.eye(n) + s).tocsr())


@pytest.mark.parametrize("solver", ["cg", "pcg", "bicgstab", "gmres"])
def test_native_f64_solver_matches_scipy(solver):
    """float64 end to end (b, iterates, dots) against scipy's direct
    solve, to a residual no float32 run reaches."""
    import scipy.sparse.linalg as spla
    from sparsetpu.solvers.cg import gmres, jacobi_preconditioner, pcg
    m = laplace_2d(16) if solver in ("cg", "pcg") else _nonsymmetric()
    A = SparseMatrix(m)
    b = np.random.default_rng(4).standard_normal(m.nr_rows)
    if solver == "cg":
        res = cg(A.spmv, b, tol=1e-12, maxiter=2000)
    elif solver == "pcg":
        res = pcg(A.spmv, b, jacobi_preconditioner(m), tol=1e-12,
                  maxiter=2000)
    elif solver == "bicgstab":
        res = bicgstab(A.spmv, b, tol=1e-12, maxiter=2000)
    else:
        res = gmres(A.spmv, b, restart=30, tol=1e-12, maxiter=600)
    x = np.asarray(res.x)
    assert x.dtype == np.float64
    xg = spla.spsolve(m.to_scipy().tocsc(), b)
    assert np.abs(x - xg).max() < 1e-9 * np.abs(xg).max()
    assert np.linalg.norm(m.to_scipy() @ x - b) < 1e-10 * np.linalg.norm(b)
