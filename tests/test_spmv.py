"""SpMV correctness on every route against the gold: the XLA and cuSPARSE
routes through SparseMatrix (cuSPARSE via jax.experimental.sparse's CPU
lowering here), the Triton kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest

from sparsetpu import SparseMatrix, SpmvConfig
from sparsetpu.formats import (banded_csr, default_tolerance, laplace_2d,
                               random_csr, spmv_gold, verification)
from sparsetpu.kernels.spmv_triton import spmv_triton

ROUTES = ["xla", "cusparse", "triton"]


def route_spmv(m, route, x):
    """y on ``route``; the Triton kernel runs in the interpreter."""
    if route == "triton":
        return spmv_triton(jnp.asarray(m.row_ptr), jnp.asarray(m.col_ind),
                           jnp.asarray(m.values),
                           jnp.asarray(x, m.values.dtype),
                           nr_rows=m.nr_rows, interpret=True)
    return SparseMatrix(m, backend=route).spmv(x)


def _check(m, route, seed=0):
    x = np.random.default_rng(seed).standard_normal(m.nr_cols)
    y = route_spmv(m, route, x)
    assert y.dtype == m.dtype
    tol = default_tolerance(m.dtype, m.row_nnz())
    assert verification(spmv_gold(m, x.astype(m.dtype)), np.asarray(y),
                        *tol) == 0


@pytest.mark.parametrize("backend", ROUTES)
@pytest.mark.parametrize("shape,density,kwargs", [
    ((64, 64), 0.1, {}),
    ((200, 300), 0.05, {"empty_row_frac": 0.3}),
    ((100, 3000), 0.02, {}),
    ((50, 40000), 0.004, {}),        # wide
    ((500, 100), 0.08, {"powerlaw": True}),
])
def test_spmv_backends(backend, shape, density, kwargs):
    m = random_csr(*shape, density=density, seed=11, dtype=np.float32,
                   **kwargs)
    _check(m, backend)


@pytest.mark.parametrize("backend", ROUTES)
def test_spmv_structured(backend):
    _check(banded_csr(300, 300, bandwidth=5), backend)
    _check(laplace_2d(17), backend)


def test_spmm():
    m = random_csr(60, 80, density=0.1, seed=12)
    x = np.random.default_rng(2).standard_normal((80, 3))
    sm = SparseMatrix(m, backend="xla")
    y = np.asarray(sm.spmm(x))
    assert np.allclose(y, m.to_dense() @ x, atol=1e-12, rtol=1e-12)


def test_matmul_operator():
    m = random_csr(30, 30, density=0.2, seed=13)
    sm = SparseMatrix(m, backend="xla")
    x = np.ones(30)
    assert np.allclose(np.asarray(sm @ x), m.to_dense() @ x,
                       atol=1e-12, rtol=1e-12)


def test_reference_shaped_api():
    """The README.md:34-46 call sequence, reference-style."""
    from sparsetpu.api import (create_csr_hw_matrix, create_csr_hw_x_vector,
                               delete_csr_hw_matrix, delete_csr_hw_x_vector,
                               spmv_hw)
    m = random_csr(40, 50, density=0.1, seed=14)
    hw = create_csr_hw_matrix(m)
    x = np.random.default_rng(4).standard_normal(50)
    hw_x = create_csr_hw_x_vector(hw, x)
    y = np.asarray(spmv_hw(hw, hw_x))
    assert verification(spmv_gold(m, x), y,
                        *default_tolerance(np.float64, m.row_nnz())) == 0
    delete_csr_hw_x_vector(hw_x)
    delete_csr_hw_matrix(hw)


@pytest.mark.parametrize("backend", ROUTES)
def test_heavy_rows(backend):
    """Power-law rows, a few thousands of nonzeros long, next to rows of
    one or two: one program of the Triton kernel walks each long row."""
    from sparsetpu.formats.csr import CSRMatrix
    rng = np.random.default_rng(7)
    r, c = 300, 20000
    nnz_per_row = np.minimum((rng.pareto(1.0, r) * 30).astype(int) + 1, c)
    rows = np.repeat(np.arange(r), nnz_per_row)
    cols = np.concatenate(
        [rng.choice(c, k, replace=False) for k in nnz_per_row])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    m = CSRMatrix.from_coo(rows, cols, vals, r, c)
    assert m.row_nnz().max() > 1000
    _check(m, backend)


def test_transpose_spmv():
    """A.T @ x matches the transposed gold (transpose packed lazily)."""
    m = random_csr(300, 500, density=0.05, seed=70, dtype=np.float32)
    sm = SparseMatrix(m)
    x = np.random.default_rng(8).standard_normal(m.nr_rows)
    y = np.asarray(sm.T.spmv(x))
    mt = m.T
    assert verification(spmv_gold(mt, x.astype(np.float32)), y,
                        *default_tolerance(np.float32, mt.row_nnz())) == 0
    assert sm.T is sm.T          # cached


@pytest.mark.parametrize("seed", range(6))
def test_spmv_fuzz_shapes(seed):
    """Randomized shapes/densities/empty rows on the XLA and cuSPARSE
    routes, f32 and f64."""
    rng = np.random.default_rng(1000 + seed)
    r = int(rng.integers(1, 3000))
    c = int(rng.integers(1, 60000))
    density = float(10 ** rng.uniform(-4, -0.5))
    density = min(density, 4000 / max(r * c, 1) + density * 0.1)
    for dt in (np.float32, np.float64):
        m = random_csr(r, c, density=density, seed=seed, dtype=dt,
                       empty_row_frac=float(rng.uniform(0, 0.4)))
        for route in ("xla", "cusparse"):
            _check(m, route, seed=seed)


def test_bf16_value_mode():
    """bfloat16 value plane: half the value stream, ~8-bit-mantissa
    accuracy, accumulated and returned in float32."""
    import ml_dtypes
    m = random_csr(1000, 2000, density=0.02, seed=71, dtype=np.float32)
    cfg = SpmvConfig(dtype=np.dtype(ml_dtypes.bfloat16))
    sm = SparseMatrix(m, cfg)
    assert sm.values.dtype == jnp.bfloat16
    x = np.random.default_rng(6).standard_normal(m.nr_cols)
    y = np.asarray(sm.spmv(x))
    assert y.dtype == np.float32
    atol, rtol = default_tolerance(cfg.dtype, m.row_nnz())
    assert verification(spmv_gold(m, x), y, atol, rtol) == 0
