"""The CSR device format behind SparseMatrix: matrix cases on every route
and dtype, the pytree contract, checkpoints, reporting and input checks."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsetpu import SparseMatrix, SpmvConfig
from sparsetpu.formats import (CSRMatrix, default_tolerance, fem_poisson_3d,
                               random_csr, spmv_gold, verification)
from sparsetpu.kernels.spmv_triton import spmv_triton

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "fem_poisson8.mtx")


def _empty(dt):
    return CSRMatrix(np.zeros(11, np.int32), np.zeros(0, np.int32),
                     np.zeros(0, dt), 10, 10)


def _heavy(dt):
    """Every 500th row holds 2000 nonzeros, the rest 3."""
    rng = np.random.default_rng(0)
    nr = nc = 3000
    k = np.where(np.arange(nr) % 500, 3, 2000)
    rows = np.repeat(np.arange(nr), k)
    cols = np.concatenate([rng.choice(nc, int(n), replace=False) for n in k])
    return CSRMatrix.from_coo(rows, cols,
                              rng.standard_normal(rows.size).astype(dt),
                              nr, nc)


def _fixture(dt):
    from sparsetpu.formats.io import read_matrix
    return read_matrix(FIXTURE, dtype=dt)


CASES = {
    "empty_rows": lambda dt: random_csr(200, 300, 0.05, seed=1, dtype=dt,
                                        empty_row_frac=0.5),
    "all_empty": _empty,
    "heavy_rows": _heavy,
    "wide": lambda dt: random_csr(40, 60000, 0.002, seed=2, dtype=dt),
    "tall": lambda dt: random_csr(5000, 30, 0.1, seed=3, dtype=dt),
    "one_row": lambda dt: random_csr(1, 500, 0.1, seed=4, dtype=dt),
    "one_col": lambda dt: random_csr(700, 1, 0.5, seed=5, dtype=dt),
    "dense_block": lambda dt: random_csr(128, 128, 0.9, seed=6, dtype=dt),
    "powerlaw": lambda dt: random_csr(2000, 2000, 0.004, seed=7, dtype=dt,
                                      powerlaw=True),
    "fem_generator": lambda dt: fem_poisson_3d(6, dtype=dt),
    "fem_fixture_file": _fixture,
}


def _spmv(m, route, x):
    if route == "triton-interpret":
        return spmv_triton(jnp.asarray(m.row_ptr), jnp.asarray(m.col_ind),
                           jnp.asarray(m.values), jnp.asarray(x),
                           nr_rows=m.nr_rows, interpret=True)
    return SparseMatrix(m, backend=route).spmv(x)


@pytest.mark.parametrize("route", ["xla", "cusparse", "triton-interpret"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matrix_case_matches_gold(case, dtype, route):
    m = CASES[case](dtype)
    x = np.random.default_rng(9).standard_normal(m.nr_cols).astype(dtype)
    y = _spmv(m, route, x)
    assert y.dtype == dtype and y.shape == (m.nr_rows,)
    tol = default_tolerance(dtype, m.row_nnz())
    assert verification(spmv_gold(m, x), np.asarray(y), *tol) == 0


def test_fem_fixture_file_structure():
    m = _fixture(np.float32)
    assert m.nr_rows == 512 and m.nr_nzeros > 8000
    d = m.to_dense()
    assert np.allclose(d, d.T)


def test_fem_generator_structure():
    m = fem_poisson_3d(6)
    assert m.nr_rows == 216
    d = m.to_dense()
    assert np.allclose(d, d.T)              # symmetric
    assert (np.linalg.eigvalsh(d) > 0).all()  # SPD


@pytest.mark.parametrize("block_rows,width", [(8, 4), (32, 16), (16, 64)])
def test_triton_tiles(block_rows, width):
    """Tiles smaller and larger than the rows: multi-step loops, partial
    last blocks and masked tails."""
    m = random_csr(333, 900, 0.03, seed=8, dtype=np.float32,
                   powerlaw=True, empty_row_frac=0.2)
    x = np.random.default_rng(1).standard_normal(900).astype(np.float32)
    y = spmv_triton(jnp.asarray(m.row_ptr), jnp.asarray(m.col_ind),
                    jnp.asarray(m.values), jnp.asarray(x), nr_rows=333,
                    block_rows=block_rows, width=width, interpret=True)
    tol = default_tolerance(np.float32, m.row_nnz())
    assert verification(spmv_gold(m, x), np.asarray(y), *tol) == 0


def test_triton_bf16_values_accumulate_f32():
    import ml_dtypes
    m = random_csr(300, 400, 0.05, seed=9, dtype=np.float32)
    x = np.random.default_rng(2).standard_normal(400).astype(np.float32)
    y = spmv_triton(jnp.asarray(m.row_ptr), jnp.asarray(m.col_ind),
                    jnp.asarray(m.values.astype(ml_dtypes.bfloat16)),
                    jnp.asarray(x), nr_rows=300, interpret=True)
    assert y.dtype == np.float32
    tol = default_tolerance(np.dtype(ml_dtypes.bfloat16), m.row_nnz())
    assert verification(spmv_gold(m, x), np.asarray(y), *tol) == 0


@pytest.mark.parametrize("route", ["xla", "cusparse"])
def test_through_jit_as_pytree(route):
    m = random_csr(400, 2000, density=0.01, seed=2)
    A = SparseMatrix(m, backend=route)
    x = np.random.default_rng(3).standard_normal(m.nr_cols)
    y = jax.jit(lambda a, v: a.spmv(v))(A, x)
    assert y.dtype == np.float64
    assert verification(spmv_gold(m, x), np.asarray(y),
                        *default_tolerance(np.float64, m.row_nnz())) == 0


def test_pytree_reconstructed_handle_unpacks():
    """A handle rebuilt from its leaves (as jit does) holds the CSR arrays
    themselves, so unpack and transpose still work."""
    m = random_csr(300, 3000, density=0.01, seed=1)
    leaves, treedef = jax.tree_util.tree_flatten(SparseMatrix(m))
    sm2 = jax.tree_util.tree_unflatten(treedef, leaves)
    m2 = sm2.unpack()
    assert np.array_equal(m2.row_ptr, m.row_ptr)
    assert np.array_equal(m2.col_ind, m.col_ind)
    assert np.array_equal(m2.values, m.values)
    assert sm2.T.shape == (3000, 300)


@pytest.mark.parametrize("dtype,parts", [("float32", 1), ("float64", 1),
                                         ("bfloat16", 1), ("float64", 3)])
def test_serialize_roundtrip(tmp_path, dtype, parts):
    import ml_dtypes  # noqa: F401
    from sparsetpu.pack.serialize import load_device, save_device
    m = random_csr(500, 3000, density=0.01, seed=0)
    sm = SparseMatrix(m, SpmvConfig(dtype=np.dtype(dtype),
                                    num_partitions=parts))
    path = str(tmp_path / "m.npz")
    save_device(path, sm)
    sm2 = load_device(path)
    assert sm2.config == sm.config and sm2.route == sm.route
    x = np.random.default_rng(1).standard_normal(m.nr_cols)
    assert np.array_equal(np.asarray(sm2 @ x), np.asarray(sm @ x))


def test_serialize_rejects_other_files(tmp_path):
    from sparsetpu.pack.serialize import load_device, save_device
    with pytest.raises(TypeError):
        save_device(str(tmp_path / "x.npz"), object())
    np.savez(str(tmp_path / "y.npz"), a=np.zeros(3))
    with pytest.raises(ValueError, match="checkpoint"):
        load_device(str(tmp_path / "y.npz"))


def test_reporting_is_plain_csr():
    m = random_csr(1000, 800, density=0.01, seed=3, dtype=np.float32)
    sm = SparseMatrix(m, backend="cusparse")
    assert sm.fill_factor() == 1.0
    # values + col_ind + row_ptr + the row ids SpMM reads
    assert sm.storage_bytes() == (m.nr_nzeros * 12 + 4 * (m.nr_rows + 1))
    assert sm.storage_overhead() > 1.0
    # an SpMV on cuSPARSE moves values, col_ind, row_ptr, x and y
    assert sm.spmv_bytes() == (m.nr_nzeros * 8 + 4 * (m.nr_rows + 1)
                               + 4 * (m.nr_rows + m.nr_cols))
    xla = SparseMatrix(m, backend="xla")
    assert xla.spmv_bytes() == (m.nr_nzeros * 12
                                + 4 * (m.nr_rows + m.nr_cols))


@pytest.mark.parametrize("route,per_nnz", [("xla", 10), ("cusparse", 14)])
def test_spmv_bytes_of_bf16_values(route, per_nnz):
    """bf16 values: 2 B read per nonzero; cuSPARSE also writes and reads
    a float32 copy of them on each call."""
    import ml_dtypes
    m = random_csr(200, 300, density=0.05, seed=5, dtype=np.float32)
    cfg = SpmvConfig(dtype=np.dtype(ml_dtypes.bfloat16))
    sm = SparseMatrix(m, cfg, backend=route)
    ptr = 4 * (m.nr_rows + 1) if route == "cusparse" else 0
    assert sm.spmv_bytes() == (m.nr_nzeros * per_nnz + ptr
                               + 4 * (m.nr_rows + m.nr_cols))


def test_require_cusparse_refuses_the_generic_lowering(monkeypatch):
    """On a GPU a cuSPARSE route whose program lacks the custom call is
    refused; the CPU's generic lowering stands in for that case here."""
    from sparsetpu.kernels.spmv_cusparse import require_cusparse
    f32 = np.dtype(np.float32)
    require_cusparse(f32, f32)                    # CPU: nothing to check
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(RuntimeError, match="does not compile to cuSPARSE"):
        require_cusparse.__wrapped__(f32, f32)


def test_f32_stays_f32_under_x64():
    m = random_csr(100, 100, density=0.05, seed=4, dtype=np.float32)
    sm = SparseMatrix(m)
    x = np.random.default_rng(0).standard_normal(100)   # float64 input
    assert sm.spmv(x).dtype == np.float32
    assert sm.spmm(np.ones((100, 2))).dtype == np.float32


def test_float64_without_x64_raises():
    m = random_csr(50, 50, density=0.1, seed=5)
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.raises(ValueError, match="jax_enable_x64"):
            SparseMatrix(m)
    finally:
        jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("bad", ["col_range", "row_ptr", "x_shape"])
def test_rejects_malformed_input(bad):
    m = random_csr(20, 30, density=0.2, seed=6)
    if bad == "col_range":
        with pytest.raises(ValueError, match="column"):
            SparseMatrix(CSRMatrix(m.row_ptr, m.col_ind + 30, m.values,
                                   20, 30))
    elif bad == "row_ptr":
        with pytest.raises(ValueError, match="row_ptr"):
            SparseMatrix(_bad_row_ptr(m))
    else:
        with pytest.raises(ValueError, match="does not fit"):
            SparseMatrix(m).spmv(np.ones(29))


def _bad_row_ptr(m):
    rp = m.row_ptr.copy()
    rp[5], rp[6] = rp[6], rp[5] - 1          # decreasing
    return CSRMatrix(rp, m.col_ind, m.values, m.nr_rows, m.nr_cols)
