"""Format containers, IO round-trips, conversions, gold oracles."""

import numpy as np
import pytest

from sparsetpu.formats import (CSRMatrix, banded_csr, bsr_to_csr, coo_to_csr,
                               csr_to_bsr, csr_to_coo, laplace_2d,
                               random_csr, read_csr_header, read_matrix,
                               spmv_gold, spmm_gold, spgemm_gold,
                               verification, write_matrix)


def test_csr_coo_roundtrip():
    m = random_csr(50, 40, density=0.1, seed=1)
    m2 = coo_to_csr(csr_to_coo(m))
    assert np.array_equal(m.row_ptr, m2.row_ptr)
    assert np.array_equal(m.col_ind, m2.col_ind)
    assert np.allclose(m.values, m2.values)


def test_csr_bsr_roundtrip():
    m = random_csr(64, 300, density=0.05, seed=2)
    b = csr_to_bsr(m, block_shape=(8, 128))
    m2 = bsr_to_csr(b)
    assert np.allclose(m.to_dense(), m2.to_dense())


def test_spmv_gold_matches_dense():
    m = random_csr(37, 23, density=0.2, seed=3, empty_row_frac=0.2)
    x = np.random.default_rng(0).standard_normal(23)
    y = spmv_gold(m, x)
    assert np.allclose(y, m.to_dense() @ x, atol=1e-12)


def test_spmm_spgemm_gold():
    a = random_csr(20, 30, density=0.2, seed=4)
    b = random_csr(30, 25, density=0.2, seed=5)
    x = np.random.default_rng(1).standard_normal((30, 4))
    assert np.allclose(spmm_gold(a, x), a.to_dense() @ x, atol=1e-12)
    c = spgemm_gold(a, b)
    assert np.allclose(c.to_dense(), a.to_dense() @ b.to_dense(), atol=1e-12)


def test_verification_semantics():
    y = np.array([1.0, 2.0, 3.0])
    assert verification(y, y) == 0
    assert verification(y, y + 2e-5) == 3
    assert verification(y, np.array([1.0, np.nan, 3.0])) >= 1


def test_io_roundtrip(tmp_path):
    m = random_csr(30, 30, density=0.15, seed=6, empty_row_frac=0.1)
    p = str(tmp_path / "m.mtx")
    write_matrix(p, m)
    hdr = read_csr_header(p)
    assert (hdr.nr_rows, hdr.nr_cols, hdr.nr_nzeros) == (30, 30, m.nr_nzeros)
    m2 = read_matrix(p, dtype=np.float64, use_native=False)
    assert np.allclose(m.to_dense(), m2.to_dense())


def test_io_reference_triplet_format(tmp_path):
    """The reference's bannerless, 1-based, row-sorted format
    (csr.cpp:87-136), including empty rows."""
    p = str(tmp_path / "ref.txt")
    with open(p, "w") as f:
        f.write("4 3 3\n1 1 1.5\n1 3 2.5\n4 2 -1.0\n")
    m = read_matrix(p, use_native=False)
    d = np.zeros((4, 3))
    d[0, 0], d[0, 2], d[3, 1] = 1.5, 2.5, -1.0
    assert np.allclose(m.to_dense(), d)


def test_io_symmetric(tmp_path):
    p = str(tmp_path / "s.mtx")
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n"
                "3 3 2\n2 1 5.0\n3 3 1.0\n")
    m = read_matrix(p, use_native=False)
    d = np.zeros((3, 3))
    d[1, 0] = d[0, 1] = 5.0
    d[2, 2] = 1.0
    assert np.allclose(m.to_dense(), d)


def test_laplace_and_banded():
    m = laplace_2d(5)
    assert m.nr_rows == 25
    assert np.allclose(m.to_dense(), m.to_dense().T)
    b = banded_csr(20, 20, bandwidth=2)
    assert b.nr_nzeros > 0


def test_default_tolerance_per_dtype():
    from sparsetpu.formats import default_tolerance
    a64, r64 = default_tolerance(np.float64, 16)
    a32, r32 = default_tolerance(np.float32, 16)
    assert a64 == r64 == pytest.approx(4e-12)
    assert a32 == r32 == pytest.approx(4e-5)
    # per-row bounds from an array of row lengths
    rows = np.array([0, 1, 4, 100])
    atol, _ = default_tolerance(np.float32, rows)
    np.testing.assert_allclose(atol, 1e-5 * np.array([1, 1, 2, 10]))


def test_spmv_gold_keeps_small_rows_exact():
    """Row sums are per row: a tiny row after huge ones keeps its digits
    (a running sum over the whole matrix would cancel them away)."""
    m = CSRMatrix.from_coo(np.array([0, 1, 1]), np.array([0, 0, 1]),
                           np.array([1e16, 1.0, 0.5]), 2, 2)
    y = spmv_gold(m, np.array([1.0, 1.0]))
    assert y[0] == 1e16 and y[1] == 1.5
