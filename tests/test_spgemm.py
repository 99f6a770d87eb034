"""SpGEMM vs the scipy oracle (golden-model differential testing,
SURVEY.md section 4 item 1, extended to the SpGEMM capability of
BASELINE.json)."""

import numpy as np
import pytest

from sparsetpu.formats import random_csr, spgemm_gold
from sparsetpu.kernels.spgemm import SpGEMMPlan, spgemm


def _assert_csr_close(c, g, tol=1e-12):
    assert c.nr_rows == g.nr_rows and c.nr_cols == g.nr_cols
    gs = g.to_scipy().tocsr()
    gs.sum_duplicates()
    gs.sort_indices()          # scipy SpGEMM leaves indices unsorted
    np.testing.assert_array_equal(c.row_ptr, gs.indptr)
    np.testing.assert_array_equal(c.col_ind, gs.indices)
    np.testing.assert_allclose(c.values, gs.data, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape_a,shape_b,da,db", [
    ((200, 300), (300, 150), 0.05, 0.05),
    ((64, 64), (64, 64), 0.2, 0.2),
    ((500, 100), (100, 800), 0.02, 0.03),
])
def test_spgemm_matches_gold(shape_a, shape_b, da, db):
    a = random_csr(*shape_a, density=da, seed=31)
    b = random_csr(*shape_b, density=db, seed=32)
    c = spgemm(a, b)
    _assert_csr_close(c, spgemm_gold(a, b))


def test_spgemm_plan_reuse_new_b_values():
    """Same B structure, new values: one device SpMV, no re-pack."""
    a = random_csr(100, 80, density=0.1, seed=33)
    b = random_csr(80, 120, density=0.1, seed=34)
    plan = SpGEMMPlan(a, b)
    for seed in (0, 1):
        vals = np.random.default_rng(seed).standard_normal(
            b.nr_nzeros)
        b2 = type(b)(b.row_ptr, b.col_ind, vals, b.nr_rows, b.nr_cols)
        c = plan.to_csr(np.asarray(plan(vals)))
        _assert_csr_close(c, spgemm_gold(a, b2))


def test_spgemm_empty_result():
    # A's columns never hit a nonzero row of B
    from sparsetpu.formats.csr import CSRMatrix
    a = CSRMatrix.from_coo(np.array([0]), np.array([0]),
                           np.array([1.0], np.float32), 4, 5)
    b = CSRMatrix.from_coo(np.array([3]), np.array([2]),
                           np.array([1.0], np.float32), 5, 6)
    c = spgemm(a, b)
    assert c.nr_nzeros == 0
    assert c.nr_rows == 4 and c.nr_cols == 6


def test_spgemm_dimension_mismatch():
    a = random_csr(10, 20, density=0.2, seed=1)
    b = random_csr(30, 10, density=0.2, seed=2)
    with pytest.raises(ValueError):
        spgemm(a, b)


def test_sparse_at_sparse_operator():
    from sparsetpu.api.api import SparseMatrix
    a = random_csr(60, 40, density=0.15, seed=5, dtype=np.float32)
    b = random_csr(40, 50, density=0.15, seed=6, dtype=np.float32)
    A = SparseMatrix(a)
    c = A @ b
    assert c.values.dtype == np.float32
    _assert_csr_close(c, spgemm_gold(a, b), tol=1e-5)
