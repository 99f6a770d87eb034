"""Every SpmvConfig field must be consumed on the main path.

The reference's knobs are compile-time macros (Makefile:13-18) — there a
dead knob is a build error; this is the runtime equivalent: each field
observably changes behaviour.
"""

import dataclasses

import numpy as np
import pytest

from sparsetpu.api.api import SparseMatrix
from sparsetpu.formats.gold import (default_tolerance, spmm_gold, spmv_gold,
                                    verification)
from sparsetpu.formats.random import random_csr
from sparsetpu.utils.config import SpmvConfig


@pytest.fixture(scope="module")
def matrix():
    return random_csr(600, 5000, density=0.01, seed=3)


def _x(m):
    return np.random.default_rng(0).standard_normal(m.nr_cols)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_num_partitions_splits_and_matches_gold(matrix, dtype):
    cfg = SpmvConfig(dtype=dtype, num_partitions=3)
    sm = SparseMatrix(matrix, cfg)
    assert len(sm._parts) == 3
    assert sum(p.nr_rows for p in sm._parts) == matrix.nr_rows
    assert {p.route for p in sm._parts} == {sm.route}
    x = _x(matrix)
    y = np.asarray(sm.spmv(x))
    assert y.dtype == dtype
    m = dataclasses.replace(matrix, values=matrix.values.astype(dtype))
    assert verification(spmv_gold(m, x.astype(dtype)), y,
                        *default_tolerance(dtype, m.row_nnz())) == 0


def test_num_partitions_spmm_and_unpack(matrix):
    sm = SparseMatrix(matrix, SpmvConfig(num_partitions=4))
    X = np.random.default_rng(1).standard_normal((matrix.nr_cols, 4))
    np.testing.assert_allclose(np.asarray(sm.spmm(X)), spmm_gold(matrix, X),
                               rtol=1e-12, atol=1e-12)
    back = sm.unpack()
    assert np.array_equal(back.row_ptr, matrix.row_ptr)
    assert np.array_equal(back.values, matrix.values)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_dtype_sets_storage_and_compute(matrix, dtype):
    import ml_dtypes  # noqa: F401
    sm = SparseMatrix(matrix, SpmvConfig(dtype=np.dtype(dtype)))
    assert sm.values.dtype == np.dtype(dtype)
    want = np.float64 if dtype == "float64" else np.float32
    assert sm.spmv(_x(matrix)).dtype == want


def test_invalid_config_raises():
    with pytest.raises(ValueError):
        SpmvConfig(num_partitions=0)
    with pytest.raises(ValueError):
        SpmvConfig(dtype=np.int32)


def test_every_config_field_is_covered():
    """Meta-test: a new SpmvConfig field must come with a knob test."""
    fields = {f.name for f in dataclasses.fields(SpmvConfig)}
    covered = {"dtype", "num_partitions"}
    assert fields == covered, (
        f"SpmvConfig fields {fields - covered} have no no-silent-noop "
        "test; add one here")
