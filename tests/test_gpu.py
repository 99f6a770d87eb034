"""Tests that need the card (marker ``gpu``): the compiled routes against
the gold.  They skip here, inside the ``gpu`` fixture; on the card run

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""

import jax
import numpy as np
import pytest

from sparsetpu import SparseMatrix
from sparsetpu.formats import (circuit_netlist, default_tolerance,
                               fem_poisson_3d, random_csr, spmv_gold,
                               verification)

MATRICES = {
    "random": lambda dt: random_csr(3000, 2000, density=0.02, seed=1,
                                    dtype=dt, empty_row_frac=0.1),
    "powerlaw": lambda dt: random_csr(4000, 4000, density=0.002, seed=2,
                                      dtype=dt, powerlaw=True),
    "fem": lambda dt: fem_poisson_3d(12, dtype=dt),
    "netlist": lambda dt: circuit_netlist(20_000, dtype=dt),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["auto", "xla", "cusparse", "triton"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_route_on_card_matches_gold(gpu, route, dtype, name):
    m = MATRICES[name](dtype)
    A = SparseMatrix(m, backend=route)
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    y = A @ x
    assert y.dtype == dtype
    tol = default_tolerance(dtype, m.nr_nzeros / m.nr_rows)
    assert verification(spmv_gold(m, x.astype(dtype)), np.asarray(y),
                        *tol) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["auto", "xla", "cusparse", "triton"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_bf16_values_on_card_match_gold(gpu, route, name):
    import ml_dtypes
    from sparsetpu.utils.config import SpmvConfig
    m = MATRICES[name](np.float32)
    cfg = SpmvConfig(dtype=np.dtype(ml_dtypes.bfloat16))
    A = SparseMatrix(m, cfg, backend=route)
    assert A.values.dtype == cfg.dtype
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    y = A @ x
    assert y.dtype == np.float32
    tol = default_tolerance(cfg.dtype, m.row_nnz())
    assert verification(spmv_gold(m, x.astype(np.float32)), np.asarray(y),
                        *tol) == 0


@pytest.mark.gpu
def test_cusparse_custom_call_compiled(gpu):
    from sparsetpu.kernels.spmv_cusparse import uses_cusparse
    m = random_csr(500, 400, density=0.02, seed=3, dtype=np.float32)
    A = SparseMatrix(m, backend="cusparse")
    text = jax.jit(lambda a, v: a.spmv(v)).lower(
        A, A.prepare_x(np.ones(400))).compile().as_text()
    assert uses_cusparse(text)


@pytest.mark.gpu
def test_peak_table_knows_this_card(gpu):
    from sparsetpu.bench.harness import peak_hbm_bytes_s
    assert peak_hbm_bytes_s(gpu) > 1e12
