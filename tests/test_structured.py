"""Structured real-pattern generators + the SpMV route choice.

The suite's air-gap mitigation: deterministic
generators whose patterns match the named SuiteSparse classes —
clustered FEM bands (fem_poisson_3d), wrapped shell bands (shell_3d,
shipsec1 class), netlist scatter with hub rails (circuit_netlist,
scircuit class) — so structure-sensitive pack models meet non-i.i.d.
inputs even offline (/root/reference/README.md:23-29 is file-driven)."""

import numpy as np
import pytest

from sparsetpu.api.api import SparseMatrix
from sparsetpu.formats import (circuit_netlist, fem_poisson_3d, laplace_2d,
                               shell_3d, spmv_gold)
from sparsetpu.utils.config import SpmvConfig


def test_shell_3d_structure():
    m = shell_3d(16, 24, 3, dof=3)
    # dense 3x3 dof blocks over a 27-point shell stencil: interior rows
    # hold 81 nnz; every row is a multiple of 3 wide (dof columns)
    rn = m.row_nnz()
    assert rn.max() == 81
    assert m.nr_rows == 16 * 24 * 3 * 3
    # circumferential wrap: some couplings span nearly the full ring
    # (|col - row| large), unlike a plain banded matrix
    coo = m.to_coo()
    span = np.abs(coo.col_ind.astype(np.int64)
                  - coo.row_ind.astype(np.int64))
    assert span.max() > m.nr_rows // 4
    # symmetric pattern (structural)
    s = m.to_scipy()
    assert (s != s.T).nnz == 0


def test_circuit_netlist_structure():
    m = circuit_netlist(20_000, seed=3)
    rn = m.row_nnz()
    # scattered profile: a few nnz per row, hub rows in the hundreds
    assert 3.0 < m.nr_nzeros / m.nr_rows < 8.0
    assert rn.max() > 20
    # pattern-symmetric (netlist values needn't be, like the original)
    s = m.to_scipy()
    s.data[:] = 1.0
    assert (s != s.T).nnz == 0


@pytest.mark.parametrize("gen", [
    lambda: shell_3d(12, 16, 3, dtype=np.float32),
    lambda: circuit_netlist(15_000, dtype=np.float32, seed=1),
])
def test_structured_spmv_matches_gold(gen):
    m = gen()
    sm = SparseMatrix(m, SpmvConfig(dtype=np.float32))
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    y = np.asarray(sm.spmv(x))
    g = spmv_gold(m, x)
    np.testing.assert_allclose(y, g, rtol=2e-4, atol=2e-4)


def test_suite_includes_structured_rows():
    from sparsetpu.bench.suite import _structured_suite
    s = _structured_suite()
    assert {"FEM-3D-poisson", "shell-3d", "netlist"} <= set(s)


def _standin_like_rows():
    from sparsetpu.formats.random import random_csr
    return {
        "fem": fem_poisson_3d(10),
        "laplace": laplace_2d(30),
        "headline_like": random_csr(2000, 1000, 0.05, seed=1),
        "netlist": circuit_netlist(20_000, seed=3),
        "powerlaw": random_csr(3000, 3000, 0.002, seed=2, powerlaw=True),
        # uniform rows of up to 54, longer than the measured class
        "shell_dof2": shell_3d(16, 24, 3, dof=2),
    }


@pytest.mark.parametrize("name,uniform", [
    ("fem", True), ("laplace", True), ("headline_like", False),
    ("netlist", False), ("powerlaw", False), ("shell_dof2", False)])
def test_uniform_short_rows_classifies_structure(name, uniform):
    from sparsetpu.kernels.spmv_triton import uniform_short_rows
    m = _standin_like_rows()[name]
    assert uniform_short_rows(m.row_nnz()) is uniform


@pytest.mark.parametrize("name,values,route", [
    ("fem", "float32", "triton"), ("headline_like", "float32", "cusparse"),
    ("netlist", "float32", "cusparse"), ("fem", "bfloat16", "triton"),
    ("headline_like", "bfloat16", "triton"),
    ("netlist", "bfloat16", "cusparse"),
    ("powerlaw", "bfloat16", "cusparse")])
def test_auto_route_on_gpu(monkeypatch, name, values, route):
    """On a GPU "auto" takes the Triton kernel for uniform short rows and
    cuSPARSE for the rest; with bf16 values, whose widening costs cuSPARSE
    6 B per nonzero, the Triton class takes longer uniform rows too (the
    H100 route table in PERF.md)."""
    import jax
    import ml_dtypes
    from sparsetpu.api.api import choose_route
    from sparsetpu.kernels import spmv_cusparse
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    # the CPU cannot compile the cuSPARSE call this check looks for
    monkeypatch.setattr(spmv_cusparse, "require_cusparse", lambda *a: None)
    vdt = ml_dtypes.bfloat16 if values == "bfloat16" else np.float32
    cfg = SpmvConfig(dtype=np.dtype(vdt))
    assert choose_route(_standin_like_rows()[name], config=cfg) == route


def test_auto_route_on_cpu_is_xla():
    from sparsetpu.api.api import choose_route
    m = fem_poisson_3d(4)
    assert choose_route(m) == "xla"
    assert SparseMatrix(m).route == "xla"


def test_route_names_are_checked():
    from sparsetpu.api.api import choose_route
    m = fem_poisson_3d(4)
    with pytest.raises(ValueError, match="backend"):
        choose_route(m, "pallas")
    with pytest.raises(ValueError, match="GPU"):
        SparseMatrix(m, backend="triton")
