"""SuiteSparse ingestion: cache/pre-placed file handling, offline
behavior, synthetic stand-ins, and the suite protocol."""

import os

import numpy as np
import pytest

from sparsetpu.formats import suitesparse as ss


@pytest.fixture
def ss_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARSETPU_SS_DIR", str(tmp_path))
    return tmp_path


def test_preplaced_mtx_is_used_without_network(ss_cache):
    mtx = ss_cache / "scircuit.mtx"
    mtx.write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "3 3 4\n1 1 2.0\n2 2 3.0\n3 1 -1.0\n3 3 4.0\n")
    m, is_real = ss.fetch("scircuit")
    assert is_real and m.nr_rows == 3 and m.nr_nzeros == 4
    y = m.to_scipy() @ np.ones(3)
    np.testing.assert_allclose(y, [2.0, 3.0, 3.0])


def test_offline_without_standin_raises(ss_cache, monkeypatch):
    # force-unreachable mirrors: no URL fetch in tests
    monkeypatch.setattr(ss, "MIRRORS",
                        ("http://127.0.0.1:1/{group}/{name}.tar.gz",))
    with pytest.raises(ConnectionError):
        ss.fetch("pwtk")


def test_offline_synthetic_standin(ss_cache, monkeypatch):
    monkeypatch.setattr(ss, "MIRRORS",
                        ("http://127.0.0.1:1/{group}/{name}.tar.gz",))
    m, is_real = ss.fetch("scircuit", allow_synthetic=True)
    info = ss.CLASSIC_SUITE["scircuit"]
    assert not is_real
    assert m.nr_rows == info.rows and m.nr_cols == info.cols
    # nnz within 10% of the published count
    assert abs(m.nr_nzeros - info.nnz) / info.nnz < 0.1


def test_unknown_matrix_needs_group(ss_cache):
    with pytest.raises(KeyError):
        ss.fetch("not_a_matrix")


def test_suite_protocol_on_preplaced(ss_cache):
    # a small real .mtx driven through the full bench protocol
    rng = np.random.default_rng(0)
    n, k = 300, 3000
    rows = rng.integers(0, n, k)
    cols = rng.integers(0, n, k)
    lines = [f"{r+1} {c+1} {rng.standard_normal():.6f}"
             for r, c in zip(rows, cols)]
    (ss_cache / "scircuit.mtx").write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        f"{n} {n} {k}\n" + "\n".join(lines) + "\n")
    from sparsetpu.bench.suite import run_suite
    out = run_suite(["scircuit"], verbose=False)
    assert out[0]["verify"] == "PASS" and out[0]["status"] == "real"
    assert out[0]["gnnz_s"] > 0
