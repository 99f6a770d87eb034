"""Pack engine: the reference format's scan, and row balancing."""

import numpy as np

from sparsetpu.formats import random_csr
from sparsetpu.pack import balance_rows, scan_matrix


def test_scan_matrix_counts():
    m = random_csr(40, 5000, density=0.05, seed=7)
    s = scan_matrix(m, vf=4, block_cols=2048)
    assert s.nr_blocks == 3
    assert s.block_row_nnz.sum() == m.nr_nzeros
    # padded counts: multiples of vf, >= raw
    assert (s.block_row_nnz_padded % 4 == 0).all()
    assert (s.block_row_nnz_padded >= s.block_row_nnz).all()
    assert s.expanded_nr_nzeros >= m.nr_nzeros
    # bitmap marks exactly the zero cells (csr_hw.cpp:340-347 semantics)
    assert (s.empty_rows_bitmap == (s.block_row_nnz == 0)).all()


def test_balance_rows():
    m = random_csr(1000, 100, density=0.05, seed=8, powerlaw=True)
    p = balance_rows(m, 4)
    assert p.nnz.sum() == m.nr_nzeros
    assert (p.row_end >= p.row_start).all()
    assert p.row_end[-1] == m.nr_rows
    ideal = m.nr_nzeros / 4
    assert p.nnz.max() <= 2.5 * ideal  # loose: contiguous split limit


def test_device_checkpoint_roundtrip(tmp_path):
    """save_device/load_device resume without re-reading the matrix file:
    the device CSR is the checkpoint-able artifact."""
    from sparsetpu.api.api import SparseMatrix
    from sparsetpu.formats import default_tolerance, spmv_gold, verification
    from sparsetpu.pack.serialize import load_device, save_device

    m = random_csr(2000, 3000, density=0.01, seed=77, dtype=np.float32)
    sm = SparseMatrix(m)
    path = str(tmp_path / "dev.npz")
    save_device(path, sm)
    d2 = load_device(path)
    x = np.random.default_rng(5).standard_normal(m.nr_cols)
    y = np.asarray(d2.spmv_packed_x(d2.prepare_x(x)))
    assert verification(spmv_gold(m, x.astype(np.float32)), y,
                        *default_tolerance(np.float32, m.row_nnz())) == 0
