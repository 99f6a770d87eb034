"""Reference-parity packed format: bit layout, round-trip, emulated SpMV."""

import numpy as np
import pytest

from sparsetpu.formats import random_csr, spmv_gold, verification
from sparsetpu.pack.blocked import (pack_blocked, print_wide,
                                    spmv_blocked_emulated, unpack_stream,
                                    write_hw_x_vector, _ratio_col_val)
from sparsetpu.utils import SpmvConfig


@pytest.mark.parametrize("dtype,period", [(np.float64, 5), (np.float32, 3)])
def test_stream_period(dtype, period):
    # RATIO_col_val: 5 for f64, 3 for f32 (util.h:67)
    assert _ratio_col_val(dtype) == period


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("partitions,vf", [(1, 1), (2, 4), (4, 8), (12, 8)])
def test_blocked_pack_emulated_spmv(dtype, partitions, vf):
    m = random_csr(300, 40000, density=0.003, seed=40, dtype=dtype,
                   empty_row_frac=0.2)  # 2 column blocks at 32768
    cfg = SpmvConfig(dtype=dtype, num_partitions=partitions)
    hw = pack_blocked(m, cfg, vf=vf)
    assert hw.nr_blocks == 2
    assert hw.num_partitions == partitions
    x = np.random.default_rng(1).standard_normal(m.nr_cols).astype(dtype)
    y = spmv_blocked_emulated(hw, x)
    tol = 1e-5 if dtype == np.float64 else 1e-3
    assert verification(spmv_gold(m, x), y, diff_thres=tol,
                        rel_thres=tol) == 0


def test_blocked_bit_layout():
    """15-bit local col + end-of-row flag in bit 15 (csr_hw.cpp:288-292)."""
    from sparsetpu.formats import CSRMatrix
    rows = np.array([0, 0, 1])
    cols = np.array([5, 700, 32768 + 9])  # block 0 and block 1
    vals = np.array([1.0, 2.0, 3.0])
    m = CSRMatrix.from_coo(rows, cols, vals, 2, 40000)
    hw = pack_blocked(m, SpmvConfig(dtype=np.float64), vf=1)
    sub0 = hw.submatrices[0][0]
    local, eor, v = unpack_stream(sub0, np.dtype(np.float64))
    assert local[0] == 5 and not eor[0]
    assert local[1] == 700 and eor[1]       # row 0 ends
    sub1 = hw.submatrices[0][1]
    local, eor, v = unpack_stream(sub1, np.dtype(np.float64))
    assert local[0] == 9 and eor[0]         # rebased col (thres_l = 32768)
    assert v[0] == 3.0
    # empty-rows bitmap: row 1 empty in block 0, row 0 empty in block 1
    assert hw.empty_rows_bitmap[0][1] and not hw.empty_rows_bitmap[0][0]
    assert hw.empty_rows_bitmap[1][0] and not hw.empty_rows_bitmap[1][1]
    assert "*" in print_wide(sub0, np.dtype(np.float64))


def test_write_hw_x_vector_pads():
    x = np.arange(5, dtype=np.float64)
    hx = write_hw_x_vector(x, 2, 4, np.float64)
    assert hx.shape == (2, 4)
    assert np.allclose(hx.reshape(-1)[:5], x)
    assert (hx.reshape(-1)[5:] == 0).all()  # csr_hw.cpp:1480-1481


def test_storage_overhead_reported():
    m = random_csr(200, 1000, density=0.05, seed=41)
    hw = pack_blocked(m, SpmvConfig(dtype=np.float64), vf=1)
    assert 0.5 < hw.storage_overhead() < 3.0


def test_blocked_rejects_bad_knobs():
    m = random_csr(20, 100, density=0.1, seed=43)
    with pytest.raises(ValueError, match="vf"):
        pack_blocked(m, vf=3)
    with pytest.raises(ValueError, match="block_cols"):
        pack_blocked(m, block_cols=1 << 16)


@pytest.mark.parametrize("block_cols", [512, 4096])
def test_blocked_narrow_blocks(block_cols):
    """COLS_DIV_BLOCKS narrower than the 15-bit bound: more blocks, the
    same product."""
    m = random_csr(100, 5000, density=0.01, seed=44)
    hw = pack_blocked(m, vf=2, block_cols=block_cols)
    assert hw.nr_blocks == -(-5000 // block_cols)
    x = np.random.default_rng(2).standard_normal(m.nr_cols)
    assert verification(spmv_gold(m, x), spmv_blocked_emulated(hw, x),
                        diff_thres=1e-12, rel_thres=1e-12) == 0
