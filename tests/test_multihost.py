"""Multi-process scaffolding on the simulated CPU mesh: the per-host
partition + global-array assembly code path runs single-process here (all
devices addressable) and must match both the gold SpMV and the single-host
shard_spmv."""

import numpy as np

from sparsetpu.dist.multihost import shard_spmv_multihost
from sparsetpu.dist.spmv_dist import make_mesh, shard_spmv
from sparsetpu.formats.gold import default_tolerance, spmv_gold, verification
from sparsetpu.formats.random import random_csr


def test_multihost_path_matches_gold():
    m = random_csr(4000, 4000, density=0.003, seed=21, dtype=np.float32)
    sh = shard_spmv_multihost(m, make_mesh(8))
    x = np.random.default_rng(2).standard_normal(m.nr_cols)
    y = np.asarray(sh.spmv(x))
    assert verification(spmv_gold(m, x.astype(np.float32)), y,
                        *default_tolerance(np.float32, m.row_nnz())) == 0


def test_multihost_matches_singlehost():
    m = random_csr(2500, 3000, density=0.004, seed=22, dtype=np.float32)
    mesh = make_mesh(4)
    x = np.random.default_rng(3).standard_normal(m.nr_cols)
    y_mh = np.asarray(shard_spmv_multihost(m, mesh).spmv(x))
    y_sh = np.asarray(shard_spmv(m, mesh).spmv(x))
    np.testing.assert_array_equal(y_mh, y_sh)


def test_multihost_assembles_global_sharding():
    m = random_csr(2000, 2000, density=0.004, seed=23, dtype=np.float32)
    sh = shard_spmv_multihost(m, make_mesh(8))
    # values must be a globally sharded array over the whole mesh
    assert sh.values.shape[0] == 8
    assert len(sh.values.sharding.device_set) == 8


def test_scaling_report_multihost_refuses_gracefully(capsys):
    from sparsetpu.bench.scaling import scaling_report
    rep = scaling_report(rows_per_dev=1500, nnz_per_row=6, max_devices=2,
                         verbose=False, multihost=True, repeats=2)
    out = capsys.readouterr().out
    assert "process_count" in out            # the graceful refusal
    assert all(r["verify_errors"] == 0 for r in rep["weak_scaling"])
    assert rep["platform"] == "cpu"
