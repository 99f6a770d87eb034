"""Row-sharded SpMV on a simulated 8-device CPU mesh: the same path the
GPUs run (x all-gather, the local CSR route under shard_map)."""

import jax
import numpy as np
import pytest

from sparsetpu.dist.spmv_dist import make_mesh, shard_spmv
from sparsetpu.formats import (default_tolerance, laplace_2d, random_csr,
                               spmv_gold, verification)


@pytest.fixture
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 simulated devices")
    return make_mesh(8)


@pytest.mark.parametrize("backend", ["xla", "cusparse"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,density", [
    ((512, 1024), 0.02),
    ((1000, 3000), 0.01),
])
def test_sharded_spmv_matches_gold(mesh8, shape, density, dtype, backend):
    m = random_csr(*shape, density=density, seed=20, dtype=dtype)
    sh = shard_spmv(m, mesh8, backend=backend)
    assert sh.route == backend
    x = np.random.default_rng(5).standard_normal(m.nr_cols)
    y = sh.spmv(x)
    assert y.dtype == dtype
    assert verification(spmv_gold(m, x.astype(dtype)), np.asarray(y),
                        *default_tolerance(dtype, m.row_nnz())) == 0


def test_sharded_spmv_empty_partitions(mesh8):
    # matrix so small that some partitions get (almost) no rows
    m = random_csr(16, 200, density=0.2, seed=21)
    sh = shard_spmv(m, mesh8)
    x = np.random.default_rng(6).standard_normal(m.nr_cols)
    y = np.asarray(sh.spmv(x))
    assert verification(spmv_gold(m, x), y,
                        *default_tolerance(np.float64, m.row_nnz())) == 0


def test_shards_sit_on_every_device(mesh8):
    m = random_csr(800, 800, density=0.01, seed=22, dtype=np.float32)
    sh = shard_spmv(m, mesh8)
    assert len(sh.values.sharding.device_set) == 8
    assert sh.values.shape[0] == 8 and sh.row_ptr.shape[0] == 8


def test_sharded_matches_single_device(mesh8):
    from sparsetpu import SparseMatrix
    m = random_csr(600, 2000, density=0.02, seed=23)
    x = np.random.default_rng(3).standard_normal(m.nr_cols)
    y1 = np.asarray(shard_spmv(m, mesh8).spmv(x))
    y2 = np.asarray(SparseMatrix(m) @ x)
    np.testing.assert_allclose(y1, y2, rtol=1e-13, atol=1e-13)


def test_sharded_cg_f64(mesh8):
    """8-shard float64 CG on a Laplace system converges to a float64
    residual."""
    from sparsetpu.solvers.cg import cg
    m = laplace_2d(24)     # 576x576 SPD
    sh = shard_spmv(m, mesh8)
    b = np.ones(m.nr_rows)
    res = jax.jit(lambda s, r: cg(s.spmv, r, tol=1e-12, maxiter=600))(sh, b)
    r = b - spmv_gold(m, np.asarray(res.x))
    assert res.x.dtype == np.float64
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-11


def test_dryrun_multichip(mesh8):
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


def test_entry_compiles():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    y = jax.jit(fn)(*args)
    assert y.dtype == np.float32
    assert np.isfinite(np.asarray(y)).all()
