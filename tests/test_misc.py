"""Runtime helpers: the compile cache, the peak table, the GPU check, and
the scaling-report plumbing."""

import os

import pytest


def test_scaling_report_single_device():
    from sparsetpu.bench.scaling import scaling_report
    rep = scaling_report(rows_per_dev=2000, nnz_per_row=8,
                         max_devices=1, verbose=False, repeats=2)
    row = rep["weak_scaling"][0]
    assert row["verify_errors"] == 0
    assert row["weak_scaling_eff"] == 1.0
    assert rep["platform"] == "cpu"


@pytest.fixture
def cache_config(monkeypatch):
    """Restores JAX's cache-directory setting after the test."""
    import jax
    old = jax.config.jax_compilation_cache_dir
    yield monkeypatch
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_default_is_fixed_path_in_checkout(cache_config):
    import jax
    from sparsetpu.utils.runtime import (DEFAULT_CACHE_DIR, REPO_ROOT,
                                         enable_compile_cache)
    cache_config.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compile_cache() == DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == DEFAULT_CACHE_DIR
    assert DEFAULT_CACHE_DIR == os.path.join(REPO_ROOT, ".jax_cache")
    with open(os.path.join(REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_honours_environment(cache_config, tmp_path):
    """With the variable set, the helper configures nothing (JAX reads the
    variable itself) and reports that directory."""
    import jax
    from sparsetpu.utils.runtime import enable_compile_cache
    cache_config.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_peak_table_known_kind():
    from types import SimpleNamespace
    from sparsetpu.bench.harness import peak_hbm_bytes_s
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    assert peak_hbm_bytes_s(dev) == 3.35e12


def test_peak_table_unknown_gpu_raises():
    from types import SimpleNamespace
    from sparsetpu.bench.harness import peak_hbm_bytes_s
    with pytest.raises(KeyError, match="no peak"):
        peak_hbm_bytes_s(SimpleNamespace(platform="gpu",
                                         device_kind="Some Other GPU"))


def test_peak_table_cpu_has_no_roofline():
    import jax
    from sparsetpu.bench.harness import peak_hbm_bytes_s
    assert peak_hbm_bytes_s(jax.devices()[0]) is None


def test_require_gpu_fails_on_cpu():
    from sparsetpu.utils.runtime import require_gpu
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()
