"""Process set-up shared by every entry point, and the device checks.

``init_runtime`` is the one call each entry point (the CLI, ``bench.py``,
the ``sparsetpu.bench`` modules, ``chip_smoke.py``) makes before its first
JAX operation: it turns on native float64 and points JAX's persistent
compilation cache at a fixed directory.
"""

from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Fixed, git-ignored path inside the checkout: the cache key includes the
# directory, so a path built from a temporary name would never hit.
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself, so nothing is configured); otherwise ``<checkout>/.jax_cache``.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def init_runtime() -> str:
    """Enable float64 and the compilation cache; returns the cache dir."""
    import jax
    jax.config.update("jax_enable_x64", True)
    return enable_compile_cache()


def require_gpu():
    """The first JAX device, which must be a GPU.  There is no CPU
    fallback: a measurement that finds no card fails."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX reports platform {dev.platform!r} "
            f"({dev.device_kind}); this entry point measures the card")
    return dev


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of every card, one line each, as nvidia-smi
    reports them (nvidia-smi is not a JAX process and holds no card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_info() -> dict:
    """Platform, kind and count of the JAX devices, as results name them."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
