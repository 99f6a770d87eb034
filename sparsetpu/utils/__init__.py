from .config import DEFAULT_CONFIG, SpmvConfig
from .runtime import (device_info, enable_compile_cache,
                      gpu_name_and_power_limit, init_runtime, require_gpu)
from .timing import PhaseTimer, get_timestamp, maybe_profiler_trace

__all__ = [
    "DEFAULT_CONFIG", "SpmvConfig", "PhaseTimer", "get_timestamp",
    "maybe_profiler_trace", "device_info", "enable_compile_cache",
    "gpu_name_and_power_limit", "init_runtime", "require_gpu",
]
