"""Phase timing — the equivalent of util.cpp:3-8 getTimestamp() and the
per-phase wall-clock prints scattered through the reference (main.cpp:61-72,
csr_hw_wrapper.cpp:272-285, csr_hw.cpp:141-143).

Adds what the reference lacks: derived nnz/s, GFLOP/s and roofline fractions,
plus an optional jax.profiler trace context.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


def get_timestamp() -> float:
    """Microsecond-resolution wall clock (util.cpp:3-8 analogue), in seconds."""
    return time.perf_counter()


@dataclass
class PhaseTimer:
    """Collects named phase durations, like the reference's printf timers."""

    phases: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = get_timestamp()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (get_timestamp() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    def ms(self, name: str) -> float:
        return 1e3 * self.phases.get(name, 0.0)

    def report(self) -> str:
        # Mirrors the reference print format: "<phase> execution time <ms> msec"
        lines = [f"{name} execution time {1e3 * sec:.3f} msec"
                 for name, sec in self.phases.items()]
        return "\n".join(lines)


@contextlib.contextmanager
def maybe_profiler_trace(trace_dir: Optional[str]):
    """jax.profiler trace wrapper — the observability layer the reference's
    printf timers stand in for (SURVEY.md section 5)."""
    if trace_dir is None:
        yield
        return
    import jax
    with jax.profiler.trace(trace_dir):
        yield
