"""Runtime configuration for sparsetpu.

The reference (euroexa/spmv-fpga) configures everything at *compile* time via
Makefile ``-D`` macros (Makefile:13-18 -> util.h:18-59): ``CU`` (compute
units), ``VF`` (vector/unroll factor), ``DOUBLE`` (precision).  Here the
precision and the compute-unit count are one runtime dataclass; the
``#if CU == N`` x6 code replication of the reference collapses to the single
``num_partitions`` integer.  ``VF`` and the column-block width belong to the
FPGA stream format only and are arguments of ``pack.blocked.pack_blocked``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SpmvConfig:
    """The reference build system's run-time knobs, as one object.

    Maps to reference knobs:
      * ``dtype``          <- DOUBLE=0/1 (util.h:18-26): float32 or float64,
                              both computed natively on the device (float64
                              needs ``jax_enable_x64``), or bfloat16: values
                              stored in bf16 and accumulated in float32.
      * ``num_partitions`` <- CU compute units (util.h:41-59): how many
                              nnz-balanced contiguous row partitions the
                              matrix is split into; each runs the same route.
    """

    dtype: np.dtype = np.dtype(np.float64)
    num_partitions: int = 1

    def __post_init__(self):
        if self.num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        d = np.dtype(self.dtype)
        valid = [np.dtype(np.float32), np.dtype(np.float64)]
        try:
            import ml_dtypes
            valid.append(np.dtype(ml_dtypes.bfloat16))
        except ImportError:
            pass
        if d not in valid:
            raise ValueError(
                "dtype must be float32, float64 or bfloat16")
        object.__setattr__(self, "dtype", d)

    @property
    def value_bytes(self) -> int:
        return self.dtype.itemsize

    @property
    def is_double(self) -> bool:
        return self.dtype == np.dtype(np.float64)

    @property
    def is_bf16(self) -> bool:
        return self.dtype.itemsize == 2

    @property
    def compute_dtype(self) -> np.dtype:
        """The dtype x, y and the accumulation use (bf16 values accumulate
        in float32)."""
        return np.dtype(np.float64) if self.is_double \
            else np.dtype(np.float32)


DEFAULT_CONFIG = SpmvConfig()
