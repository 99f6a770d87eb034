"""Device-matrix checkpoint: save and restore a ``SparseMatrix``.

The reference rebuilds hw_matrix on every run and reports repack time as a
first-class cost (main.cpp:67-72).  The device format here is plain CSR, so
the checkpoint is the CSR arrays plus the configuration, in an ``.npz``
archive with a format version.
"""

from __future__ import annotations

import numpy as np

FORMAT = "sparsetpu-csr"
VERSION = 1


def save_device(path: str, matrix) -> None:
    """Write a SparseMatrix (any route, any partition count)."""
    from ..api.api import SparseMatrix
    if not isinstance(matrix, SparseMatrix):
        raise TypeError(
            f"save_device takes a SparseMatrix, got {type(matrix).__name__}")
    csr = matrix.unpack()
    np.savez_compressed(
        path, format=np.array(FORMAT), version=np.array(VERSION),
        shape=np.array([csr.nr_rows, csr.nr_cols], np.int64),
        row_ptr=csr.row_ptr, col_ind=csr.col_ind, values=csr.values,
        dtype=np.array(matrix.config.dtype.name),
        num_partitions=np.array(matrix.config.num_partitions))


def load_device(path: str, backend: str = "auto"):
    """Restore a SparseMatrix written by ``save_device``; the route is
    chosen anew for the current device (``backend`` as in SparseMatrix)."""
    import ml_dtypes  # noqa: F401  (registers "bfloat16" with numpy)

    from ..api.api import SparseMatrix
    from ..formats.csr import CSRMatrix
    from ..utils.config import SpmvConfig
    with np.load(path, allow_pickle=False) as z:
        if "format" not in z or str(z["format"]) != FORMAT:
            raise ValueError(f"{path} is not a {FORMAT} checkpoint")
        if int(z["version"]) != VERSION:
            raise ValueError(f"{path}: unsupported checkpoint version "
                             f"{int(z['version'])} (expected {VERSION})")
        nr, nc = (int(v) for v in z["shape"])
        csr = CSRMatrix(z["row_ptr"], z["col_ind"], z["values"], nr, nc)
        cfg = SpmvConfig(dtype=np.dtype(str(z["dtype"])),
                         num_partitions=int(z["num_partitions"]))
    return SparseMatrix(csr, cfg, backend=backend)
