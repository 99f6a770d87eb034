"""ctypes bindings to the native host runtime (libsparsetpu_native.so).

Falls back by raising ImportError-style exceptions that callers catch.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_NAME = "libsparsetpu_native.so"


def _lib():
    global _LIB
    if _LIB is None:
        here = os.path.dirname(__file__)
        path = os.path.join(here, _LIB_NAME)
        if not os.path.exists(path) and os.environ.get(
                "SPARSETPU_AUTOBUILD", "1") not in ("0", "false", "no"):
            # first use on a fresh checkout: build in place.  Gate with
            # SPARSETPU_AUTOBUILD=0 for sandboxed/production environments
            # (ADVICE r1: a silent import-time `make` can mask a broken
            # toolchain); build failures warn with the captured stderr.
            import subprocess
            import warnings
            try:
                subprocess.run(["make", "-C", here], check=True,
                               capture_output=True, timeout=120)
            except subprocess.CalledProcessError as e:
                warnings.warn(
                    "sparsetpu native auto-build failed (falling back to "
                    "the NumPy parser):\n"
                    + e.stderr.decode(errors="replace")[-2000:],
                    RuntimeWarning)
            except Exception as e:
                warnings.warn(
                    f"sparsetpu native auto-build failed: {e!r} (falling "
                    "back to the NumPy parser)", RuntimeWarning)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{_LIB_NAME} not built; run `make -C sparsetpu/native` "
                "(or set SPARSETPU_AUTOBUILD=1)")
        lib = ctypes.CDLL(path)
        lib.stpu_count_triplets.restype = ctypes.c_longlong
        lib.stpu_count_triplets.argtypes = [ctypes.c_char_p]
        lib.stpu_read_triplets.restype = ctypes.c_longlong
        lib.stpu_read_triplets.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_longlong,
        ]
        _LIB = lib
    return _LIB


def read_triplets(path: str, pattern: bool = False):
    """Parse a triplet/.mtx body natively; returns (rows, cols, vals) as
    0-based numpy arrays (the 1-based conversion of csr.cpp:118 included)."""
    lib = _lib()
    cpath = path.encode()
    n = lib.stpu_count_triplets(cpath)
    if n < 0:
        raise IOError(f"native loader failed to open {path!r}")
    rows = np.empty(n, dtype=np.int32)
    cols = np.empty(n, dtype=np.int32)
    vals = np.empty(n, dtype=np.float64)
    got = lib.stpu_read_triplets(
        cpath, ctypes.c_int(1 if pattern else 0),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
    if got < 0:
        raise IOError(f"native loader failed parsing {path!r}")
    return rows[:got], cols[:got], vals[:got]
