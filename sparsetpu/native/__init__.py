"""Native (C++) host-side runtime: the fast matrix-file loader.

The reference's host side is C++ on the Zynq ARM (csr.cpp); here the one
hot host path left native is file parsing, C++ behind ctypes, built by
sparsetpu/native/Makefile.  formats/io.py falls back to the NumPy parser
when the shared library has not been built.
"""

from . import loader  # noqa: F401
