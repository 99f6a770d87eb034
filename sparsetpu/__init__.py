"""sparsetpu — a sparse linear-algebra library in JAX for NVIDIA GPUs.

Built from scratch against the capability set of euroexa/spmv-fpga (a Xilinx
ZCU102 HLS SpMV accelerator): CSR SpMV with nnz-balanced row partitioning,
golden-model verification and phase-timed benchmarking, extended with SpMM,
SpGEMM, BSR, iterative solvers and row-sharded multi-GPU products.

Layer map (SURVEY.md section 7):
  formats/   CSR/COO/BSR containers, ingest, CPU golds        (ref L1)
  pack/      row balancing, the reference's FPGA stream format (ref L3)
  kernels/   SpMV routes (XLA, cuSPARSE, Triton), SpGEMM, BSR (ref L2)
  api/       pack()/spmv()/SparseMatrix, route choice         (ref L4)
  dist/      mesh-sharded multi-GPU SpMV (new; ref is 1 board)
  solvers/   CG etc. built on spmv (new)
  bench/     the main.cpp measurement protocol                (ref L5)
"""

__version__ = "0.1.0"

from . import formats, pack, kernels, api, utils
from .api import SparseMatrix, pack as pack_matrix, spmv, unpack
from .formats import (CSRMatrix, COOMatrix, BSRMatrix, read_matrix,
                      spmv_gold, verification)
from .kernels import SpGEMMPlan, spgemm
from .utils import SpmvConfig

__all__ = [
    "SparseMatrix", "pack_matrix", "spmv", "unpack", "CSRMatrix",
    "COOMatrix", "BSRMatrix", "read_matrix", "spmv_gold", "verification",
    "SpGEMMPlan", "spgemm", "SpmvConfig", "formats", "pack", "kernels",
    "api", "utils",
]
