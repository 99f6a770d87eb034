from .spmv_xla import spmv_coo_xla, spmm_coo_xla
from .spgemm import SpGEMMPlan, spgemm

__all__ = ["spmv_coo_xla", "spmm_coo_xla", "SpGEMMPlan", "spgemm"]
