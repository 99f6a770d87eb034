from .scan import BlockScan, scan_matrix
from .balance import RowPartition, balance_report, balance_rows

__all__ = [
    "BlockScan", "scan_matrix", "RowPartition", "balance_report",
    "balance_rows",
]
