"""Row-sharded SpMV over a device mesh (all-gather of x, local CSR route)."""

from .spmv_dist import ShardedSpmv, make_mesh, shard_spmv

__all__ = ["ShardedSpmv", "make_mesh", "shard_spmv"]
