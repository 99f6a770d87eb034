"""Multi-device row-sharded SpMV (mesh + shard_map).

The reference targets a single ZCU102 board: its only "communication" is
PS<->PL DMA (spmv.h:7-21 pragmas) and a host-side accumulation loop
(csr_hw_wrapper.cpp:277-281).  Here matrix rows are nnz-balanced across
devices (the compute-unit partitioning of csr_hw.cpp:459-468 lifted to the
mesh axis).  Each shard is a CSR matrix padded to a uniform row and nnz
count, so one SPMD program serves every shard: x, sharded by column, is
all-gathered (XLA hands the collective to NCCL on GPUs), each device runs
the same local route as ``SparseMatrix``, and the partial y vectors are
already disjoint (row sharding), so no reduction is needed.  The CPU mesh
of the tests and the GPUs run this one path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..api.api import choose_route, route_spmv
from ..formats.csr import CSRMatrix
from ..pack.balance import RowPartition, balance_rows
from ..utils.config import SpmvConfig


def make_mesh(n_devices: Optional[int] = None, axis: str = "rows") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


@dataclasses.dataclass
class ShardedSpmv:
    """Row-sharded CSR matrix bound to a mesh.

    Arrays carry a leading shard axis of length P, sharded over the mesh:
    ``row_ptr`` (P, rows_per_part + 1), ``col_ind`` / ``values`` /
    ``row_ids`` (P, nnz_per_part).  Padding rows are empty and padding
    nonzeros carry the value 0.
    """

    mesh: Mesh
    axis: str
    nr_rows: int
    nr_cols: int
    nr_nzeros: int
    row_starts: np.ndarray          # (P,) global row offset per partition
    rows_per_part: int
    x_len: int                      # nr_cols padded to a multiple of P
    dtype: np.dtype
    route: str
    row_ptr: jax.Array
    col_ind: jax.Array
    values: jax.Array
    row_ids: Optional[jax.Array]

    @property
    def num_partitions(self) -> int:
        return int(self.values.shape[0])

    def spmv(self, x) -> jax.Array:
        x = jnp.asarray(x, dtype=self.dtype)
        x = jnp.pad(x, (0, self.x_len - self.nr_cols))
        y = _sharded_spmv_jit(
            self.row_ptr, self.col_ind, self.values, self.row_ids, x,
            mesh=self.mesh, axis=self.axis, route=self.route,
            shape=(self.rows_per_part, self.nr_cols))
        return _gather_rows(y, self.row_starts, self.nr_rows)


def _shspmv_flatten(s):
    children = (s.row_ptr, s.col_ind, s.values, s.row_ids)
    aux = (s.mesh, s.axis, s.nr_rows, s.nr_cols, s.nr_nzeros,
           tuple(int(v) for v in s.row_starts), s.rows_per_part, s.x_len,
           s.dtype, s.route)
    return children, aux


def _shspmv_unflatten(aux, children):
    s = object.__new__(ShardedSpmv)
    (s.mesh, s.axis, s.nr_rows, s.nr_cols, s.nr_nzeros, row_starts,
     s.rows_per_part, s.x_len, s.dtype, s.route) = aux
    s.row_starts = np.asarray(row_starts)
    s.row_ptr, s.col_ind, s.values, s.row_ids = children
    return s


# ShardedSpmv flows through jit as an argument, so its sharded arrays are
# never baked into a program as constants.
jax.tree_util.register_pytree_node(ShardedSpmv, _shspmv_flatten,
                                   _shspmv_unflatten)


def _gather_rows(y_parts, row_starts, nr_rows):
    """Concatenate per-partition contiguous row ranges into the global y."""
    ends = list(row_starts[1:]) + [nr_rows]
    return jnp.concatenate([y_parts[p, :int(e) - int(s)] for p, (s, e)
                            in enumerate(zip(row_starts, ends))])


@functools.partial(jax.jit, static_argnames=("mesh", "axis", "route",
                                             "shape"))
def _sharded_spmv_jit(row_ptr, col_ind, values, row_ids, x, *, mesh, axis,
                      route, shape):
    nr_cols = shape[1]

    def local(row_ptr, col_ind, values, row_ids, x_shard):
        x_full = jax.lax.all_gather(x_shard, axis, tiled=True)[:nr_cols]
        y = route_spmv(route, row_ptr[0], col_ind[0], values[0],
                       None if row_ids is None else row_ids[0], x_full,
                       shape)
        return y[None]

    spec = P(axis)
    # check_vma=False: a Pallas or cuSPARSE call inside shard_map does not
    # annotate its result with mesh-variance information
    return jax.shard_map(local, mesh=mesh,
                         in_specs=(spec, spec, spec, spec, spec),
                         out_specs=spec, check_vma=False)(
        row_ptr, col_ind, values, row_ids, x)


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """The uniform per-shard shapes, computed from the whole matrix so that
    every host derives the same layout without communicating."""

    part: RowPartition
    rows_per_part: int
    nnz_per_part: int
    x_len: int
    route: str
    dtype: np.dtype
    value_dtype: np.dtype

    @staticmethod
    def build(matrix: CSRMatrix, n_parts: int, config: Optional[SpmvConfig],
              backend: str) -> "ShardLayout":
        cfg = config or SpmvConfig(dtype=matrix.dtype)
        if cfg.is_double and not jax.config.jax_enable_x64:
            from ..api.api import X64_MESSAGE
            raise ValueError(X64_MESSAGE)
        part = balance_rows(matrix, n_parts)
        vdt = cfg.dtype if cfg.is_bf16 else cfg.compute_dtype
        return ShardLayout(
            part=part,
            rows_per_part=max(int(np.max(part.row_end - part.row_start)), 1),
            nnz_per_part=max(int(np.max(part.nnz)), 1),
            x_len=-(-matrix.nr_cols // n_parts) * n_parts,
            route=choose_route(matrix, backend, cfg),
            dtype=cfg.compute_dtype,
            value_dtype=np.dtype(vdt))

    @property
    def n_arrays(self) -> int:
        """Device arrays per shard: row ids only for the XLA route."""
        return 4 if self.route == "xla" else 3

    def shard(self, matrix: CSRMatrix, p: int) -> tuple:
        """Host arrays (row_ptr, col_ind, values, row_ids) of shard p."""
        r0, r1 = int(self.part.row_start[p]), int(self.part.row_end[p])
        sub = matrix.row_slice(r0, r1)
        rows, nnz = self.rows_per_part, self.nnz_per_part
        row_ptr = np.full(rows + 1, sub.nr_nzeros, np.int32)
        row_ptr[:sub.nr_rows + 1] = sub.row_ptr
        col_ind = np.zeros(nnz, np.int32)
        col_ind[:sub.nr_nzeros] = sub.col_ind
        values = np.zeros(nnz, self.value_dtype)
        values[:sub.nr_nzeros] = sub.values
        # padding nonzeros (value 0) land on the last local row: ids stay
        # sorted
        row_ids = np.full(nnz, rows - 1, np.int32)
        row_ids[:sub.nr_nzeros] = np.repeat(
            np.arange(sub.nr_rows, dtype=np.int32), sub.row_nnz())
        return row_ptr, col_ind, values, row_ids


def assemble(matrix: CSRMatrix, layout: ShardLayout, mesh: Mesh, axis: str,
             arrays) -> ShardedSpmv:
    """A ShardedSpmv from the globally sharded device arrays."""
    row_ptr, col_ind, values = arrays[:3]
    return ShardedSpmv(
        mesh=mesh, axis=axis, nr_rows=matrix.nr_rows,
        nr_cols=matrix.nr_cols, nr_nzeros=matrix.nr_nzeros,
        row_starts=layout.part.row_start,
        rows_per_part=layout.rows_per_part, x_len=layout.x_len,
        dtype=layout.dtype, route=layout.route,
        row_ptr=row_ptr, col_ind=col_ind, values=values,
        row_ids=arrays[3] if layout.n_arrays == 4 else None)


def shard_spmv(matrix: CSRMatrix, mesh: Mesh, axis: str = "rows",
               config: Optional[SpmvConfig] = None,
               backend: str = "auto") -> ShardedSpmv:
    """Partition + shard a CSR matrix over a mesh (the multi-device
    create_csr_hw_matrix)."""
    n_parts = int(mesh.shape[axis])
    layout = ShardLayout.build(matrix, n_parts, config, backend)
    shards = [layout.shard(matrix, p) for p in range(n_parts)]
    sharding = NamedSharding(mesh, P(axis))
    arrays = [jax.device_put(np.stack([s[i] for s in shards]), sharding)
              for i in range(layout.n_arrays)]
    return assemble(matrix, layout, mesh, axis, arrays)
