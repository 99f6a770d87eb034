"""Multi-process distributed SpMV.

Single-process SPMD (dist/spmv_dist.py) covers the devices of one host;
this module adds the multi-process path:

  * ``init_multihost`` — the ``jax.distributed.initialize`` entry.  After
    it returns, ``jax.devices()`` spans every process and a mesh over it
    makes the x all-gather cross hosts.
  * ``shard_spmv_multihost`` — per-host CSR partitions: every process
    builds ONLY the row partitions owned by its local (addressable)
    devices and contributes them to the globally sharded arrays via
    ``jax.make_array_from_single_device_arrays``.  The uniform shard shapes
    are derived from the full matrix, which every host holds, so the hosts
    agree on them without communicating.

On a single process (including the simulated CPU mesh of
tests/conftest.py) the same code path runs with all devices local, so the
multi-process program is CPU-testable without a cluster.
"""

from __future__ import annotations

from typing import Optional

from ..formats.csr import CSRMatrix
from ..utils.config import SpmvConfig


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   **kwargs) -> None:
    """Initialize the JAX distributed runtime.  Without a cluster
    environment JAX cannot infer the arguments: pass the coordinator's
    ``host:port``, the process count and this process's id.  Call once per
    process, before any jax computation."""
    import jax
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id, **kwargs)


def shard_spmv_multihost(matrix: CSRMatrix, mesh=None, axis: str = "rows",
                         config: Optional[SpmvConfig] = None,
                         backend: str = "auto"):
    """Partition + shard a CSR matrix over a (possibly multi-process) mesh,
    building on each process only the partitions its devices own.

    ``matrix`` is the full CSR on every host (every host reads the file;
    only its share is laid out and uploaded).  Returns a ShardedSpmv whose
    arrays are globally sharded jax.Arrays — ``spmv`` runs the same SPMD
    program as the single-process path."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from .spmv_dist import ShardLayout, assemble, make_mesh

    if mesh is None:
        mesh = make_mesh()
    devs = list(mesh.devices.reshape(-1))
    layout = ShardLayout.build(matrix, len(devs), config, backend)
    local = {p: layout.shard(matrix, p) for p, d in enumerate(devs)
             if d.process_index == jax.process_index()}
    sharding = NamedSharding(mesh, P(axis))

    def global_array(i):
        first = next(iter(local.values()))[i]
        bufs = [jax.device_put(arrs[i][None], devs[p])
                for p, arrs in local.items()]
        return jax.make_array_from_single_device_arrays(
            (len(devs),) + first.shape, sharding, bufs)

    arrays = [global_array(i) for i in range(layout.n_arrays)]
    return assemble(matrix, layout, mesh, axis, arrays)
