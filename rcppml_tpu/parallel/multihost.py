"""Multi-host (multi-process) execution setup.

The reference has no distributed axis at all (SURVEY.md §2.10: OpenMP +
one GPU); this module is the multi-node entry point.

One process per host (or per GPU), each seeing its local devices;
`jax.distributed` links them so `jax.devices()` returns the GLOBAL device
list and every jitted computation (including the whole ALS/CV/IRLS stack)
runs SPMD across hosts, with GSPMD collectives handed to NCCL (NVLink
within a node, the cluster network between nodes).

Typical GPU-cluster usage (same script on every host):

    from rcppml_tpu.parallel import multihost, mesh
    multihost.initialize("node0:1234", num_processes=4, process_id=rank)
    m = mesh.default_mesh()                   # spans ALL hosts' devices
    model = rt.nmf(A, k, mesh=m)              # same API as single host

Under a cluster manager JAX detects (e.g. SLURM), the arguments may be
omitted; otherwise pass the coordinator, process count and process id.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax


_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> dict:
    """Join the multi-process JAX runtime (idempotent).

    With no arguments, relies on JAX's cluster auto-detection (e.g.
    SLURM); otherwise pass ``coordinator_address`` ("host:port"),
    ``num_processes``, and this process's ``process_id``.

    Returns a summary dict: process_index, process_count, local and
    global device counts.
    """
    global _initialized
    if not _initialized and (coordinator_address is not None
                             or num_processes is not None
                             or jax.process_count() == 1):
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id)
            _initialized = True
        except (RuntimeError, ValueError):
            # single-process fallback (already initialized, or no cluster
            # env): everything below still reports correctly
            pass
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def shard_host_data(A: np.ndarray, mesh, *, axis: str = "cols"):
    """Place a host-local shard of A into the global sharded array.

    Every process passes ITS slice of A (split along ``axis`` by
    process_index); the result is one global jax.Array laid out with the
    canonical (rows, cols) sharding — the multi-host analog of
    ``shard_arrays``.  Uses ``jax.make_array_from_process_local_data``,
    so no host ever materializes the full matrix.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P("rows", "cols"))
    return jax.make_array_from_process_local_data(sharding, A)
