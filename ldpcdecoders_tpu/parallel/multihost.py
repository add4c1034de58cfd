"""Multi-host initialization and host-sharded FER accumulation.

For multi-process deployments: ``jax.distributed`` process group init, a
global mesh spanning all processes, per-host syndrome generation, and
all-reduced failure counts.  Single-host (and test) environments pass
through unchanged — everything degrades to the local mesh.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

__all__ = [
    "initialize_multihost",
    "global_mesh",
    "allreduce_counts",
    "broadcast_from_host0",
]


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None, process_id: int | None = None):
    """Initialize jax.distributed when running under a multi-host launcher.

    No-op when single-process (the common local case).  Otherwise give
    the coordinator address (``host:port``), the process count and this
    process's rank.
    """
    if coordinator is None and num_processes is None:
        return  # single-host / launcher-managed: nothing to do
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # already initialized (by a launcher or an earlier call) is fine;
        # anything else — including "must be called before any JAX calls" —
        # is a real configuration error the caller needs to see
        if "already" not in str(e).lower():
            raise


def global_mesh(axis_name: str = "data") -> Mesh:
    """1-D mesh over every device of every host."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def allreduce_counts(local_counts: dict, mesh: Mesh) -> dict:
    """Sum integer statistic dicts across all hosts/devices.

    Used by FER sweeps running one shard of trials per host: each host
    passes its local ``{"trials": t, "failures": f, ...}`` and receives
    the global totals.  On a single host this is the identity.
    """
    keys = sorted(local_counts)
    vec = np.asarray([float(local_counts[k]) for k in keys])
    if jax.process_count() == 1:
        out = vec
    else:
        from jax.experimental import multihost_utils

        gathered = multihost_utils.process_allgather(vec)  # [procs, k]
        out = np.asarray(gathered).sum(axis=0)
    return {k: int(round(float(v))) for k, v in zip(keys, out)}


def broadcast_from_host0(vec: np.ndarray) -> np.ndarray:
    """Replace every process's array with process 0's copy.

    Used to synchronize resumed FER-sweep state when checkpoints live on
    a non-shared filesystem: only process 0 writes them, so only process
    0's loaded state is authoritative.  Single-process: identity.
    """
    if jax.process_count() == 1:
        return np.asarray(vec)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.broadcast_one_to_all(np.asarray(vec)))
