"""Device-mesh helpers for SPMD decoding.

The reference has no parallelism of any kind (its batch path is a serial
loop, the reference's abstract_decoder.jl:35-39).  This package's
strategy (SURVEY.md §5, §7): shard the syndrome batch axis across devices
('data'), optionally pairing it with a 'model' axis that shards the
check/edge dimension of very large codes.  The mesh is flat over
``jax.devices()``: the cards of one host reach each other at the same
rate, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "batch_sharding", "shard_batch", "P", "Mesh", "NamedSharding"]


def make_mesh(n_devices: int | None = None, *, axis_names=("data",), shape=None) -> Mesh:
    """Create a mesh over the first ``n_devices`` devices.

    Args:
      n_devices: number of devices (default: all).
      axis_names: mesh axis names; 1-D ('data',) by default.
      shape: explicit mesh shape; defaults to all devices on the first axis.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    return Mesh(devices.reshape(shape), axis_names)


def batch_sharding(mesh: Mesh, ndim: int, data_axis: str = "data") -> NamedSharding:
    """NamedSharding that splits the leading (batch) axis over ``data_axis``."""
    return NamedSharding(mesh, P(data_axis, *([None] * (ndim - 1))))


def shard_batch(arr, mesh: Mesh, data_axis: str = "data"):
    """Place an array with its leading axis sharded across the mesh."""
    import jax.numpy as jnp

    arr = jnp.asarray(arr)
    return jax.device_put(arr, batch_sharding(mesh, arr.ndim, data_axis))
