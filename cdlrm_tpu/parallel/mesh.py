"""Mesh and sharding helpers for the 1-D data-parallel axis.

The reference's parallelism is pure DP: one process per GPU, NCCL collectives
(/root/reference/main_no_ddp.py:341-343,234-321). Here DP is a single
controller with a 1-D ``jax.sharding.Mesh`` over the 'dp' axis; collectives
are ``psum``/``pmax`` inside ``shard_map`` (SURVEY.md §2 native-equivalents
table). Divergent-by-design per-replica state (the embedding caches) carries
an explicit leading device axis sharded over 'dp' (DESIGN.md D4).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DP_AXIS = "dp"


def make_dp_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if num_devices is not None:
            if num_devices > len(devices):
                raise ValueError(
                    f"requested {num_devices} devices, only {len(devices)} available"
                )
            devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (DP_AXIS,))


def put_global(local_np: np.ndarray, sharding: NamedSharding, global_shape=None):
    """Build a (possibly multi-host) global array from this process's local
    portion. Single-process: a plain device_put of the full value (local ==
    global). Multi-process: ``jax.make_array_from_process_local_data`` — each
    process supplies the rows its addressable mesh devices own."""
    if jax.process_count() == 1:
        return jax.device_put(local_np, sharding)
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_np), global_shape
    )


def local_shard(arr) -> np.ndarray:
    """First addressable shard of a global array (multihost-safe replacement
    for ``arr[0]`` on leading-device-axis arrays whose shards this process
    needs; content must be replica-identical or explicitly per-host)."""
    return np.asarray(arr.addressable_shards[0].data)


def put_global_many(values, shardings, global_shapes):
    """Batched multi-array variant of :func:`put_global`. Single-process:
    ONE batched ``jax.device_put`` call — per-call dispatch overhead
    dominates small per-step payloads, so the step inputs go in one put."""
    if jax.process_count() == 1:
        return jax.device_put(tuple(values), tuple(shardings))
    return tuple(
        jax.make_array_from_process_local_data(s, np.ascontiguousarray(v), g)
        for v, s, g in zip(values, shardings, global_shapes)
    )


def local_batch_rows(arr) -> np.ndarray:
    """Concatenate this process's addressable shards of a batch-sharded
    (leading-axis P('dp')) global array, in global row order."""
    shards = sorted(
        arr.addressable_shards, key=lambda s: (s.index[0].start or 0)
    )
    return np.concatenate([np.asarray(s.data) for s in shards])


def local_replica_ids(mesh: Mesh) -> list:
    """Global dp-axis positions of this process's addressable devices, in
    mesh order (== which global batch shards this host feeds)."""
    me = jax.process_index()
    flat = list(mesh.devices.ravel())
    return [i for i, d in enumerate(flat) if d.process_index == me]


def batch_sharding(mesh: Mesh, axis: int, ndim: int) -> NamedSharding:
    """Shard dimension ``axis`` of an ndim-array over the dp axis."""
    spec = [None] * ndim
    spec[axis] = DP_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
