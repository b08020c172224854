"""Multi-host bring-up (SURVEY §2.5 comms backend row).

One process per host, `jax.distributed.initialize` forms the global
runtime; meshes from doa_tpu.parallel.mesh then span all hosts' devices —
XLA routes collectives over ICI within a slice and DCN across slices.
There is NO elasticity: a lost host fails the job (fail-fast is the
documented behavior — SURVEY §5 failure detection).

Per-host data feeding: each host owns the time-shards of its local
devices; `host_local_to_global` assembles a global array from per-host
blocks without gathering samples anywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from doa_tpu.parallel.mesh import SNAP_AXIS, MeshSpec


@dataclasses.dataclass
class DistributedContext:
    num_hosts: int
    host_id: int
    mesh: Mesh

    @property
    def is_leader(self) -> bool:
        return self.host_id == 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               n_grid: int = 1) -> DistributedContext:
    """Initialize the multi-host runtime and build the global mesh.

    With no arguments, auto-detects (cluster env vars); single
    process works too (num_processes=1), so the same entry point runs from
    a laptop to a pod slice.
    """
    if num_processes is None or num_processes > 1:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id)
        except (ValueError, RuntimeError):
            pass  # single-process / already initialized
    devices = jax.devices()
    spec = MeshSpec(n_snap=len(devices) // n_grid, n_grid=n_grid)
    from doa_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(spec, devices)
    return DistributedContext(
        num_hosts=jax.process_count(),
        host_id=jax.process_index(),
        mesh=mesh,
    )


def _device_slices(mesh: Mesh, pspec: P, global_shape):
    """Yield (device, index-tuple) pairs: each device's block of a
    global array sharded by `pspec`, derived from the device's position
    in the mesh (handles replicated axes — every replica receives the
    SAME block, which the old per-local-device round-robin did not)."""
    axes = list(mesh.axis_names)
    dev_array = mesh.devices
    for pos in np.ndindex(dev_array.shape):
        d = dev_array[pos]
        idx = []
        for dim, name in enumerate(pspec):
            if name is None:
                idx.append(slice(None))
                continue
            names = (name,) if isinstance(name, str) else tuple(name)
            coord, size = 0, 1
            for nm in names:
                ai = axes.index(nm)
                coord = coord * dev_array.shape[ai] + pos[ai]
                size *= dev_array.shape[ai]
            step = global_shape[dim] // size
            idx.append(slice(coord * step, (coord + 1) * step))
        yield d, tuple(idx)


def host_local_to_global(ctx: DistributedContext, x_local: np.ndarray,
                         pspec: P = P(SNAP_AXIS, None)):
    """Per-host CONTIGUOUS block (rows [host_id·T_local, …)) of a global
    array → jax global sharded array, without any host gathering the
    whole capture: each host device_puts only the shards it owns. Shard
    boundaries must fall inside the host's block (true for the standard
    snap-major mesh layouts)."""
    sharding = NamedSharding(ctx.mesh, pspec)
    T_local = x_local.shape[0]
    global_shape = (T_local * ctx.num_hosts,) + x_local.shape[1:]
    off = ctx.host_id * T_local
    arrays, devs = [], []
    for d, idx in _device_slices(ctx.mesh, pspec, global_shape):
        if d.process_index != ctx.host_id:
            continue
        r = idx[0]
        lo, hi = r.start - off, r.stop - off
        if lo < 0 or hi > T_local:
            raise ValueError(
                f"shard rows [{r.start}, {r.stop}) not inside host "
                f"{ctx.host_id}'s block [{off}, {off + T_local})")
        arrays.append(jax.device_put(x_local[lo:hi][idx[1:]], d))
        devs.append(d)
    return jax.make_array_from_single_device_arrays(
        global_shape, sharding, arrays)


def replicated_host_to_global(ctx: DistributedContext, arr: np.ndarray,
                              pspec: P):
    """Every host holds the FULL array (e.g. the steering grid or a
    correction vector); build the global sharded array by giving each
    local device exactly its pspec-slice."""
    arr = np.asarray(arr)
    sharding = NamedSharding(ctx.mesh, pspec)
    arrays = []
    for d, idx in _device_slices(ctx.mesh, pspec, arr.shape):
        if d.process_index != ctx.host_id:
            continue
        arrays.append(jax.device_put(arr[idx], d))
    return jax.make_array_from_single_device_arrays(
        arr.shape, sharding, arrays)
