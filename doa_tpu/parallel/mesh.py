"""Named-mesh construction helpers."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh


SNAP_AXIS = "snap"   # time/snapshot data-parallel axis (DP+SP)
GRID_AXIS = "grid"   # steering-grid tensor-parallel axis (TP)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    n_snap: int
    n_grid: int = 1

    @property
    def n_devices(self) -> int:
        return self.n_snap * self.n_grid


def make_mesh(spec: MeshSpec | None = None, devices=None) -> Mesh:
    """Build a ("snap", "grid") mesh.

    Default: all devices on the snap axis (snapshot DP is the dominant
    axis for 1-D scans; grid TP pays off for large 2-D grids). On a GPU
    host every card reaches every other over NVLink at the same rate, so
    the mesh shape follows the algorithm alone (which axis needs the
    collectives), not a physical ring.
    """
    if devices is None:
        devices = jax.devices()
    if spec is None:
        spec = MeshSpec(n_snap=len(devices), n_grid=1)
    if spec.n_devices != len(devices):
        raise ValueError(
            f"mesh {spec} wants {spec.n_devices} devices, got {len(devices)}")
    arr = np.asarray(devices).reshape(spec.n_snap, spec.n_grid)
    return Mesh(arr, (SNAP_AXIS, GRID_AXIS))
