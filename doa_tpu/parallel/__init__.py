"""Multi-chip / multi-host parallelism (SURVEY §2.5 — first-class here).

The reference is single-process; its parallelism inventory maps to:

  DP  — snapshot windows are embarrassingly parallel → shard the time axis
        ("snap" mesh axis); each device owns a contiguous sample block and
        the windows that START in it.
  SP  — windows crossing a shard boundary need `overlap` halo samples from
        the right neighbor → `lax.ppermute` neighbor exchange
        (sharded.halo_exchange, the context-parallel analog).
  TP  — the steering grid is sharded over the "grid" mesh axis; each device
        scans its angle block; full spectra recovered by `all_gather`
        (only when peaks need the whole row).
  Covariance partial sums — chunk Grams are associative → `psum` over the
        time axis yields a full-capture covariance without gathering samples
        (used by calibration at scale).
  EP  — wideband subbands sharded like a second batch axis (ops.wideband).

Multi-host: the same meshes span hosts via `jax.distributed.initialize`;
XLA hands the collectives to NCCL (NVLink within a host, the network
across hosts) — see doa_tpu.parallel.multihost.
"""

from doa_tpu.parallel.mesh import make_mesh, MeshSpec
from doa_tpu.parallel.sharded import (
    build_sharded_pipeline,
    distributed_covariance,
)

__all__ = [
    "make_mesh",
    "MeshSpec",
    "build_sharded_pipeline",
    "distributed_covariance",
]
