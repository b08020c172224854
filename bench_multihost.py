"""Multi-process scaling harness for the sharded DoA pipeline.

Spawns N worker processes (jax.distributed over a localhost
coordinator), each owning 4 devices; the global mesh is
(n_snap = 2·N_proc, n_grid = 2). Workers build the PRODUCTION
`build_sharded_pipeline` (c4-shaped config: 16-element ULA, S=1024,
overlap=512, MUSIC), feed per-host sample blocks via
`host_local_to_global` (no host ever gathers the capture), and time
pipelined iterations; the leader prints one JSON line per process
count.

Every worker is forced onto the CPU (4 virtual devices each), so the
numbers prove the harness + collectives (correctness/scaling shape),
not device speed; several JAX processes must never share one GPU (each
reserves most of its memory). Four-GPU sharding runs in ONE process:
`python chip_smoke.py --four`.

Run: python bench_multihost.py [max_procs=2] [T_per_proc_pow2=20]
"""

import json
import os
import subprocess
import sys
import tempfile

_WORKER = r"""
import os, sys, json, time
import numpy as np

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
T_local = int(sys.argv[4])

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
if nproc > 1:
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=pid)
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                             GridSpec1D)
from doa_tpu.parallel import MeshSpec, make_mesh
from doa_tpu.parallel.mesh import GRID_AXIS
from doa_tpu.parallel.multihost import (
    DistributedContext, host_local_to_global, replicated_host_to_global)
from doa_tpu.parallel.sharded import build_sharded_pipeline
from doa_tpu.pipeline import _steering_matrix

N = 16
cfg = DoaConfig(
    geometry=ArrayGeometry(kind="ula", num_elements=N, norm_spacing=0.5),
    snapshot_size=1024, overlap=512, num_sources=2,
    estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=512),
    num_max_vals=2)

devices = jax.devices()
mesh = make_mesh(MeshSpec(n_snap=len(devices) // 2, n_grid=2), devices)
ctx = DistributedContext(num_hosts=nproc, host_id=pid, mesh=mesh)

rng = np.random.default_rng(pid)
tp = 128 // (2 * N)                       # interleaved ingest rows
xil_l = rng.standard_normal((T_local // tp, 2 * N * tp)).astype(np.float32)
xil = host_local_to_global(ctx, xil_l)
A_host, _ = _steering_matrix(cfg)
Ar = replicated_host_to_global(ctx, A_host.real.astype(np.float32),
                               P(GRID_AXIS, None))
Ai = replicated_host_to_global(ctx, A_host.imag.astype(np.float32),
                               P(GRID_AXIS, None))
cr = replicated_host_to_global(ctx, np.ones(N, np.float32), P())
ci = replicated_host_to_global(ctx, np.zeros(N, np.float32), P())

pipe = build_sharded_pipeline(cfg, mesh)

def fence(out):
    for s in out["peak_angles_music"].addressable_shards:
        np.asarray(s.data)
        break

out = pipe.jitted(xil, cr, ci, Ar, Ai); fence(out)
out = pipe.jitted(xil, cr, ci, Ar, Ai); fence(out)
iters = 6
t0 = time.perf_counter()
for _ in range(iters):
    out = pipe.jitted(xil, cr, ci, Ar, Ai)
fence(out)
dt = (time.perf_counter() - t0) / iters
if pid == 0:
    T_total = T_local * nproc
    print(json.dumps({
        "metric": "sharded_pipeline_samples_per_s",
        "platform": "cpu", "nproc": nproc, "devices": len(devices),
        "T_per_call": T_total,
        "value": round(T_total / dt, 1),
        "ms_per_call": round(dt * 1e3, 2)}), flush=True)
"""


def run(nproc: int, t_local: int) -> None:
    with tempfile.TemporaryDirectory() as td:
        script = os.path.join(td, "worker.py")
        with open(script, "w") as f:
            f.write(_WORKER)
        procs = [
            subprocess.Popen(
                [sys.executable, script, str(pid), str(nproc), "29481",
                 str(t_local)],
                stdout=None if pid == 0 else subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            for pid in range(nproc)
        ]
        for p in procs:
            p.wait(timeout=600)
            assert p.returncode == 0, f"worker exited {p.returncode}"


def main():
    max_procs = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    t_local = 1 << (int(sys.argv[2]) if len(sys.argv) > 2 else 20)
    n = 1
    while n <= max_procs:
        run(n, t_local)
        n *= 2


if __name__ == "__main__":
    main()
