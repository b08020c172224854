"""Multi-host tests: two actual processes with jax.distributed over a
localhost coordinator (SURVEY §4: "multi-host tests via jax.distributed
with multi-process-on-one-host").

Unlike a toy psum check, the workers run the PRODUCTION
`build_sharded_pipeline` (halo ppermute over the snap axis + grid-TP
all_gather + peaks) over a 2-process × (4 snap × 2 grid) mesh — both
collective families cross the process boundary — and the assembled
global peak angles must match the single-process pipeline on the same
capture. Every worker is forced onto the CPU: several JAX processes
must never share one GPU (each reserves most of its memory).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import golden

_WORKER = r"""
import os, sys, json
import numpy as np

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
tests_dir = sys.argv[4]
sys.path.insert(0, tests_dir)

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import golden
from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                             GridSpec1D)
from doa_tpu.parallel import MeshSpec, make_mesh
from doa_tpu.parallel.mesh import GRID_AXIS, SNAP_AXIS
from doa_tpu.parallel.multihost import (
    DistributedContext, host_local_to_global, replicated_host_to_global)
from doa_tpu.parallel.sharded import (build_sharded_pipeline,
                                      num_valid_windows)
from doa_tpu.pipeline import _steering_matrix

cfg = DoaConfig(
    geometry=ArrayGeometry(kind="ula", num_elements=8, norm_spacing=0.5),
    snapshot_size=256, overlap=128, num_sources=2,
    estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=256),
    num_max_vals=2)

devices = jax.devices()
assert len(devices) == 4 * nproc
mesh = make_mesh(MeshSpec(n_snap=len(devices) // 2, n_grid=2), devices)
ctx = DistributedContext(num_hosts=nproc, host_id=pid, mesh=mesh)

T_total = 8192
x_full = golden.synthetic_ula_iq([62.0, 118.0], 8, 0.5, T_total,
                                 snr_db=12, seed=11)
T_local = T_total // nproc
x_local = x_full[pid * T_local:(pid + 1) * T_local]

from doa_tpu.ops.interleaved import interleave_factor
tp = interleave_factor(8)
xil_l = np.ascontiguousarray(x_local.astype(np.complex64)).view(
    np.float32).reshape(T_local // tp, -1)
xil = host_local_to_global(ctx, xil_l)

A_host, _ = _steering_matrix(cfg)
Ar = replicated_host_to_global(
    ctx, A_host.real.astype(np.float32), P(GRID_AXIS, None))
Ai = replicated_host_to_global(
    ctx, A_host.imag.astype(np.float32), P(GRID_AXIS, None))
cr = replicated_host_to_global(ctx, np.ones(8, np.float32), P())
ci = replicated_host_to_global(ctx, np.zeros(8, np.float32), P())

pipe = build_sharded_pipeline(cfg, mesh)
assert pipe.fast       # the interleaved ingest path, rows sharded
out = pipe.jitted(xil, cr, ci, Ar, Ai)

angles = out["peak_angles_music"]
shards = []
for s in angles.addressable_shards:
    start = s.index[0].start or 0
    shards.append([int(start), np.asarray(s.data).tolist()])
print(json.dumps({"pid": pid, "B": int(angles.shape[0]),
                  "valid": num_valid_windows(T_total, cfg),
                  "shards": shards}))
"""


@pytest.mark.skipif(os.environ.get("DOA_SKIP_MULTIPROC") == "1",
                    reason="multi-process test disabled")
def test_two_process_sharded_pipeline_parity(tmp_path):
    port = "29473"
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(tests_dir)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    # Prepend the repo to PYTHONPATH: the worker must import doa_tpu
    # even when the package isn't pip-installed in the container.
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", port, tests_dir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=repo, env=env)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    # Assemble the global angle table from both processes' shards.
    B = outs[0]["B"]
    valid = outs[0]["valid"]
    got = np.full((B, 2), np.nan, np.float32)
    for o in outs:
        for start, rows in o["shards"]:
            rows = np.asarray(rows, np.float32)
            got[start:start + len(rows)] = rows
    assert not np.isnan(got[:valid]).any(), "missing shard rows"

    # Single-process reference: the split-complex pipeline on the same capture.
    import dataclasses
    from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                                 GridSpec1D)
    from doa_tpu.pipeline_tpu import build_pipeline_tpu
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8,
                               norm_spacing=0.5),
        snapshot_size=256, overlap=128, num_sources=2,
        estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=256),
        num_max_vals=2)
    x_full = golden.synthetic_ula_iq([62.0, 118.0], 8, 0.5, 8192,
                                     snr_db=12, seed=11)
    ref = build_pipeline_tpu(cfg)(x_full)
    ref_angles = np.sort(np.asarray(ref.peak_angles["music"])[:valid], -1)
    np.testing.assert_allclose(np.sort(got[:valid], -1), ref_angles,
                               atol=0.1)
