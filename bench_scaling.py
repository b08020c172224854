"""Scaling benchmark: sharded-pipeline throughput vs shard count.

BASELINE's second metric is samples/s scaling at 1 device / 1 host /
N hosts. By default this script exercises the REAL sharded program
(shard_map + ppermute halos + all_gather) on a virtual CPU device mesh
(XLA_FLAGS=--xla_force_host_platform_device_count) to validate scaling
mechanics; on a multi-GPU host the same script runs with real devices
(pass --platform gpu) and reports true samples/s.

Prints one JSON line per mesh size.
"""

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cpu")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--windows-per-shard", type=int, default=64)
    args = ap.parse_args()

    import os

    if args.platform == "cpu":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", args.platform)
    from doa_tpu.utils.profiling import use_compile_cache
    use_compile_cache()

    from doa_tpu.configs import (
        ArrayGeometry, DoaConfig, Estimator, GridSpec1D)
    from doa_tpu.parallel import MeshSpec, build_sharded_pipeline, make_mesh

    cfg = DoaConfig(
        geometry=ArrayGeometry("ula", 16, 0.5),
        snapshot_size=1024,
        overlap=512,
        num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=1024),
        num_max_vals=2,
    )
    rng = np.random.default_rng(0)

    n_dev = args.devices
    results = []
    n = 1
    while n <= n_dev:
        mesh = make_mesh(MeshSpec(n_snap=n, n_grid=1),
                         jax.devices()[:n])
        T = n * cfg.hop * args.windows_per_shard
        x = (rng.standard_normal((T, 16))
             + 1j * rng.standard_normal((T, 16))).astype(np.complex64)
        pipe = build_sharded_pipeline(cfg, mesh)
        out = pipe(x)
        np.asarray(out["peak_angles_music"][:1])  # warm + fence
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            out = pipe(x)
            np.asarray(out["peak_angles_music"][:1, :1])
        dt = (time.perf_counter() - t0) / iters
        sps = T / dt
        results.append((n, sps))
        base = results[0][1]
        rec = {
            "metric": "sharded_samples_per_s_per_channel",
            "shards": n,
            "value": round(sps, 1),
            "unit": "samples/s/channel",
            "platform": jax.devices()[0].platform,
        }
        if args.platform == "cpu":
            # Virtual devices share physical cores: throughput numbers
            # validate the sharded program's mechanics, not scaling.
            rec["virtual_mesh"] = True
        else:
            rec["scaling_efficiency"] = round(sps / (base * n), 3)
        print(json.dumps(rec))
        n *= 2


if __name__ == "__main__":
    main()
