"""Device-resident streaming benchmark.

Bounds the DEVICE-SIDE streaming cost, apart from host→device transfer:
M interleaved sample blocks are pre-staged in device memory, then the
interleaved pipeline processes them back-to-back
as a stream — per-block dispatch, overlap carry handled by framing
(overlap=0 headline shape), donation enabled so XLA recycles the block
buffers — with ONE completion fence at the end (device programs execute
in launch order). Prints chip-side streaming snapshots/s and the ratio
vs the offline batch number measured in the same process.

Run: timeout 590 python bench_stream_device.py [blocks=16] [blk_pow2=20]
"""

import json
import sys
import time

import numpy as np


def log(m):
    print(f"[stream-dev] {m}", file=sys.stderr, flush=True)


def main():
    n_blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    blk_pow = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    import jax
    import jax.numpy as jnp

    from doa_tpu.utils.profiling import device_summary, use_compile_cache
    use_compile_cache()
    log(device_summary())
    if jax.devices()[0].platform == "cpu":
        raise SystemExit("bench_stream_device: no accelerator found")
    from doa_tpu.configs import (
        ArrayGeometry, DoaConfig, Estimator, GridSpec1D)
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    SNAP, N, GRID, K = 1024, 16, 1024, 2
    T_blk = 1 << blk_pow
    B_blk = T_blk // SNAP
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=N,
                               norm_spacing=0.5),
        snapshot_size=SNAP, overlap=0, num_sources=K,
        estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=GRID),
        num_max_vals=2)

    # Streaming pipe donates each block; offline pipe (reused buffer)
    # must not. All three modes use the production streaming shape
    # (peaks out, no spectra).
    pipe_stream = build_pipeline_tpu(cfg, donate_inputs=True,
                                     return_spectra=False)
    pipe_off = build_pipeline_tpu(cfg, return_spectra=False)
    use_fast = pipe_stream.fast_path
    Ar, Ai = pipe_stream.steering_planes
    cr = jnp.ones((N,), jnp.float32)
    ci = jnp.zeros((N,), jnp.float32)

    log(f"staging {n_blocks} blocks of 2^{blk_pow} samples (fast_path="
        f"{use_fast})")
    key = jax.random.key(0)
    blocks = []
    for i in range(n_blocks):
        key, k1 = jax.random.split(key)
        blocks.append(jax.block_until_ready(
            jax.random.normal(k1, (T_blk // 4, 128), jnp.float32)))

    def fence(out):
        jax.block_until_ready(out["peak_angles"])

    def stream_once(blks):
        outs = []
        for b in blks:
            outs.append(pipe_stream.jitted_ilv(b, cr, ci, Ar, Ai))
        fence(outs[-1])
        return outs

    log("compiling streaming pipe")
    warm = [jax.block_until_ready(jnp.copy(b)) for b in blocks[:2]]
    stream_once(warm)  # consumes the copies (donated)

    # Donated buffers are consumed: stage ALL runs' copies upfront so
    # the timed region enqueues runs*n_blocks calls and fences ONCE —
    # the same pipelined discipline as the offline and scan modes.
    runs = 3
    log(f"timing streaming ({runs}x{n_blocks} blocks, one fence)")
    staged = [jax.block_until_ready(jnp.copy(b))
              for _ in range(runs) for b in blocks]
    t0 = time.perf_counter()
    out = None
    for b in staged:
        out = pipe_stream.jitted_ilv(b, cr, ci, Ar, Ai)
    fence(out)
    dt_stream = (time.perf_counter() - t0) / runs
    del staged
    snaps_stream = n_blocks * B_blk / dt_stream

    log("timing lax.scan capture mode (one program for all blocks)")
    pipe_scan = build_pipeline_tpu(cfg, return_spectra=False)
    stacked0 = jax.block_until_ready(jnp.stack(blocks))

    fence(pipe_scan.scan_capture(stacked0))
    t0 = time.perf_counter()
    out = None
    for _ in range(runs):
        out = pipe_scan.scan_capture(stacked0)
    fence(out)
    dt_scan = (time.perf_counter() - t0) / runs
    snaps_scan = n_blocks * B_blk / dt_scan
    del stacked0
    log(f"scan-capture: {snaps_scan:.0f} snapshots/s")

    log("offline batch reference (same total samples, one call)")
    T_total = n_blocks * T_blk
    key, k1 = jax.random.split(key)
    xb = jax.block_until_ready(
        jax.random.normal(k1, (T_total // 4, 128), jnp.float32))
    fence(pipe_off.jitted_ilv(xb, cr, ci, Ar, Ai))
    t0 = time.perf_counter()
    out = None
    for _ in range(2 * runs):
        out = pipe_off.jitted_ilv(xb, cr, ci, Ar, Ai)
    fence(out)
    dt_off = (time.perf_counter() - t0) / (2 * runs)
    snaps_off = (T_total // SNAP) / dt_off

    print(json.dumps({
        "metric": "device_streaming_snapshots_per_s",
        "block_samples": T_blk, "blocks": n_blocks,
        "value": round(snaps_stream, 1),
        "scan_capture_snapshots_per_s": round(snaps_scan, 1),
        "offline_snapshots_per_s": round(snaps_off, 1),
        "stream_vs_offline": round(snaps_stream / snaps_off, 3),
        "scan_vs_offline": round(snaps_scan / snaps_off, 3),
        "x_realtime": round(snaps_stream / (10e6 / SNAP), 2),
    }), flush=True)


if __name__ == "__main__":
    main()
