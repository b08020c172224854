"""Sustained streaming benchmark — BASELINE config 4's deployment shape.

End-to-end: host blocks of interleaved complex64 → native deinterleave →
device transfer → fused pipeline (overlapped windows, MUSIC, peaks,
tracking-ready outputs) → result fetch, with one-block pipelining so host
framing of block i+1 overlaps device compute of block i (the GNU Radio
pipeline-parallelism analog, SURVEY §7.1).

Reports sustained samples/s/channel incl ALL host costs, vs 10 Msps
real-time. Prints one JSON line.

The host→device transfer of every block is inside the timed loop, so
this is the served rate; bench_stream_device.py bounds the device side
alone.
"""

import argparse
import json
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, default=1 << 18,
                    help="samples/channel per block")
    ap.add_argument("--nblocks", type=int, default=8)
    args = ap.parse_args()

    from doa_tpu.configs import (
        ArrayGeometry, DoaConfig, Estimator, GridSpec1D)
    from doa_tpu.pipeline_tpu import build_pipeline_tpu
    from doa_tpu.utils.profiling import device_summary, use_compile_cache

    use_compile_cache()
    print(device_summary(), file=sys.stderr, flush=True)
    import jax
    if jax.devices()[0].platform == "cpu":
        raise SystemExit("bench_streaming: no accelerator found")
    N = 16
    SNAP, OVERLAP = 1024, 512
    BLOCK = args.block
    NBLOCKS = args.nblocks

    cfg = DoaConfig(
        geometry=ArrayGeometry("ula", N, 0.5),
        snapshot_size=SNAP, overlap=OVERLAP, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=1024), num_max_vals=2)
    pipe = build_pipeline_tpu(cfg)

    rng = np.random.default_rng(0)
    base = (rng.standard_normal((BLOCK, N))
            + 1j * rng.standard_normal((BLOCK, N))).astype(np.complex64)

    from doa_tpu.io.stream import StreamingDriver

    drv = StreamingDriver(pipe, block_samples=BLOCK)

    def fetch(res):
        return np.asarray(res.peak_angles["music"][:1, :1])

    # Warm (compile both shapes: first block has no tail, rest do).
    it = drv.run_iter(base for _ in range(2))
    for _, res in it:
        fetch(res)

    drv2 = StreamingDriver(pipe, block_samples=BLOCK)
    gen = (base for _ in range(NBLOCKS))
    t0 = time.perf_counter()
    prev = None
    done = 0
    for _, res in drv2.run_iter(gen):
        if prev is not None:
            fetch(prev)          # fence block i-1 AFTER dispatching block i
            done += 1
        prev = res
    fetch(prev)
    done += 1
    dt = time.perf_counter() - t0

    sps = NBLOCKS * BLOCK / dt
    print(json.dumps({
        "metric": "streaming_samples_per_s_per_channel_16el",
        "value": round(sps, 1),
        "unit": "samples/s/channel",
        "vs_baseline": round(sps / 10e6, 3),   # ×10 Msps real-time
    }))


if __name__ == "__main__":
    main()
