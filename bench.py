"""Benchmark entry point: the headline cell on the accelerator.

Headline metric (BASELINE.json): Covariance + eigendecomposition + MUSIC
spectrum-scan snapshots/s per device on a 16-element ULA, 1024-sample
snapshots, 1024-angle grid — the full pipeline over device-resident data
(T = 2²⁴ samples, 2 GiB of interleaved f32 IQ, B = 16384 windows).

The input is a PLANTED SCENE, not bare noise: two equal-power 10 dB
tones at 70°/110° in AWGN. That makes the bench a CORRECTNESS tripwire
(the returned peak angles are asserted to ≤0.5° per window — a matmul
precision bug or a silently wrong stage fails here, not just slows
down) AND it measures the benign operating point: source-free noise
would keep the escalation detector's no-signal gate busy instead.

Timing: `jax.block_until_ready` on the peak outputs fences each call
(JAX dispatch returns before the device finishes).
  * pipelined (the headline): enqueue `iters` calls, fence once — the
    steady-state streaming number;
  * latency: fence every call (reported on stderr).

The path is the interleaved-ingest pipeline (pipe.jitted_ilv). There is
no fallback: a failure to compile or run fails the bench.

`vs_baseline` is the multiple of REAL-TIME at the north-star operating
point (10 Msps/channel → 9765.625 snapshots/s): ≥10 meets the target.

Run: python bench.py  (device and card on stderr, one JSON line on stdout)
"""

import json
import sys
import time

import numpy as np

THETA = (70.0, 110.0)   # planted truth (the c4-like scene)
CYCLES = (5, 9)         # tone freqs, cycles per 1024 samples: phases are
#                         exact in f32 via t mod 1024, and the two tones
#                         are orthogonal over every snapshot window
SNR_DB = 10.0
PERIOD = 1024
SNAP, N, GRID = 1024, 16, 1024
T_HEADLINE = 1 << 24


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _mix_rows(N: int, spacing: float = 0.5):
    """Host-static mixing matrices mapping tone features
    [cos ω₁t, sin ω₁t, cos ω₂t, sin ω₂t] to array samples:
    x(t, n) = Σ_k amp·e^{jω_k t}·a_n(θ_k) →
    re = cos·a_re − sin·a_im, im = cos·a_im + sin·a_re.
    → (MixR (4, N), MixI (4, N)) f32."""
    from doa_tpu.ops.steering import _ula_steering_np

    a = _ula_steering_np(np.asarray(THETA, np.float64), N, spacing)
    amp = np.sqrt(2.0 * 10 ** (SNR_DB / 10.0))  # noise power = 2 (unit
    #                                             normal re/im planes)
    rows_re, rows_im = [], []
    for k in range(len(THETA)):
        ar = (a[k].real * amp).astype(np.float64)
        ai = (a[k].imag * amp).astype(np.float64)
        rows_re += [ar, -ai]
        rows_im += [ai, ar]
    return (np.stack(rows_re).astype(np.float32),
            np.stack(rows_im).astype(np.float32))


def _feature_consts(tp: int):
    """Per-column constants of the (rows, 4·tp) feature matrix for the
    interleaved layout: column c = 4p + j holds
    cos(ω_{k(j)}·(tp·r' + p) + sin-shift), r' = r mod PERIOD/tp."""
    w = 2.0 * np.pi * np.asarray(CYCLES, np.float64) / PERIOD
    k_c = np.tile([0, 0, 1, 1], tp)
    p_c = np.repeat(np.arange(tp), 4)
    is_sin = np.tile([0.0, 1.0, 0.0, 1.0], tp)
    colw = w[k_c]
    coloff = colw * p_c - is_sin * (np.pi / 2.0)  # cos(x−π/2) = sin x
    return (colw.astype(np.float32), coloff.astype(np.float32))


def bench_config(**overrides):
    """The headline configuration (package defaults: e1 + MGS + warm
    start + escalation armed), with optional field overrides."""
    import dataclasses

    from doa_tpu.configs import (
        ArrayGeometry, DoaConfig, Estimator, GridSpec1D)

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=N,
                               norm_spacing=0.5),
        snapshot_size=SNAP, overlap=0, num_sources=2,
        estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=GRID),
        num_max_vals=2)
    return dataclasses.replace(cfg, **overrides)


def make_scene(T: int, seed: int = 0):
    """Planted scene as a device-resident interleaved buffer
    f32[T/TPACK, 2N·TPACK], generated on the device from `seed`."""
    import jax
    import jax.numpy as jnp

    from doa_tpu.ops.interleaved import interleave_factor

    tp = interleave_factor(N)
    MixR, MixI = _mix_rows(N)
    Mix = np.zeros((4 * tp, 2 * N * tp), np.float32)
    ilv = np.empty((4, 2 * N), np.float32)
    ilv[:, 0::2] = MixR
    ilv[:, 1::2] = MixI
    for p in range(tp):
        Mix[4 * p:4 * (p + 1), 2 * N * p:2 * N * (p + 1)] = ilv
    colw, coloff = _feature_consts(tp)

    @jax.jit
    def gen(key):
        rows = T // tp
        r = jnp.arange(rows, dtype=jnp.int32) % (PERIOD // tp)
        rf = (tp * r).astype(jnp.float32)
        F4 = jnp.cos(rf[:, None] * jnp.asarray(colw)[None, :]
                     + jnp.asarray(coloff)[None, :])
        sig = jnp.einsum("rc,cd->rd", F4, jnp.asarray(Mix),
                         precision=jax.lax.Precision.HIGHEST)
        return sig + jax.random.normal(key, (rows, 2 * N * tp),
                                       jnp.float32)

    return jax.block_until_ready(gen(jax.random.key(seed)))


def ingest(xil, mode: str):
    """Resident ingest buffer for an ingest mode: "float32" as is,
    "bfloat16" cast, "int8" quantized (io.native)."""
    import jax
    import jax.numpy as jnp

    if mode == "bfloat16":
        return jax.block_until_ready(xil.astype(jnp.bfloat16))
    if mode == "int8":
        from doa_tpu.io.native import quantize_interleaved_int8
        return jax.block_until_ready(quantize_interleaved_int8(xil)[0])
    return xil


def build_call(cfg, xil):
    """→ zero-argument callable running the production streaming shape
    (peaks out, spectra dropped) on the resident buffer."""
    import jax.numpy as jnp

    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    pipe = build_pipeline_tpu(cfg, return_spectra=False)
    if not pipe.fast_path:
        raise SystemExit("bench config is not on the interleaved path")
    Ar, Ai = pipe.steering_planes
    cr = jnp.ones((N,), jnp.float32)
    ci = jnp.zeros((N,), jnp.float32)
    return lambda: pipe.jitted_ilv(xil, cr, ci, Ar, Ai)  # noqa: E731


def angle_error(out) -> float:
    """Max |error| (deg) of the sorted MUSIC peaks against the planted
    truth over every window."""
    ang = np.sort(np.asarray(out["peak_angles"]["music"]), axis=-1)
    return float(np.abs(ang - np.asarray(THETA, np.float32)).max())


def check_angles(out):
    """Correctness tripwire: every window's sorted MUSIC peaks must hit
    the planted 70°/110° to ≤0.5°."""
    err = angle_error(out)
    _log(f"angle check: max |err| = {err:.4f} deg (truth {THETA})")
    if not np.isfinite(err) or err > 0.5:
        raise SystemExit(
            f"bench CORRECTNESS failure: planted sources {THETA} "
            f"estimated with max error {err:.3f} deg (> 0.5)")
    return err


def time_call(call, iters: int = 64, latency_iters: int = 6):
    """→ (latency-fenced s/call, pipelined s/call)."""
    import jax

    t0 = time.perf_counter()
    for _ in range(latency_iters):
        jax.block_until_ready(call())
    lat = (time.perf_counter() - t0) / latency_iters
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = call()
    jax.block_until_ready(out)
    return lat, (time.perf_counter() - t0) / iters


def main():
    import jax

    from doa_tpu.utils.profiling import device_summary, use_compile_cache

    use_compile_cache()
    _log(device_summary())
    if jax.devices()[0].platform == "cpu":
        raise SystemExit("bench: no accelerator found (JAX sees only "
                         "the CPU)")
    B = T_HEADLINE // SNAP
    call = build_call(bench_config(), make_scene(T_HEADLINE))
    _log("compiling + warming")
    check_angles(call())
    lat, pipe_s = time_call(call)
    _log(f"latency-fenced: {B / lat:.0f} snapshots/s "
         f"({lat * 1e3:.3f} ms/call)")
    _log(f"pipelined N=64: {B / pipe_s:.0f} snapshots/s "
         f"({pipe_s * 1e3:.3f} ms/call)")
    snaps_per_s = B / pipe_s
    realtime = 10e6 / SNAP                  # snapshots/s at 10 Msps
    print(json.dumps({
        "metric": "cov_eigh_music_snapshots_per_s_per_chip_16el",
        "value": round(snaps_per_s, 1),
        "unit": "snapshots/s",
        "vs_baseline": round(snaps_per_s / realtime, 3),
    }))


if __name__ == "__main__":
    main()
