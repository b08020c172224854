"""Smoke test of the DoA pipeline on the accelerator, through the public
entry points (build_pipeline_tpu, pipe.interleaved, StreamingDriver,
build_sharded_pipeline), at real sizes, with random scenes from fixed
seeds.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs of one host: the sharded
                                  # phase and its one-device reference

Phases (one or more lines each, all before the last):
  device     JAX's devices and the card's name and power limit;
             fails unless the platform is "gpu".
  presets    planted scenes through c1-c5, TOPS, fast_bf16 and fast_int8;
             each angle error against its tolerance.
  parity     every XLA stage that replaced a hand-written kernel against
             the numpy golden (tests/golden.py, float64 on the host).
  headline   the bench cell (16-el ULA, S=G=1024, T=2^24): compile time,
             memory, fenced and pipelined ms/call, snapshots/s, and each
             stage's time beside its memory-bandwidth floor; then the c5
             step's stage split.
  precision  the headline scene at matmul precision "highest" and
             "tensorfloat32": angle error and time of each.
  streaming  c4 through StreamingDriver.run_iter and scan_capture against
             one offline call on the concatenated capture.

Any failure raises: the script exits non-zero and prints no result. The
last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM device-memory bandwidth (NVIDIA data sheet): the floor of a
# bandwidth-bound stage is its bytes over this rate.
HBM_BYTES_PER_S = 3.35e12
CARD = "card not measured"     # nvidia-smi name and power limit


def emit(phase: str, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def _imports():
    """Put the checkout's package and test golden on the path and make
    sure the package imported is THIS checkout's."""
    for p in (HERE, os.path.join(HERE, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import doa_tpu
    pkg = os.path.dirname(os.path.abspath(doa_tpu.__file__))
    if os.path.dirname(pkg) != HERE:
        raise SmokeFailure(f"doa_tpu imported from {pkg}, not from the "
                           f"checkout at {HERE}")


def _sorted_err(ang, truth):
    """Max over windows of |sorted estimates − sorted truth| (deg)."""
    a = np.sort(np.asarray(ang), axis=-1)
    return float(np.abs(a - np.sort(np.asarray(truth))).max())


def _timed(fn, iters: int):
    """→ (fenced s/call, pipelined s/call) after one warm call."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn())
    fenced = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return fenced, (time.perf_counter() - t0) / iters


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------

def phase_presets(scale: int = 1, bench_T: int = 1 << 24):
    """Planted scenes of the five BASELINE presets, TOPS, and the bench
    scene through fast_bf16 / fast_int8 (pipe.interleaved). `scale`
    divides the window counts (tests); widths are the presets' own."""
    import dataclasses

    import bench
    from doa_tpu import PRESETS, cpx
    from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                                 GridSpec1D, WidebandSpec)
    from doa_tpu.io.synthetic import (SourceSpec, synth_ula_iq,
                                      synth_wideband_ula_iq,
                                      synth_wideband_ura_iq)
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    results = {}

    def nb(name, cfg, srcs, T, seed, truth, keys=("music",), tol=0.5):
        x = synth_ula_iq(srcs, cfg.geometry.num_elements, 0.5, T,
                         snr_db=10, seed=seed).astype(np.complex64)
        r = build_pipeline_tpu(cfg)(x)
        for k in keys:
            err = _sorted_err(r.peak_angles[k], truth)
            emit("presets", case=f"{name}/{k}", max_err_deg=f"{err:.4f}",
                 tol_deg=tol, rule="max over windows, 10 dB",
                 precision=cpx.MATMUL_PRECISION)
            check(np.isfinite(err) and err <= tol,
                  f"{name}/{k}: max angle error {err} > {tol}")
            results[f"{name}/{k}"] = err

    S = SourceSpec
    nb("c1", PRESETS["c1_ula4_tone"], [S(theta_deg=72.3, freq_norm=0.1)],
       64 * 256 // scale, 1, [72.3])
    nb("c2", PRESETS["c2_ula8_2src"],
       [S(theta_deg=60.0, freq_norm=0.1), S(theta_deg=110.0,
                                            freq_norm=0.31)],
       16 * 2048 // scale, 2, [60.0, 110.0], keys=("music", "capon"))
    nb("c3", PRESETS["c3_ula16_calib_smooth"],
       [S(theta_deg=40.0, freq_norm=0.12), S(theta_deg=70.0,
                                             freq_norm=0.12),
        S(theta_deg=100.0, freq_norm=0.3)],
       32 * 1024 // scale, 3, [40.0, 70.0, 100.0])
    nb("c4", PRESETS["c4_ula16_streaming"],
       [S(theta_deg=80.0, freq_norm=0.11), S(theta_deg=100.0,
                                             freq_norm=0.27)],
       32 * 1024 // scale, 4, [80.0, 100.0])

    # c5: planar 8×8, 16 subbands, 181×91 az/el grid. Tolerance of
    # tests/test_2d_wideband.py::test_config5_preset_end_to_end: the
    # per-source median (az, el) within 2.0° (great-circle-free hypot).
    cfg = PRESETS["c5_ura64_wideband"]
    truth = [(-20.0, 30.0), (35.0, 60.0)]
    x = synth_wideband_ura_iq(
        [S(az_deg=-20.0, el_deg=30.0, freq_norm=0.05, bandwidth_norm=0.2),
         S(az_deg=35.0, el_deg=60.0, freq_norm=0.25, bandwidth_norm=0.2)],
        cfg.geometry.shape, 0.5, 32 * 1024 // scale,
        fractional_bw=cfg.wideband.fractional_bw, snr_db=10, seed=5)
    ang = np.asarray(build_pipeline_tpu(cfg)(
        x.astype(np.complex64)).peak_angles["music"])
    order = np.argsort(ang[..., 0], axis=-1)
    med = np.median(np.take_along_axis(ang, order[..., None], 1), 0)
    err = max(float(np.hypot(med[k, 0] - truth[k][0],
                             med[k, 1] - truth[k][1])) for k in range(2))
    emit("presets", case="c5/music", median_err_deg=f"{err:.4f}",
         tol_deg=2.0, rule="per-source median (az,el) hypot, 10 dB",
         precision=cpx.MATMUL_PRECISION)
    check(err <= 2.0, f"c5: median az/el error {err} > 2.0")
    results["c5/music"] = err

    # TOPS: 16-el ULA, 8 subbands at fractional bandwidth 0.4. Tolerance
    # of tests/test_tops.py: sorted per-window median within 2.0°.
    tops_cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024, num_sources=2, estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=361),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.4,
                              fusion="tops"),
        num_max_vals=2)
    x = synth_wideband_ula_iq(
        [S(theta_deg=60.0, freq_norm=0.0, bandwidth_norm=0.5),
         S(theta_deg=120.0, freq_norm=0.0, bandwidth_norm=0.5)],
        16, 0.5, 32 * 1024 // scale, fractional_bw=0.4, snr_db=10, seed=8)
    med = np.median(np.sort(np.asarray(build_pipeline_tpu(tops_cfg)(
        x.astype(np.complex64)).peak_angles["tops"]), -1), 0)
    err = float(np.abs(med - np.array([60.0, 120.0])).max())
    emit("presets", case="tops", median_err_deg=f"{err:.4f}", tol_deg=2.0,
         rule="sorted per-window median, 10 dB",
         precision=cpx.MATMUL_PRECISION)
    check(err <= 2.0, f"tops: median error {err} > 2.0")
    results["tops"] = err

    # bench scene (70°/110°, 10 dB) through the ingest fast modes
    xil = bench.make_scene(bench_T)
    for name, mode in (("fast_bf16", "bfloat16"), ("fast_int8", "int8")):
        cfg = dataclasses.replace(PRESETS[name], grid=GridSpec1D(
            num_points=bench.GRID))
        pipe = build_pipeline_tpu(cfg, return_spectra=False)
        out = pipe.interleaved(bench.ingest(xil, mode))
        err = _sorted_err(out.peak_angles["music"], bench.THETA)
        emit("presets", case=name, ingest=mode,
             windows=out.peak_angles["music"].shape[0],
             max_err_deg=f"{err:.4f}", tol_deg=0.5,
             rule="max over windows, 10 dB",
             precision=f"{mode} ingest, {cpx.MATMUL_PRECISION}")
        check(np.isfinite(err) and err <= 0.5,
              f"{name}: max angle error {err} > 0.5")
        results[name] = err
    return results


# ---------------------------------------------------------------------------
# parity against the numpy golden
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / max(np.abs(b).max(), 1e-300))


def phase_parity(windows: int = 16, grid: int = 1024,
                 c5_windows: int = 8):
    """Each replaced stage against tests/golden.py over a subset of
    windows at real widths. Tolerances are relative to the reference's
    max |value| at cpx.MATMUL_PRECISION."""
    import jax
    import jax.numpy as jnp

    import golden
    from doa_tpu import PRESETS, cpx
    from doa_tpu.configs import GridSpec1D
    from doa_tpu.ops.interleaved import cov_embedded, interleave_factor
    from doa_tpu.ops.peaks import find_local_max_2d
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    prec = cpx.MATMUL_PRECISION
    res = {}
    N, S = 16, 1024
    x = golden.synthetic_ula_iq([70.0, 110.0], N, 0.5, (windows + 1) * S,
                                snr_db=10, seed=11).astype(np.complex64)
    rng = np.random.default_rng(12)
    c = ((1 + 0.1 * rng.standard_normal(N))
         * np.exp(1j * rng.uniform(-0.3, 0.3, N))).astype(np.complex64)
    tp = interleave_factor(N)
    xil = jnp.asarray(x.view(np.float32).reshape(-1, 2 * N * tp))
    xc = x.astype(np.complex128) * c

    def embed_np(R):
        return np.block([[R.real, -R.imag], [R.imag, R.real]])

    for overlap in (0, 512):
        for fb in (False, True):
            f = jax.jit(cpx.f32_matmuls(lambda z, cr, ci: cov_embedded(
                z, cr, ci, N=N, snapshot_size=S, overlap=overlap,
                fb=fb)[1]))
            E = np.asarray(f(xil, jnp.asarray(c.real), jnp.asarray(c.imag)))
            R_ref = golden.sample_covariance(
                golden.frame_samples(xc, S, overlap), fb_average=fb)
            err = _rel(E, embed_np(R_ref))
            tol = 1e-4
            emit("parity", stage="interleaved_cov_E(R)", N=N, S=S,
                 overlap=overlap, fb=fb, windows=E.shape[0],
                 rel_err=f"{err:.2e}", tol=tol, precision=prec)
            check(err <= tol, f"cov_embedded parity {err} > {tol}")
            res[f"cov/{overlap}/{fb}"] = err

    # MUSIC spectrum (power subspace + scan) vs golden eigh MUSIC
    import bench
    cfg = bench.bench_config(grid=GridSpec1D(num_points=grid))
    pipe = build_pipeline_tpu(cfg)
    P = np.asarray(pipe(x).spectra["music"])
    A = (np.asarray(pipe.steering_planes[0])
         + 1j * np.asarray(pipe.steering_planes[1]))
    R_ref = golden.sample_covariance(golden.frame_samples(
        x.astype(np.complex128), S, 0))
    P_ref = golden.music_spectrum(R_ref, A, cfg.num_sources)
    err = float(np.abs(P - P_ref).max())
    tol = 5e-3
    emit("parity", stage="music_spectrum", N=N, G=grid, windows=P.shape[0],
         abs_err=f"{err:.2e}", tol=tol, precision=prec,
         note="max-normalized spectra")
    check(err <= tol, f"MUSIC spectrum parity {err} > {tol}")
    res["music"] = err

    # 2-D peaks at the c5 grid (181 × 91), MUSIC-shaped spectra
    Ga, Ge, B = 181, 91, 2 * windows
    az = np.linspace(-90, 90, Ga)[None, :, None]
    el = np.linspace(0, 90, Ge)[None, None, :]
    ca = rng.uniform(-60, 60, (B, 1, 1))
    ce = rng.uniform(20, 70, (B, 1, 1))
    P2 = (1.0 / (((az - ca) / 30) ** 2 + ((el - ce) / 20) ** 2 + 1e-3)
          + 0.01 * rng.random((B, Ga, Ge))).astype(np.float32)
    P2 /= P2.max(axis=(1, 2), keepdims=True)
    v, pa, pe = jax.jit(lambda p: find_local_max_2d(
        p, 2, (-90.0, 90.0), (0.0, 90.0), refine=True))(jnp.asarray(P2))
    gv, ga, ge = golden.find_local_max_2d(P2, 2, (-90.0, 90.0),
                                          (0.0, 90.0), refine=True)
    err = max(float(np.abs(np.asarray(pa) - ga).max()),
              float(np.abs(np.asarray(pe) - ge).max()))
    emit("parity", stage="peaks_2d", grid=f"{Ga}x{Ge}", windows=B,
         abs_err_deg=f"{err:.2e}", tol_deg=1e-4,
         value_rel_err=f"{_rel(v, gv):.2e}", precision="float32")
    check(err <= 1e-4 and _rel(v, gv) <= 1e-6, f"peaks_2d parity {err}")
    res["peaks2d"] = err

    # c5 fused spectrum: channelizer + subband covariance + subspace +
    # incoherent fusion vs golden
    from doa_tpu.io.synthetic import SourceSpec, synth_wideband_ura_iq
    cfg5 = PRESETS["c5_ura64_wideband"]
    x5 = synth_wideband_ura_iq(
        [SourceSpec(az_deg=-20.0, el_deg=30.0, freq_norm=0.05,
                    bandwidth_norm=0.2),
         SourceSpec(az_deg=35.0, el_deg=60.0, freq_norm=0.25,
                    bandwidth_norm=0.2)],
        cfg5.geometry.shape, 0.5, c5_windows * cfg5.snapshot_size,
        fractional_bw=cfg5.wideband.fractional_bw, snr_db=10,
        seed=6).astype(np.complex64)
    pipe5 = build_pipeline_tpu(cfg5)
    P5 = np.asarray(pipe5(x5).spectra["music"])
    Wr, Wi, Asr, Asi = (np.asarray(a) for a in pipe5.wb_args)
    R_sub = golden.subband_covariances(
        x5.astype(np.complex128), cfg5.wideband.num_subbands,
        cfg5.snapshot_size, cfg5.overlap)
    P5_ref = golden.wideband_music_spectrum(R_sub, Asr + 1j * Asi,
                                            cfg5.num_sources)
    err = float(np.abs(P5 - P5_ref).max())
    tol = 5e-3
    emit("parity", stage="c5_fused_spectrum", N=64, F=16,
         grid="181x91", windows=P5.shape[0], abs_err=f"{err:.2e}", tol=tol,
         precision=prec, note="mean of max-normalized subband spectra")
    check(err <= tol, f"c5 fused spectrum parity {err} > {tol}")
    res["c5"] = err
    return res


# ---------------------------------------------------------------------------
# headline: end to end and stage by stage
# ---------------------------------------------------------------------------

def _stage_line(name, seconds, nbytes, **kv):
    floor = nbytes / HBM_BYTES_PER_S
    emit("headline", stage=name, ms=f"{seconds * 1e3:.4f}",
         floor_ms=f"{floor * 1e3:.4f}",
         x_floor=f"{seconds / floor:.2f}", bytes=nbytes, card=CARD, **kv)
    return {"ms": seconds * 1e3, "floor_ms": floor * 1e3}


def phase_headline(T: int = 1 << 24, iters: int = 32,
                   c5_windows: int = 2048):
    """The bench cell end to end, its stages against their floors, then
    the c5 step's stage split."""
    import jax
    import jax.numpy as jnp

    import bench
    from doa_tpu.cpx import Cpx, f32_matmuls
    from doa_tpu.ops import cpx_ops
    from doa_tpu.ops.interleaved import cov_embedded
    from doa_tpu.ops.peaks import find_local_max
    from doa_tpu.pipeline_tpu import build_pipeline_tpu, warm_signal_subspace

    out = {}
    cfg = bench.bench_config()
    N, S, G = bench.N, bench.SNAP, bench.GRID
    B = T // S
    xil = bench.make_scene(T)
    pipe = build_pipeline_tpu(cfg, return_spectra=False)
    Ar, Ai = pipe.steering_planes
    cr = jnp.ones((N,), jnp.float32)
    ci = jnp.zeros((N,), jnp.float32)
    t0 = time.perf_counter()
    compiled = pipe.jitted_ilv.lower(xil, cr, ci, Ar, Ai).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    emit("headline", compile_s=f"{compile_s:.2f}",
         memory_analysis=str(mem).replace(" ", "").replace("\n", ";"))
    run = lambda: compiled(xil, cr, ci, Ar, Ai)  # noqa: E731
    res = run()
    err = _sorted_err(res["peak_angles"]["music"], bench.THETA)
    check(err <= 0.5, f"headline angle error {err} > 0.5")
    fenced, piped = _timed(run, iters)
    in_bytes = xil.size * xil.dtype.itemsize
    total_floor = (in_bytes + B * 2 * N * 2 * N * 4 * 4 + B * G * 4 * 2)
    emit("headline", T=T, windows=B, max_err_deg=f"{err:.4f}",
         fenced_ms=f"{fenced * 1e3:.4f}", pipelined_ms=f"{piped * 1e3:.4f}",
         snapshots_per_s=f"{B / piped:.1f}",
         x_realtime=f"{B / piped / (10e6 / S):.2f}",
         floor_ms=f"{total_floor / HBM_BYTES_PER_S * 1e3:.4f}", card=CARD)
    out["pipelined_ms"] = piped * 1e3
    out["snapshots_per_s"] = B / piped

    # stages, each its own jitted program at the real shape
    ingest = jax.jit(f32_matmuls(lambda z, a, b: cov_embedded(
        z, a, b, N=N, snapshot_size=S)[1]))
    E = jax.block_until_ready(ingest(xil, cr, ci))
    subspace = jax.jit(f32_matmuls(lambda e: warm_signal_subspace(e, cfg)[0]))
    V = jax.block_until_ready(subspace(E))

    def _scan(v, a_r, a_i):
        den = jnp.maximum(cpx_ops.music_denominator_subspace(
            v, Cpx(a_r, a_i)), 0.0)
        P = 1.0 / jnp.maximum(den, jnp.finfo(jnp.float32).tiny)
        return P / jnp.max(P, axis=-1, keepdims=True)

    scan = jax.jit(f32_matmuls(_scan))
    P = jax.block_until_ready(scan(V, Ar, Ai))
    peaks = jax.jit(lambda p: find_local_max(
        p, cfg.num_max_vals, cfg.grid.lo_deg, cfg.grid.hi_deg, refine=True))
    e_bytes = E.size * 4
    stages = {}
    stages["ingest_gram"] = _stage_line(
        "ingest_gram", _timed(lambda: ingest(xil, cr, ci), iters)[1],
        in_bytes + e_bytes)
    stages["subspace"] = _stage_line(
        "subspace_warm", _timed(lambda: subspace(E), iters)[1],
        3 * e_bytes, note="E read 3x: mean + 2 warm applies")
    stages["scan"] = _stage_line(
        "music_scan_normalize", _timed(lambda: scan(V, Ar, Ai), iters)[1],
        V.size * 4 + P.size * 4)
    stages["peaks"] = _stage_line(
        "peaks_1d", _timed(lambda: peaks(P), iters)[1], P.size * 4)
    out["stages"] = stages
    out["c5"] = _c5_split(c5_windows, max(iters // 4, 3))
    return out


def _c5_split(windows: int, iters: int):
    """c5 (64-el URA, 16 subbands, 181×91 grid) step split into front
    end, subspace, scan + fusion and 2-D peaks, on device-generated
    noise (the timing does not depend on the scene)."""
    import jax
    import jax.numpy as jnp

    from doa_tpu import PRESETS
    from doa_tpu.cpx import Cpx, f32_matmuls
    from doa_tpu.ops.interleaved import deinterleave, interleave_factor
    from doa_tpu.ops.peaks import find_local_max_2d
    from doa_tpu.ops.wideband import (fuse_subband_music,
                                      subband_covariances,
                                      subband_subspaces)
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    cfg = PRESETS["c5_ura64_wideband"]
    N, S = cfg.geometry.num_elements, cfg.snapshot_size
    T = windows * S
    tp = interleave_factor(N)
    xil = jax.block_until_ready(jax.random.normal(
        jax.random.key(7), (T // tp, 2 * N * tp), jnp.float32))
    pipe = build_pipeline_tpu(cfg, return_spectra=False)
    Wr, Wi, Asr, Asi = pipe.wb_args
    Ar, Ai = pipe.steering_planes
    cr = jnp.ones((N,), jnp.float32)
    ci = jnp.zeros((N,), jnp.float32)
    g2 = cfg.grid2d
    e2e = _timed(lambda: pipe.jitted_ilv(xil, cr, ci, Ar, Ai,
                                         *pipe.wb_args), iters)[1]
    front = jax.jit(f32_matmuls(lambda z, wr, wi: subband_covariances(
        deinterleave(z, N), Cpx(wr, wi), cfg)))
    R = jax.block_until_ready(front(xil, Wr, Wi))
    sub = jax.jit(f32_matmuls(lambda r: subband_subspaces(r, cfg)))
    V = jax.block_until_ready(sub(R))
    fuse = jax.jit(f32_matmuls(lambda v, ar, ai: fuse_subband_music(
        v, Cpx(ar, ai), cfg)))
    P = jax.block_until_ready(fuse(V, Asr, Asi))
    pk = jax.jit(lambda p: find_local_max_2d(
        p.reshape(p.shape[0], g2.num_az, g2.num_el), cfg.num_max_vals,
        (g2.az_lo_deg, g2.az_hi_deg), (g2.el_lo_deg, g2.el_hi_deg),
        refine=True))
    B = P.shape[0]
    r_bytes = 2 * R.re.size * 4
    split = {
        "front_end": _stage_line(
            "c5_front_end", _timed(lambda: front(xil, Wr, Wi), iters)[1],
            xil.size * 4 + r_bytes, note="deinterleave+DFT+subband cov"),
        "subspace": _stage_line(
            "c5_subspace", _timed(lambda: sub(R), iters)[1],
            2 * r_bytes * 3, note="E(R) read 3x"),
        "scan_fusion": _stage_line(
            "c5_scan_fusion", _timed(lambda: fuse(V, Asr, Asi), iters)[1],
            V.size * 4 + P.size * 4, note="one P write"),
        "peaks_2d": _stage_line(
            "c5_peaks_2d", _timed(lambda: pk(P), iters)[1], P.size * 4),
    }
    emit("headline", cell="c5", windows=B, T=T,
         step_ms=f"{e2e * 1e3:.4f}", snapshots_per_s=f"{B / e2e:.1f}",
         card=CARD)
    split["step_ms"] = e2e * 1e3
    return split


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def phase_precision(T: int = 1 << 24, iters: int = 32):
    """The headline scene at each matmul precision: the module constant
    is set before each pipeline is built (it is read at trace time)."""
    import bench
    from doa_tpu import cpx

    xil = bench.make_scene(T, seed=1)
    B = T // bench.SNAP
    keep = cpx.MATMUL_PRECISION
    res = {}
    try:
        for prec in ("highest", "tensorfloat32"):
            cpx.MATMUL_PRECISION = prec
            call = bench.build_call(bench.bench_config(), xil)
            err = bench.angle_error(call())
            piped = _timed(call, iters)[1]
            emit("precision", matmul_precision=prec,
                 max_err_deg=f"{err:.4f}", tol_deg=0.5,
                 pipelined_ms=f"{piped * 1e3:.4f}",
                 snapshots_per_s=f"{B / piped:.1f}", card=CARD)
            check(np.isfinite(err) and err <= 0.5,
                  f"precision {prec}: angle error {err} > 0.5")
            res[prec] = {"err": err, "ms": piped * 1e3}
    finally:
        cpx.MATMUL_PRECISION = keep
    return res


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

def phase_streaming(block: int = 1 << 20, n_blocks: int = 8):
    """c4 (16-el ULA, S=1024, overlap 512) as n_blocks host blocks through
    StreamingDriver.run_iter and as one scan_capture program; both must
    reproduce one offline call on the concatenated capture."""
    import jax.numpy as jnp

    from doa_tpu import PRESETS, cpx
    from doa_tpu.io import SourceSpec, synth_ula_iq
    from doa_tpu.io.stream import StreamingDriver
    from doa_tpu.ops.interleaved import interleave_factor
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    cfg = PRESETS["c4_ula16_streaming"]
    N = cfg.geometry.num_elements
    T = block * n_blocks
    x = synth_ula_iq([SourceSpec(theta_deg=80.0, freq_norm=0.11),
                      SourceSpec(theta_deg=100.0, freq_norm=0.27)],
                     N, 0.5, T, snr_db=10, seed=4).astype(np.complex64)
    pipe = build_pipeline_tpu(cfg, return_spectra=False)
    # peaks come ordered by value; two equal-power sources may swap
    # places between runs, so every comparison sorts by angle
    srt = lambda a: np.sort(np.asarray(a), axis=-1)  # noqa: E731
    t0 = time.perf_counter()
    off = srt(pipe(x).peak_angles["music"])
    t_off = time.perf_counter() - t0
    drv = StreamingDriver(pipe, block_samples=block)
    t0 = time.perf_counter()
    parts = [srt(r.peak_angles["music"]) for _, r in
             drv.run_iter(x[i * block:(i + 1) * block]
                          for i in range(n_blocks))]
    t_drv = time.perf_counter() - t0
    streamed = np.concatenate(parts, axis=0)
    check(streamed.shape == off.shape,
          f"streamed windows {streamed.shape} != offline {off.shape}")
    d_drv = float(np.abs(streamed - off).max())
    tp = interleave_factor(N)
    blocks = jnp.asarray(np.ascontiguousarray(x).view(np.float32).reshape(
        n_blocks, block // tp, 2 * N * tp))
    t0 = time.perf_counter()
    sc = srt(pipe.scan_capture(blocks)["peak_angles"]["music"])
    t_scan = time.perf_counter() - t0
    sc = sc.reshape(-1, sc.shape[-1])[pipe.scan_capture.prefix_windows:]
    check(sc.shape == off.shape,
          f"scan_capture windows {sc.shape} != offline {off.shape}")
    d_scan = float(np.abs(sc - off).max())
    emit("streaming", cell="c4", blocks=n_blocks, block_samples=block,
         windows=off.shape[0], driver_vs_offline_deg=f"{d_drv:.2e}",
         scan_capture_vs_offline_deg=f"{d_scan:.2e}", tol_deg=1e-3,
         precision=cpx.MATMUL_PRECISION,
         first_call_s=f"offline {t_off:.2f} driver {t_drv:.2f} "
                      f"scan {t_scan:.2f}".replace(" ", "_"))
    check(d_drv <= 1e-3, f"driver vs offline {d_drv} > 1e-3")
    check(d_scan <= 1e-3, f"scan_capture vs offline {d_scan} > 1e-3")
    err = _sorted_err(off, [80.0, 100.0])
    check(err <= 0.5, f"c4 streaming angle error {err} > 0.5")
    return {"driver": d_drv, "scan": d_scan}


# ---------------------------------------------------------------------------
# four devices
# ---------------------------------------------------------------------------

def phase_four(devices=None, T_nb: int = 1 << 22, c5_windows: int = 256,
               iters: int = 8):
    """build_sharded_pipeline on four devices against the one-device
    pipeline on the same input (≤ 0.01° on valid windows): c4 on meshes
    (4,1) and (2,2), and the c5 EP wideband (subbands over "grid") on
    (2,2). Each line also times both programs on resident inputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from doa_tpu import PRESETS, cpx
    from doa_tpu.io.synthetic import SourceSpec, synth_wideband_ura_iq
    from doa_tpu.ops.interleaved import interleave_factor
    from doa_tpu.parallel import MeshSpec, build_sharded_pipeline, make_mesh
    from doa_tpu.parallel.mesh import SNAP_AXIS
    from doa_tpu.parallel.sharded import num_valid_windows
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    devices = list(jax.devices()[:4] if devices is None else devices)
    check(len(devices) == 4, f"--four needs 4 devices, found "
                             f"{len(devices)}")
    res = {}

    def one_device(cfg, x):
        """→ (sorted peak angles, pipelined s/call) of the one-device
        pipeline on device 0."""
        N = cfg.geometry.num_elements
        pipe = build_pipeline_tpu(cfg, return_spectra=False)
        xil = jax.device_put(np.ascontiguousarray(x).view(
            np.float32).reshape(x.shape[0] // interleave_factor(N), -1),
            devices[0])
        args = (xil, jnp.ones((N,), jnp.float32),
                jnp.zeros((N,), jnp.float32), *pipe.steering_planes,
                *(pipe.wb_args or ()))
        out = pipe.jitted_ilv(*args)
        return (np.sort(np.asarray(out["peak_angles"]["music"]), -1),
                _timed(lambda: pipe.jitted_ilv(*args), iters)[1])

    def sharded(cfg, mesh, x, extra=()):
        """→ (peak angles, pipelined s/call) of the sharded pipeline on
        resident, time-sharded interleaved rows."""
        N = cfg.geometry.num_elements
        pipe = build_sharded_pipeline(cfg, mesh, return_spectra=False)
        check(pipe.fast, f"sharded {cfg} is not on the interleaved path")
        xil = jax.device_put(np.ascontiguousarray(x).view(
            np.float32).reshape(x.shape[0] // interleave_factor(N), -1),
            NamedSharding(mesh, P(SNAP_AXIS, None)))
        args = (xil, np.ones(N, np.float32), np.zeros(N, np.float32),
                *(pipe.wb_args if cfg.wideband.enabled
                  else pipe.steering_planes))
        out = pipe.jitted(*args)
        return (np.asarray(out["peak_angles_music"]),
                _timed(lambda: pipe.jitted(*args), iters)[1])

    cfg = PRESETS["c4_ula16_streaming"]
    x = np.asarray(bench.make_scene(T_nb)).view(np.complex64).reshape(
        T_nb, cfg.geometry.num_elements)
    a_ref, t_ref = one_device(cfg, x)
    B_valid = num_valid_windows(T_nb, cfg)
    for spec in (MeshSpec(4, 1), MeshSpec(2, 2)):
        a, t = sharded(cfg, make_mesh(spec, devices), x)
        d = float(np.abs(np.sort(a[:B_valid], -1) - a_ref).max())
        emit("four", cell="c4", mesh=f"{spec.n_snap}x{spec.n_grid}",
             windows=B_valid, vs_one_device_deg=f"{d:.2e}", tol_deg=0.01,
             precision=cpx.MATMUL_PRECISION,
             pipelined_ms=f"{t * 1e3:.4f}",
             one_device_ms=f"{t_ref * 1e3:.4f}",
             snapshots_per_s=f"{B_valid / t:.1f}", card=CARD)
        check(d <= 0.01, f"c4 mesh {spec}: {d} > 0.01")
        res[f"c4/{spec.n_snap}x{spec.n_grid}"] = d

    cfg5 = PRESETS["c5_ura64_wideband"]
    x5 = synth_wideband_ura_iq(
        [SourceSpec(az_deg=-20.0, el_deg=30.0, freq_norm=0.05,
                    bandwidth_norm=0.2),
         SourceSpec(az_deg=35.0, el_deg=60.0, freq_norm=0.25,
                    bandwidth_norm=0.2)],
        cfg5.geometry.shape, 0.5, c5_windows * cfg5.snapshot_size,
        fractional_bw=cfg5.wideband.fractional_bw, snr_db=10,
        seed=9).astype(np.complex64)
    a_ref, t_ref = one_device(cfg5, x5)
    a5, t5 = sharded(cfg5, make_mesh(MeshSpec(2, 2), devices), x5)
    d5 = float(np.abs(np.sort(a5, -1) - a_ref).max())
    emit("four", cell="c5_ep", mesh="2x2", windows=a5.shape[0],
         vs_one_device_deg=f"{d5:.2e}", tol_deg=0.01,
         precision=cpx.MATMUL_PRECISION,
         pipelined_ms=f"{t5 * 1e3:.4f}", one_device_ms=f"{t_ref * 1e3:.4f}",
         snapshots_per_s=f"{a5.shape[0] / t5:.1f}", card=CARD)
    check(d5 <= 0.01, f"c5 EP mesh 2x2: {d5} > 0.01")
    res["c5/2x2"] = d5
    return res


# ---------------------------------------------------------------------------

def main(argv=None):
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device sharded phase")
    args = ap.parse_args(argv)
    _imports()
    import jax

    from doa_tpu.utils.profiling import device_summary, use_compile_cache

    use_compile_cache()
    summary = device_summary()
    print(summary, flush=True)
    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {platform!r})",
              file=sys.stderr)
        return 2
    CARD = '"' + summary.splitlines()[1] + '"'
    from doa_tpu.io.native import get_lib
    emit("device", native_framer="built" if get_lib() else
         "not built (numpy fallback)")
    t0 = time.perf_counter()
    if args.four:
        phase_four()
        count = 4
    else:
        phase_presets()
        phase_parity()
        phase_headline()
        phase_precision()
        phase_streaming()
        count = len(devs)
    print(f"[done] seconds={time.perf_counter() - t0:.1f} card={CARD}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
