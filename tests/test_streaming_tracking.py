"""Streaming driver + tracker tests (config 4 capability)."""

import numpy as np
import queue

from doa_tpu import PRESETS
from doa_tpu.io import SourceSpec, synth_ula_iq
from doa_tpu.io.stream import StreamingDriver
from doa_tpu.pipeline import build_pipeline
from doa_tpu.tracking import TrackerConfig, track_batch_np


def _capture(T):
    return synth_ula_iq(
        [SourceSpec(theta_deg=55.0), SourceSpec(theta_deg=125.0,
                                                freq_norm=0.3)],
        16, 0.5, T, snr_db=10, seed=3)


def test_streaming_matches_offline():
    cfg = PRESETS["c4_ula16_streaming"]
    x = _capture(16384)
    pipe = build_pipeline(cfg)
    offline = np.asarray(pipe(x).peak_angles["music"])

    drv = StreamingDriver(pipe, block_samples=4096)
    streamed = []
    for i, res in drv.run_iter(x[j:j + 4096] for j in range(0, 16384, 4096)):
        streamed.append(np.asarray(res.peak_angles["music"]))
    streamed = np.concatenate(streamed, axis=0)
    # Offline: windows at every hop over the whole capture. Streamed blocks
    # re-serve `overlap` samples, so together they cover the same windows.
    assert streamed.shape == offline.shape
    np.testing.assert_allclose(streamed, offline, atol=0.01)
    assert drv.stats.blocks_processed == 4
    assert drv.stats.samples_processed == 16384


def test_streaming_threaded_with_drops():
    cfg = PRESETS["c4_ula16_streaming"]
    x = _capture(8192)
    pipe = build_pipeline(cfg)
    drv = StreamingDriver(pipe, block_samples=1024, ring_capacity=2)
    drv.start()
    for j in range(0, 8192, 1024):
        drv.push(x[j:j + 1024])
    drv.stop(wait=True)
    assert drv.stats.blocks_in == 8
    assert (drv.stats.blocks_processed + drv.stats.blocks_dropped
            == drv.stats.blocks_in)
    got = 0
    while True:
        try:
            drv.results.get_nowait()
            got += 1
        except queue.Empty:
            break
    assert got == drv.stats.blocks_processed


def test_tracker_follows_moving_emitters():
    # Two emitters crossing the array: linear motion + noisy detections.
    B = 120
    t = np.arange(B)
    truth1 = 50.0 + 0.3 * t          # 50 → 86 deg
    truth2 = 130.0 - 0.25 * t        # 130 → 100 deg
    rng = np.random.default_rng(0)
    det = np.stack([truth1 + 0.3 * rng.standard_normal(B),
                    truth2 + 0.3 * rng.standard_normal(B)], axis=1)
    # shuffle detection order per window + occasional dropout
    for b in range(B):
        if rng.random() < 0.5:
            det[b] = det[b, ::-1]
        if rng.random() < 0.05:
            det[b, rng.integers(2)] = rng.uniform(0, 180)  # clutter
    vals = np.ones_like(det)
    tracks = track_batch_np(det.astype(np.float32), vals.astype(np.float32),
                            TrackerConfig(max_tracks=4))
    # After confirmation, two tracks should follow the two emitters.
    tail = tracks[B // 2:]
    est_per_window = np.sort(tail, axis=1)[:, :]  # NaN sort to end
    # collect the two active track columns
    active_cols = ~np.all(np.isnan(tracks[B // 2:]), axis=0)
    assert active_cols.sum() >= 2
    act = tail[:, active_cols][:, :2]
    act = np.sort(act, axis=1)
    t2 = t[B // 2:]
    ref = np.sort(np.stack([50.0 + 0.3 * t2, 130.0 - 0.25 * t2], 1), 1)
    err = np.nanmean(np.abs(act - ref))
    assert err < 1.0, err


def test_stream_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp
    from doa_tpu.checkpoint import (
        StreamState, load_stream_state, save_stream_state)
    from doa_tpu.tracking import TrackerConfig, init_tracks, track_batch

    # run a tracker halfway, checkpoint, resume, compare with uninterrupted
    B = 60
    t = np.arange(B, dtype=np.float32)
    det = (80.0 + 0.2 * t)[:, None]
    vals = np.ones_like(det)
    tc = TrackerConfig(max_tracks=2)
    full_state, full_out = track_batch(det, vals, tc)

    half_state, half_out = track_batch(det[:30], vals[:30], tc)
    st = StreamState(track_state=half_state, samples_processed=30 * 512,
                     overlap_tail=np.zeros((4, 2), np.complex64),
                     cov_carry_re=np.zeros((2, 2, 2), np.float32),
                     cov_carry_im=np.zeros((2, 2, 2), np.float32))
    p = str(tmp_path / "stream.npz")
    save_stream_state(p, st)
    st2 = load_stream_state(p)
    assert st2.samples_processed == 30 * 512
    assert st2.overlap_tail.shape == (4, 2)
    _, resumed_out = track_batch(det[30:], vals[30:], tc,
                                 init=st2.track_state)
    np.testing.assert_allclose(
        np.asarray(resumed_out), np.asarray(full_out)[30:], atol=1e-4)


def test_config4_end_to_end_moving_emitters():
    """Full config-4 story: moving-emitter IQ -> streaming overlapped
    windows -> MUSIC peaks -> tracker follows both trajectories."""
    from doa_tpu.io.synthetic import synth_moving_ula_iq
    from doa_tpu.pipeline_tpu import build_pipeline_tpu
    from doa_tpu.tracking import TrackerConfig, track_batch_np

    cfg = PRESETS["c4_ula16_streaming"]
    T = 1 << 17  # 128 K samples -> 254 overlapped windows
    x = synth_moving_ula_iq(
        [(50.0, 80.0), (130.0, 100.0)], 16, 0.5, T, snr_db=10, seed=5)
    res = build_pipeline_tpu(cfg)(x)
    ang = np.asarray(res.peak_angles["music"]).astype(np.float32)
    val = np.asarray(res.peak_values["music"]).astype(np.float32)
    tracks = track_batch_np(ang, val, TrackerConfig(max_tracks=4,
                                                    gate_deg=4.0))
    B = ang.shape[0]
    # Evaluate the second half (tracks confirmed): each truth trajectory
    # matched by some track within 1.5 deg on average.
    u = (np.arange(B) * cfg.hop + cfg.snapshot_size / 2) / T
    truth1 = 50.0 + 30.0 * u
    truth2 = 130.0 - 30.0 * u
    tail = slice(B // 2, None)
    for truth in (truth1, truth2):
        errs = np.nanmin(
            np.abs(tracks[tail] - truth[tail, None]), axis=1)
        assert np.nanmean(errs) < 1.5, np.nanmean(errs)


def test_checkpoint_roundtrip_extensionless_path(tmp_path):
    """ADVICE r1: save/load must agree on '.npz' normalization."""
    from doa_tpu.checkpoint import (
        StreamState, load_stream_state, save_stream_state)

    p = str(tmp_path / "state_no_ext")     # no .npz extension
    save_stream_state(p, StreamState(samples_processed=77))
    st = load_stream_state(p)
    assert st.samples_processed == 77


def test_calibration_roundtrip_extensionless_path(tmp_path):
    from doa_tpu.calib.artifacts import (
        CalibrationArtifact, load_calibration, save_calibration)

    art = CalibrationArtifact(
        phase_offsets=np.array([0.0, 0.1], np.float32), num_elements=2)
    p = str(tmp_path / "calib_no_ext")
    save_calibration(p, art)
    art2 = load_calibration(p)
    np.testing.assert_allclose(art2.phase_offsets, art.phase_offsets)


def test_streaming_wideband_matches_offline():
    """StreamingDriver over a WIDEBAND pipeline (interleaved ingest
    route): streamed blocks must reproduce the offline window
    sequence. overlap=128 with F=8 keeps subband-domain framing aligned
    across block boundaries (hop_sub·F = hop divides block and
    overlap)."""
    from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                                 GridSpec1D, WidebandSpec)
    from doa_tpu.io.synthetic import synth_wideband_ula_iq
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    for overlap in (0, 128):
        cfg = DoaConfig(
            geometry=ArrayGeometry(kind="ula", num_elements=8,
                                   norm_spacing=0.5),
            snapshot_size=256, overlap=overlap, num_sources=2,
            estimators=(Estimator.MUSIC,),
            grid=GridSpec1D(num_points=181),
            wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1),
            num_max_vals=2)
        pipe = build_pipeline_tpu(cfg, return_spectra=False)
        assert pipe.wb_fast
        T, blk = 4096, 1024
        x = synth_wideband_ula_iq(
            [SourceSpec(theta_deg=62.0, freq_norm=0.0,
                        bandwidth_norm=0.5),
             SourceSpec(theta_deg=111.0, freq_norm=0.0,
                        bandwidth_norm=0.5)],
            8, 0.5, T, fractional_bw=0.1, snr_db=15,
            seed=3).astype(np.complex64)
        offline = np.asarray(pipe(x).peak_angles["music"])
        drv = StreamingDriver(pipe, block_samples=blk)
        streamed = [np.asarray(res.peak_angles["music"]) for _, res in
                    drv.run_iter(x[j:j + blk]
                                 for j in range(0, T, blk))]
        streamed = np.concatenate(streamed, axis=0)
        assert streamed.shape == offline.shape, (overlap, streamed.shape)
        np.testing.assert_allclose(streamed, offline, atol=0.01)


def test_scan_capture_wideband_matches_per_block():
    """scan_capture on a WIDEBAND fast-path pipeline: stacked blocks
    through one lax.scan device program must match per-block calls
    with the continuous-framing carry (F | overlap so subband framing
    aligns with the input-domain carry)."""
    import jax.numpy as jnp
    from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                                 GridSpec1D, WidebandSpec)
    from doa_tpu.io.synthetic import synth_wideband_ula_iq
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    N, S, OV, F = 8, 256, 128, 8
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=N,
                               norm_spacing=0.5),
        snapshot_size=S, overlap=OV, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=181),
        wideband=WidebandSpec(num_subbands=F, fractional_bw=0.1),
        num_max_vals=2)
    pipe = build_pipeline_tpu(cfg, return_spectra=False)
    assert pipe.wb_fast
    hop = S - OV
    M, T_blk = 3, 8 * hop
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=62.0, freq_norm=0.0, bandwidth_norm=0.5),
         SourceSpec(theta_deg=111.0, freq_norm=0.0,
                    bandwidth_norm=0.5)],
        N, 0.5, M * T_blk, fractional_bw=0.1, snr_db=15,
        seed=3).astype(np.complex64)
    from doa_tpu.ops.interleaved import interleave_factor
    tp = interleave_factor(N)
    xil = np.ascontiguousarray(x).view(np.float32).reshape(
        M * T_blk // tp, 2 * N * tp)
    blocks = xil.reshape(M, T_blk // tp, 2 * N * tp)

    out = pipe.scan_capture(blocks)
    angs = np.asarray(out["peak_angles"]["music"])   # (M, B_blk, k)
    C = hop * -(-OV // hop) // tp                    # carry rows
    for m in range(1, M):
        xb = np.concatenate([blocks[m - 1][-C:], blocks[m]], axis=0)
        ref = np.asarray(
            pipe.interleaved(jnp.asarray(xb)).peak_angles["music"])
        np.testing.assert_allclose(angs[m], ref, atol=1e-4)


def test_scan_capture_matches_per_block():
    """lax.scan capture mode: stacked blocks through one device program
    must match per-block calls with the continuous-framing carry
    (hop-aligned, longer than the overlap when hop does not divide it);
    the first block's zero-prefix windows are dropped."""
    import jax.numpy as jnp
    from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                                 GridSpec1D)
    from doa_tpu.io import SourceSpec, synth_ula_iq
    from doa_tpu.ops.interleaved import to_interleaved
    from doa_tpu.pipeline_tpu import build_pipeline_tpu
    from doa_tpu.cpx import Cpx

    N, S, OV = 8, 256, 64          # hop = 192 does NOT divide overlap
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=N,
                               norm_spacing=0.5),
        snapshot_size=S, overlap=OV, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=361), num_max_vals=2)
    pipe = build_pipeline_tpu(cfg, return_spectra=False)
    assert pipe.fast_path
    hop = S - OV
    C = hop * -(-OV // hop)        # carry samples (192)
    assert pipe.scan_capture.prefix_windows == C // hop == 1

    M, T_blk = 3, 5 * hop          # hop | T_blk required
    x = synth_ula_iq([SourceSpec(theta_deg=70.0, freq_norm=0.12),
                      SourceSpec(theta_deg=120.0, freq_norm=0.3)],
                     N, 0.5, M * T_blk, snr_db=15, seed=9)
    xc = Cpx.from_complex(x)
    xil = np.asarray(to_interleaved(xc.re, xc.im))
    rows_blk = xil.shape[0] // M
    blocks = xil.reshape(M, rows_blk, xil.shape[1])

    out = pipe.scan_capture(blocks)
    angs = np.asarray(out["peak_angles"]["music"])   # (M, B_blk, k)

    tp = xil.shape[1] // (2 * N)
    c_rows = C // tp
    # blocks 1..M-1: exact parity vs a per-block call with the carry
    for m in range(1, M):
        xb = np.concatenate([blocks[m - 1][-c_rows:], blocks[m]], axis=0)
        ref = pipe.interleaved(jnp.asarray(xb))
        np.testing.assert_allclose(
            angs[m], np.asarray(ref.peak_angles["music"]), atol=1e-4)
    # block 0 beyond the zero-prefix windows: padded window j covers
    # stream samples starting at j*hop - C, i.e. plain window j-1
    n_pre = pipe.scan_capture.prefix_windows
    ref0 = pipe.interleaved(jnp.asarray(blocks[0]))
    r0 = np.asarray(ref0.peak_angles["music"])
    n_cmp = angs.shape[1] - n_pre
    np.testing.assert_allclose(angs[0, n_pre:], r0[:n_cmp], atol=1e-4)
