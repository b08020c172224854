"""Config 5 capabilities: 2-D az/el MUSIC on a planar array, and wideband
per-subband channelization + incoherent fusion."""

import dataclasses

import numpy as np
import jax.numpy as jnp

import golden
from doa_tpu import PRESETS
from doa_tpu.configs import (
    ArrayGeometry, DoaConfig, Estimator, GridSpec2D, WidebandSpec)
from doa_tpu.cpx import Cpx
from doa_tpu.io import SourceSpec, synth_ura_iq
from doa_tpu.io.synthetic import synth_wideband_ula_iq
from doa_tpu.ops.peaks import find_local_max_2d
from doa_tpu.pipeline_tpu import build_pipeline_tpu


def test_find_local_max_2d_synthetic():
    B, Ga, Ge = 3, 40, 30
    P = np.zeros((B, Ga, Ge), np.float32) + 0.01
    peaks = [(10, 5, 1.0), (25, 20, 0.8)]
    for (ia, ie, v) in peaks:
        P[:, ia, ie] = v
        P[:, ia - 1, ie] = v * 0.5
        P[:, ia + 1, ie] = v * 0.5
        P[:, ia, ie - 1] = v * 0.5
        P[:, ia, ie + 1] = v * 0.5
    vals, az, el = find_local_max_2d(
        jnp.asarray(P), 2, (0.0, 39.0), (0.0, 29.0))
    np.testing.assert_allclose(np.asarray(vals)[:, 0], 1.0)
    np.testing.assert_allclose(np.asarray(az)[:, 0], 10.0)
    np.testing.assert_allclose(np.asarray(el)[:, 0], 5.0)
    np.testing.assert_allclose(np.asarray(az)[:, 1], 25.0)
    np.testing.assert_allclose(np.asarray(el)[:, 1], 20.0)


def test_2d_music_planar_two_sources():
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=64, norm_spacing=0.5,
                               shape=(8, 8)),
        snapshot_size=512,
        num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid2d=GridSpec2D(num_az=91, num_el=46),
        num_max_vals=2,
    )
    truth = [(-30.0, 20.0), (40.0, 55.0)]  # (az, el)
    x = synth_ura_iq(
        [SourceSpec(az_deg=truth[0][0], el_deg=truth[0][1], freq_norm=0.1),
         SourceSpec(az_deg=truth[1][0], el_deg=truth[1][1], freq_norm=0.3)],
        (8, 8), 0.5, 8 * 512, snr_db=10, seed=0)
    res = build_pipeline_tpu(cfg)(x)
    ang = np.asarray(res.peak_angles["music"])  # (B, 2, 2) az/el
    assert ang.shape[-1] == 2
    # match each detection to nearest truth
    for b in range(ang.shape[0]):
        for k in range(2):
            d = min(np.hypot(ang[b, k, 0] - t[0], ang[b, k, 1] - t[1])
                    for t in truth)
            assert d < 3.0, (b, k, ang[b])


def test_wideband_channelizer_parity_with_fft():
    from doa_tpu.ops.wideband import channelize_cpx, dft_matrix

    rng = np.random.default_rng(0)
    T, N, F = 256, 4, 16
    x = (rng.standard_normal((T, N)) + 1j * rng.standard_normal((T, N))
         ).astype(np.complex64)
    W = dft_matrix(F)
    out = channelize_cpx(Cpx.from_complex(x), Cpx.from_complex(W))
    got = out.to_numpy()  # (F, T//F, N)
    want = np.fft.fft(x.reshape(T // F, F, N), axis=1)  # (T//F, F, N)
    np.testing.assert_allclose(got, np.moveaxis(want, 1, 0), rtol=1e-3,
                               atol=1e-4)


def test_wideband_fusion_resolves_sources():
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024,
        num_sources=2,
        estimators=(Estimator.MUSIC,),
        wideband=WidebandSpec(num_subbands=16, fractional_bw=0.4),
        num_max_vals=2,
    )
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=65.0, freq_norm=0.0, bandwidth_norm=0.5),
         SourceSpec(theta_deg=115.0, freq_norm=0.0, bandwidth_norm=0.5)],
        16, 0.5, 16 * 1024, fractional_bw=0.4, snr_db=10, seed=1)
    res = build_pipeline_tpu(cfg)(x)
    locs = np.sort(np.asarray(res.peak_angles["music"]), axis=-1)
    med = np.median(locs, axis=0)
    assert abs(med[0] - 65.0) < 2.0, med
    assert abs(med[1] - 115.0) < 2.0, med


def test_config5_preset_end_to_end():
    cfg = PRESETS["c5_ura64_wideband"]
    # smaller grid for test speed
    cfg = dataclasses.replace(
        cfg, grid2d=GridSpec2D(num_az=61, num_el=31),
        snapshot_size=512,
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1))
    truth = [(-20.0, 30.0), (35.0, 60.0)]
    # PHYSICAL wideband model: every FFT bin steered at its own
    # effective spacing — the model the subband channelizer inverts.
    from doa_tpu.io.synthetic import synth_wideband_ura_iq
    x = synth_wideband_ura_iq(
        [SourceSpec(az_deg=truth[0][0], el_deg=truth[0][1], freq_norm=0.05,
                    bandwidth_norm=0.2),
         SourceSpec(az_deg=truth[1][0], el_deg=truth[1][1], freq_norm=0.25,
                    bandwidth_norm=0.2)],
        (8, 8), 0.5, 16 * 512, fractional_bw=cfg.wideband.fractional_bw,
        snr_db=10, seed=2)
    res = build_pipeline_tpu(cfg)(x)
    ang = np.asarray(res.peak_angles["music"])       # (B, k, 2)
    # peak ORDER alternates between windows: pair-sort by azimuth
    # before aggregating (plain mean over windows averages mismatched
    # pairs into midpoint garbage)
    order = np.argsort(ang[..., 0], axis=-1)
    ang = np.take_along_axis(ang, order[..., None], 1)
    med = np.median(ang, axis=0)  # (2, 2) sorted by az: [-20, 35]
    for k in range(2):
        d = np.hypot(med[k, 0] - truth[k][0], med[k, 1] - truth[k][1])
        assert d < 2.0, med


def test_pipeline_complex_path_ura_peaks_in_degrees():
    """ADVICE r1: the complex/CPU path must report (az, el) DEGREES for
    ura configs — same units as pipeline_tpu, never flat bin indices."""
    from doa_tpu.pipeline import build_pipeline

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=16, norm_spacing=0.5,
                               shape=(4, 4)),
        snapshot_size=256,
        num_sources=1,
        estimators=(Estimator.MUSIC,),
        grid2d=GridSpec2D(num_az=61, num_el=31),
        num_max_vals=1,
    )
    truth = (-20.0, 40.0)
    x = synth_ura_iq([SourceSpec(az_deg=truth[0], el_deg=truth[1],
                                 freq_norm=0.2)],
                     (4, 4), 0.5, 4 * 256, snr_db=15, seed=3)
    res = build_pipeline(cfg)(x)
    ang = np.asarray(res.peak_angles["music"])
    assert ang.shape[-1] == 2  # (az, el) pairs
    assert np.all(np.abs(ang[..., 0] - truth[0]) < 4.0)
    assert np.all(np.abs(ang[..., 1] - truth[1]) < 4.0)
    # exact same units as the split-complex path
    res_t = build_pipeline_tpu(cfg)(x)
    ang_t = np.asarray(res_t.peak_angles["music"])
    np.testing.assert_allclose(ang, ang_t, atol=0.2)


def test_wideband_steering_scale_matches_stack_model():
    """ADVICE r1: the exported helper must agree with the d·(1+f·fbw)
    model used by wideband_steering_stack / the wideband synth."""
    from doa_tpu.ops.steering import wideband_steering_scale
    from doa_tpu.ops.wideband import subband_center_freqs

    fbw = 0.1
    d = 0.5
    freqs = subband_center_freqs(8)
    got = np.asarray(wideband_steering_scale(d, freqs, fbw))
    np.testing.assert_allclose(got, d * (1.0 + freqs * fbw), rtol=1e-6)
