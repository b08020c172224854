"""The split-complex production pipeline must match the complex one."""

import numpy as np
import pytest

from doa_tpu import PRESETS
from doa_tpu.configs import DoaConfig, Estimator
from doa_tpu.io import SourceSpec, synth_ula_iq
from doa_tpu.pipeline import build_pipeline
from doa_tpu.pipeline_tpu import build_pipeline_tpu
import dataclasses


def test_tpu_path_matches_complex_path():
    # subspace_method="eigh" for exact spectral parity with the complex
    # reference path; the default "power" path has its own parity tests
    # (test_power_subspace.py) at peak-angle tolerance.
    cfg = PRESETS["c2_ula8_2src"]
    cfg = dataclasses.replace(
        cfg, estimators=(Estimator.MUSIC, Estimator.CAPON,
                         Estimator.ROOT_MUSIC),
        subspace_method="eigh")
    x = synth_ula_iq(
        [SourceSpec(theta_deg=60.0, freq_norm=0.1),
         SourceSpec(theta_deg=110.0, freq_norm=0.31)],
        8, 0.5, 8 * 2048, snr_db=10, seed=1)
    ref = build_pipeline(cfg)(x)
    got = build_pipeline_tpu(cfg)(x)
    for est in ("music", "capon"):
        np.testing.assert_allclose(
            np.asarray(got.spectra[est]), np.asarray(ref.spectra[est]),
            rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(
            np.asarray(got.peak_angles[est]),
            np.asarray(ref.peak_angles[est]), atol=0.05)
    np.testing.assert_allclose(
        np.asarray(got.root_music_angles),
        np.asarray(ref.root_music_angles), atol=0.05)


def test_tpu_path_bartlett():
    # Regression: BARTLETT used to fall through the split pipeline's
    # estimator dispatch silently (no spectrum, no peaks). It must
    # produce output on BOTH paths and match the complex reference,
    # including through the interleaved fast path (need_R plumbing).
    cfg = PRESETS["c2_ula8_2src"]
    cfg = dataclasses.replace(
        cfg, estimators=(Estimator.MUSIC, Estimator.BARTLETT),
        subspace_method="eigh")
    x = synth_ula_iq(
        [SourceSpec(theta_deg=60.0, freq_norm=0.1),
         SourceSpec(theta_deg=110.0, freq_norm=0.31)],
        8, 0.5, 8 * 2048, snr_db=10, seed=1)
    ref = build_pipeline(cfg)(x)
    got = build_pipeline_tpu(cfg)(x)
    assert "bartlett" in got.spectra and "bartlett" in got.peak_angles
    np.testing.assert_allclose(
        np.asarray(got.spectra["bartlett"]),
        np.asarray(ref.spectra["bartlett"]), rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(
        np.asarray(got.peak_angles["bartlett"]),
        np.asarray(ref.peak_angles["bartlett"]), atol=0.05)
    # interleaved fast path (power subspace): BARTLETT needs R
    fast_pipe = build_pipeline_tpu(dataclasses.replace(
        cfg, subspace_method="power"))
    assert fast_pipe.fast_path
    fast = fast_pipe(x.astype(np.complex64))
    assert "bartlett" in fast.peak_angles
    np.testing.assert_allclose(
        np.asarray(fast.peak_angles["bartlett"]),
        np.asarray(ref.peak_angles["bartlett"]), atol=0.1)


def test_tpu_path_overlap_and_smoothing():
    cfg = PRESETS["c3_ula16_calib_smooth"]
    cfg = dataclasses.replace(cfg, overlap=512, subspace_method="eigh")
    x = synth_ula_iq(
        [SourceSpec(theta_deg=70.0, freq_norm=0.1),
         SourceSpec(theta_deg=100.0, freq_norm=0.1),
         SourceSpec(theta_deg=40.0, freq_norm=0.33)],
        16, 0.5, 16 * 1024, snr_db=15, seed=2,
        correlated_pairs=[(0, 1)])
    ref = build_pipeline(cfg)(x)
    got = build_pipeline_tpu(cfg)(x)
    np.testing.assert_allclose(
        np.asarray(got.peak_angles["music"]),
        np.asarray(ref.peak_angles["music"]), atol=0.1)


def test_tpu_path_correction_vector():
    cfg = PRESETS["c1_ula4_tone"]
    rng = np.random.default_rng(7)
    imp = (1.0 + 0.2 * rng.standard_normal(4)) * np.exp(
        1j * rng.uniform(-0.5, 0.5, 4))
    x = synth_ula_iq([SourceSpec(theta_deg=64.0)], 4, 0.5, 32 * 256,
                     snr_db=15, seed=5,
                     channel_gains=np.abs(imp),
                     channel_phases=np.angle(imp))
    corr = (1.0 / imp).astype(np.complex64)
    ref = build_pipeline(cfg)(x, correction=corr)
    got = build_pipeline_tpu(cfg)(x, correction=corr)
    np.testing.assert_allclose(
        np.asarray(got.peak_angles["music"]),
        np.asarray(ref.peak_angles["music"]), atol=0.05)


def test_tpu_path_pallas_production_modes():
    """The interleaved ingest route (zero-copy complex64 view) must
    match the planes route at peak level, spectra above the null
    floor."""
    from doa_tpu.cpx import Cpx
    cfg = PRESETS["c2_ula8_2src"]
    x = synth_ula_iq(
        [SourceSpec(theta_deg=60.0, freq_norm=0.1),
         SourceSpec(theta_deg=110.0, freq_norm=0.31)],
        8, 0.5, 8 * 2048, snr_db=10, seed=1).astype(np.complex64)
    pipe = build_pipeline_tpu(cfg)
    assert pipe.fast_path
    base = pipe(Cpx.from_complex(x))
    ilv = pipe(x)
    np.testing.assert_allclose(
        np.asarray(ilv.peak_angles["music"]),
        np.asarray(base.peak_angles["music"]), atol=0.05)
    # Null-floor values (~1e-5 of the normalized peak) differ a few %
    # between the two f32 summation orders; peaks above.
    np.testing.assert_allclose(
        np.asarray(ilv.spectra["music"]),
        np.asarray(base.spectra["music"]), rtol=5e-2, atol=5e-4)


def test_tpu_path_pallas_cov_overlap_bf16():
    """bf16 Gram operands with sliding windows on the interleaved path:
    angles within grid tolerance of the f32 path."""
    cfg = dataclasses.replace(
        PRESETS["c4_ula16_streaming"], cov_dtype="bfloat16")
    x = synth_ula_iq(
        [SourceSpec(theta_deg=75.0, freq_norm=0.12),
         SourceSpec(theta_deg=120.0, freq_norm=0.3)],
        16, 0.5, 16 * 1024, snr_db=10, seed=3).astype(np.complex64)
    ref = build_pipeline_tpu(PRESETS["c4_ula16_streaming"])(x)
    pipe = build_pipeline_tpu(cfg)
    assert pipe.fast_path
    bf = pipe(x)
    np.testing.assert_allclose(
        np.asarray(bf.peak_angles["music"]),
        np.asarray(ref.peak_angles["music"]), atol=0.3)


def test_pallas_scan_requires_power():
    """The interleaved entry needs the power subspace: an eigh config
    has no interleaved path and says so."""
    pipe = build_pipeline_tpu(dataclasses.replace(
        PRESETS["c1_ula4_tone"], subspace_method="eigh"))
    assert not pipe.fast_path
    with pytest.raises(ValueError):
        pipe.interleaved(np.zeros((64, 128), np.float32))
