"""TOPS wideband fusion (ops/tops.py) — focusing-free coherent DoA.

Fourth wideband fusion mode (incoherent | cssm | cssm_auto | tops). No upstream
equivalent (gr-doa is narrowband-only, SURVEY §0); the golden reference
is the textbook matrix formulation in golden.tops_spectrum.
"""

import dataclasses

import numpy as np
import pytest

import golden
from doa_tpu.configs import (
    ArrayGeometry, DoaConfig, Estimator, GridSpec1D, GridSpec2D,
    WidebandSpec)
from doa_tpu.cpx import Cpx
from doa_tpu.io import SourceSpec
from doa_tpu.io.synthetic import synth_wideband_ula_iq, synth_wideband_ura_iq
from doa_tpu.ops.tops import tops_spectrum_cpx, wideband_tops_cpx
from doa_tpu.ops.wideband import dft_matrix, wideband_steering_stack
from doa_tpu.pipeline_tpu import build_pipeline_tpu


def _cfg(**over):
    base = dict(
        geometry=ArrayGeometry(kind="ula", num_elements=8,
                               norm_spacing=0.5),
        snapshot_size=512,
        num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=181),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.4,
                              fusion="tops"),
        num_max_vals=2,
    )
    base.update(over)
    return DoaConfig(**base)


def _subband_setup(cfg, x):
    """numpy channelize + per-band covariances + steering stack."""
    from doa_tpu.ops.steering import _ula_steering_np, grid_angles_1d
    F = cfg.wideband.num_subbands
    N = cfg.geometry.num_elements
    W = dft_matrix(F)
    M = x.shape[0] // F
    xf = x[: M * F].reshape(M, F, N)
    xs = np.einsum("ft,mtn->fmn", W, xf)
    S_sub = cfg.snapshot_size // F
    R_sub = np.stack([
        golden.sample_covariance(golden.frame_samples(xs[f], S_sub, 0))
        for f in range(F)])                          # (F, B, N, N)
    theta = grid_angles_1d(cfg.grid)
    A_fn = lambda d: _ula_steering_np(theta, N, d)   # noqa: E731
    A_stack = wideband_steering_stack(cfg, A_fn)     # (F, G, N)
    return R_sub, A_stack


def _scene(cfg, T, snr_db=10, seed=0, thetas=(60.0, 120.0)):
    return synth_wideband_ula_iq(
        [SourceSpec(theta_deg=t, freq_norm=0.0, bandwidth_norm=0.5)
         for t in thetas],
        cfg.geometry.num_elements, cfg.geometry.norm_spacing, T,
        fractional_bw=cfg.wideband.fractional_bw, snr_db=snr_db,
        seed=seed)


def test_tops_spectrum_matches_golden():
    """Device scan/einsum algebra == the paper's matrix formulation,
    given identical subspaces (numpy eigh, fed to both sides)."""
    cfg = _cfg(snapshot_size=256, num_max_vals=2)
    x = _scene(cfg, 4 * 256, snr_db=10, seed=3)
    R_sub, A_stack = _subband_setup(cfg, x)
    F, B, N, _ = R_sub.shape
    K = cfg.num_sources

    want = golden.tops_spectrum(R_sub, A_stack, K, ref_band=0)

    _, v = np.linalg.eigh(R_sub)
    S = v[..., :, N - K:].astype(np.complex64)        # (F, B, N, K)
    got = np.asarray(tops_spectrum_cpx(
        Cpx.from_complex(S), Cpx.from_complex(A_stack), ref_band=0))

    assert got.shape == want.shape == (B, cfg.grid.num_points)
    # identical argmax structure and close values (f32 vs f64; the
    # deep-null bins are cancellation-prone by construction)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-3)


def test_tops_esub_path_matches_stream_path():
    """The pipeline's interleaved-ingest entry (deinterleaved on the
    device) and the stream entry compute the same spectrum."""
    cfg = _cfg(snapshot_size=256)
    x = _scene(cfg, 4 * 256, seed=4)
    from doa_tpu.ops.steering import _ula_steering_np, grid_angles_1d
    theta = grid_angles_1d(cfg.grid)
    A_fn = lambda d: _ula_steering_np(  # noqa: E731
        theta, cfg.geometry.num_elements, d)
    A_stack = Cpx.from_complex(wideband_steering_stack(cfg, A_fn))
    W = Cpx.from_complex(dft_matrix(cfg.wideband.num_subbands))
    xc = Cpx.from_complex(x)

    from doa_tpu.ops.interleaved import deinterleave, to_interleaved
    P_stream = np.asarray(wideband_tops_cpx(xc, A_stack, W, cfg))
    xd = deinterleave(to_interleaved(xc.re, xc.im),
                      cfg.geometry.num_elements)
    P_esub = np.asarray(wideband_tops_cpx(xd, A_stack, W, cfg))
    np.testing.assert_allclose(P_esub, P_stream, rtol=1e-4, atol=1e-5)
    pipe = build_pipeline_tpu(cfg)
    assert pipe.wb_fast
    res = pipe(x.astype(np.complex64))
    np.testing.assert_allclose(np.asarray(res.spectra["tops"]),
                               np.asarray(pipe(xc).spectra["tops"]),
                               rtol=1e-4, atol=1e-5)


def test_tops_resolves_wideband_sources_e2e():
    cfg = _cfg()
    x = _scene(cfg, 16 * 512, snr_db=10, seed=1)
    res = build_pipeline_tpu(cfg)(x)
    assert "tops" in res.peak_angles
    locs = np.sort(np.asarray(res.peak_angles["tops"]), axis=-1)
    med = np.median(locs, axis=0)
    assert abs(med[0] - 60.0) < 2.0, med
    assert abs(med[1] - 120.0) < 2.0, med


def test_tops_ref_band_choice():
    """A non-default reference subband still resolves the scene (the
    transform is relative — any SIGNAL-BEARING band can anchor it;
    bandwidth_norm=0.5 sources occupy |f| <= 0.25, so bin 1 at 0.125
    qualifies while bin 3 at 0.375 is noise-only and would not — the
    config docstring's operating constraint)."""
    cfg = _cfg(wideband=WidebandSpec(num_subbands=8, fractional_bw=0.4,
                                     fusion="tops", tops_ref_band=1))
    x = _scene(cfg, 16 * 512, snr_db=10, seed=2)
    res = build_pipeline_tpu(cfg)(x)
    med = np.median(np.sort(np.asarray(res.peak_angles["tops"]), -1), 0)
    assert abs(med[0] - 60.0) < 2.0 and abs(med[1] - 120.0) < 2.0, med


def test_tops_2d_planar_wideband():
    """The diagonal manifold transform is geometry-agnostic: TOPS on a
    URA with a 2-D az/el grid."""
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=16, shape=(4, 4),
                               norm_spacing=0.5),
        snapshot_size=256, num_sources=1,
        estimators=(Estimator.MUSIC,),
        grid2d=GridSpec2D(num_az=31, num_el=16),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.3,
                              fusion="tops"),
        num_max_vals=1)
    x = synth_wideband_ura_iq(
        [SourceSpec(theta_deg=0.0, az_deg=40.0, el_deg=30.0,
                    freq_norm=0.0, bandwidth_norm=0.5)],
        (4, 4), 0.5, 16 * 256, fractional_bw=0.3, snr_db=10, seed=5)
    res = build_pipeline_tpu(cfg)(x)
    azel = np.median(np.asarray(res.peak_angles["tops"]), axis=0)[0]
    assert abs(azel[0] - 40.0) < 6.0, azel
    assert abs(azel[1] - 30.0) < 6.0, azel


def test_tops_config_validation():
    with pytest.raises(ValueError, match="tops_ref_band"):
        _cfg(wideband=WidebandSpec(num_subbands=8, fractional_bw=0.4,
                                   fusion="tops", tops_ref_band=8))
    with pytest.raises(ValueError, match="hierarchical"):
        _cfg(scan_mode="hierarchical")
    with pytest.raises(ValueError, match="fusion"):
        _cfg(wideband=WidebandSpec(num_subbands=8, fusion="nope"))


def test_tops_guard_suppresses_transform_degeneracy_ridge():
    """TOPS's canonical false peak: at broadside (cos θ = 0) the
    manifold transform is the identity for every band, and the
    finite-sample cross-band consistency dip can outrank a true-angle
    null (measured ~25% of windows at fbw 0.4 / 10 dB pre-guard). The
    incoherent-MUSIC guard (WidebandSpec.tops_guard, default ON) must
    kill the 90° ridge on the scenario that exposed it, and the
    ungated spectrum must still show it (pinning WHY the guard
    exists)."""
    cfg = _cfg(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024, grid=GridSpec1D(num_points=361))
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=60.0, freq_norm=0.0, bandwidth_norm=0.5),
         SourceSpec(theta_deg=120.0, freq_norm=0.0, bandwidth_norm=0.5)],
        16, 0.5, 16 * 1024, fractional_bw=0.4, snr_db=10, seed=3)
    res = build_pipeline_tpu(cfg)(x)
    ang = np.sort(np.asarray(res.peak_angles["tops"]), -1)
    err = np.abs(ang - [60.0, 120.0]).max(-1)
    assert np.median(err) < 1.0, (np.median(err), err.max())

    cfg_off = _cfg(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024, grid=GridSpec1D(num_points=361),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.4,
                              fusion="tops", tops_guard=False))
    P_off = np.asarray(build_pipeline_tpu(cfg_off)(x).spectra["tops"])
    P_on = np.asarray(res.spectra["tops"])
    # the ungated ridge at 90 deg (bin 180 of 361 over [0, 180]) sits
    # near the global max; the guard must push it clearly below the
    # true peaks (measured 0.9996 -> 0.354 on this scenario)
    assert np.median(P_off[:, 180]) > 0.9, np.median(P_off[:, 180])
    assert np.median(P_on[:, 180]) < 0.6, np.median(P_on[:, 180])
