"""DFT beamspace preprocessing: invariants, estimator parity, pipelines.

Conventions: B is orthonormal columns of the unitary DFT (BᴴB = I, so
beamspace noise stays white) and beamspace steering is unit-normalized
(the guard against out-of-sector fake peaks) — see ops/beamspace.py."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import golden
from doa_tpu.configs import (ArrayGeometry, BeamspaceSpec, DoaConfig,
                             Estimator, GridSpec1D)


def _x(thetas, n=16, T=32768, snr=10, seed=3):
    return golden.synthetic_ula_iq(thetas, n, 0.5, T, snr_db=snr,
                                   seed=seed).astype(np.complex64)


def test_beam_matrix_orthonormal_and_sector():
    from doa_tpu.ops.beamspace import dft_beam_matrix

    Bm = dft_beam_matrix(16, 6, 90.0, 0.5)
    assert Bm.shape == (16, 6)
    np.testing.assert_allclose(Bm.conj().T @ Bm, np.eye(6), atol=1e-6)
    # beams cover broadside: the beamspace response at 90° keeps most of
    # its element-space energy, at 20° (far out of sector) almost none
    a90 = golden.ula_steering(np.array([90.0]), 16, 0.5)[0]
    a20 = golden.ula_steering(np.array([20.0]), 16, 0.5)[0]
    assert np.linalg.norm(Bm.conj().T @ a90) > 0.9 * np.linalg.norm(a90)
    assert np.linalg.norm(Bm.conj().T @ a20) < 0.3 * np.linalg.norm(a20)


def test_beamspace_music_matches_element_music():
    """In-sector sources: beamspace MUSIC peaks == element MUSIC peaks."""
    from doa_tpu.ops.beamspace import (beamspace_covariance,
                                       beamspace_steering,
                                       dft_beam_matrix)
    from doa_tpu.ops.music import music_spectrum
    from doa_tpu.ops.peaks import find_local_max

    x = _x([80.0, 100.0])
    R = golden.sample_covariance(golden.frame_samples(x, 1024, 0))
    grid = np.linspace(40.0, 140.0, 401)
    A = golden.ula_steering(grid, 16, 0.5).astype(np.complex64)
    Bm = dft_beam_matrix(16, 8, 90.0, 0.5)
    Rb = np.asarray(beamspace_covariance(
        jnp.asarray(R.astype(np.complex64)), Bm))
    Ab = beamspace_steering(A, Bm)
    P_b = music_spectrum(jnp.asarray(Rb), jnp.asarray(Ab), 2)
    P_e = music_spectrum(jnp.asarray(R.astype(np.complex64)),
                         jnp.asarray(A), 2)
    _, l_b = find_local_max(P_b, 2, 40.0, 140.0)
    _, l_e = find_local_max(P_e, 2, 40.0, 140.0)
    np.testing.assert_allclose(np.sort(np.asarray(l_b), -1).mean(0),
                               np.sort(np.asarray(l_e), -1).mean(0),
                               atol=0.3)
    np.testing.assert_allclose(np.sort(np.asarray(l_b), -1).mean(0),
                               [80.0, 100.0], atol=0.3)


@pytest.mark.parametrize("subspace_method", ["power", "eigh"])
def test_beamspace_tpu_pipeline(subspace_method):
    """build_pipeline_tpu with beamspace: MUSIC + Capon peaks, both
    subspace methods; the fused element-space cov path stays usable."""
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024, num_sources=2,
        estimators=(Estimator.MUSIC, Estimator.CAPON),
        grid=GridSpec1D(num_points=512, lo_deg=40.0, hi_deg=140.0),
        num_max_vals=2,
        beamspace=BeamspaceSpec(num_beams=8, center_deg=90.0),
        subspace_method=subspace_method)
    res = build_pipeline_tpu(cfg)(_x([80.0, 100.0]))
    for est in ("music", "capon"):
        got = np.sort(np.asarray(res.peak_angles[est]), -1).mean(0)
        np.testing.assert_allclose(got, [80.0, 100.0], atol=0.4,
                                   err_msg=est)
    # spectra come out in the beamspace dimension-reduced scan but over
    # the SAME angle grid
    assert res.spectra["music"].shape[-1] == 512


def test_beamspace_complex_pipeline_parity():
    from doa_tpu.pipeline import build_pipeline
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=512, lo_deg=40.0, hi_deg=140.0),
        num_max_vals=2,
        beamspace=BeamspaceSpec(num_beams=8, center_deg=90.0))
    x = _x([80.0, 100.0])
    a_c = np.sort(np.asarray(
        build_pipeline(cfg)(x).peak_angles["music"]), -1)
    a_t = np.sort(np.asarray(
        build_pipeline_tpu(cfg)(x).peak_angles["music"]), -1)
    np.testing.assert_allclose(a_c.mean(0), a_t.mean(0), atol=0.1)


def test_beamspace_no_out_of_sector_fake_peaks():
    """Unit-norm beamspace steering: an empty sector scan must not fake
    a peak at out-of-sector angles even though ‖Bᴴa‖ ≈ 0 there."""
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=721),       # FULL 0-180 grid
        num_max_vals=2,
        beamspace=BeamspaceSpec(num_beams=8, center_deg=90.0))
    res = build_pipeline_tpu(cfg)(_x([80.0, 100.0]))
    got = np.sort(np.asarray(res.peak_angles["music"]), -1).mean(0)
    np.testing.assert_allclose(got, [80.0, 100.0], atol=0.4)


def test_beamspace_config_validation():
    geo = ArrayGeometry(kind="ula", num_elements=16, norm_spacing=0.5)
    base = dict(geometry=geo, snapshot_size=256, num_sources=2,
                grid=GridSpec1D(num_points=256))
    with pytest.raises(ValueError, match="element-space"):
        DoaConfig(estimators=(Estimator.ESPRIT,),
                  beamspace=BeamspaceSpec(num_beams=8), **base)
    with pytest.raises(ValueError, match="num_beams"):
        DoaConfig(beamspace=BeamspaceSpec(num_beams=2), num_sources=2,
                  **{k: v for k, v in base.items()
                     if k != "num_sources"})
    with pytest.raises(ValueError, match="dense"):
        DoaConfig(beamspace=BeamspaceSpec(num_beams=8),
                  scan_mode="hierarchical", **base)
    with pytest.raises(ValueError, match="ULA"):
        DoaConfig(geometry=ArrayGeometry(kind="ura", num_elements=16,
                                         shape=(4, 4),
                                         norm_spacing=0.5),
                  beamspace=BeamspaceSpec(num_beams=8),
                  **{k: v for k, v in base.items() if k != "geometry"})
