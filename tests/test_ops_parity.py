"""Parity: doa_tpu ops vs the golden numpy reference (the analog of the
reference's qa_* golden-vector tests, SURVEY §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

import golden
from doa_tpu import ops


def _iq(thetas, n, T, snr=10, seed=3, **kw):
    return golden.synthetic_ula_iq(thetas, n, 0.5, T, snr_db=snr, seed=seed,
                                   **kw)


def test_steering_matches_golden():
    theta = np.linspace(0, 180, 181)
    a_j = np.asarray(ops.ula_steering(theta, 8, 0.5))
    a_g = golden.ula_steering(theta, 8, 0.5)
    np.testing.assert_allclose(a_j, a_g, atol=1e-5)


def test_ura_steering_matches_golden():
    az = np.linspace(-90, 90, 37)
    el = np.linspace(0, 90, 19)
    azg, elg = np.meshgrid(az, el, indexing="ij")
    a_j = np.asarray(ops.ura_steering(
        jnp.asarray(azg.ravel()), jnp.asarray(elg.ravel()), (4, 4), 0.5))
    a_g = golden.ura_steering(azg.ravel(), elg.ravel(), (4, 4), 0.5)
    np.testing.assert_allclose(a_j, a_g, atol=1e-5)


def test_framing_matches_golden():
    x = _iq([70.0], 4, 5000)
    for S, O in [(256, 0), (256, 128), (100, 37)]:
        f_j = np.asarray(ops.frame_samples(jnp.asarray(x), S, O))
        f_g = golden.frame_samples(x, S, O)
        assert f_j.shape == f_g.shape
        np.testing.assert_array_equal(f_j, f_g)


@pytest.mark.parametrize("fb", [False, True])
def test_covariance_matches_golden(fb):
    x = _iq([70.0, 120.0], 8, 8192)
    f = golden.frame_samples(x, 512, 0)
    R_g = golden.sample_covariance(f, fb_average=fb)
    R_j = np.asarray(ops.sample_covariance(jnp.asarray(f), fb_average=fb))
    np.testing.assert_allclose(R_j, R_g, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("S,O", [(512, 0), (512, 256), (512, 384)])
def test_cov_from_stream_matches_framed(S, O):
    from doa_tpu.ops.covariance import cov_from_stream

    x = _iq([70.0], 8, 8192)
    R_g = golden.sample_covariance(golden.frame_samples(x, S, O))
    R_j = np.asarray(cov_from_stream(jnp.asarray(x), S, O))
    assert R_j.shape == R_g.shape
    np.testing.assert_allclose(R_j, R_g, rtol=3e-4, atol=2e-5)


def test_spatial_smooth_matches_golden():
    x = _iq([70.0, 100.0], 16, 8192)
    R = golden.sample_covariance(golden.frame_samples(x, 512, 0))
    s_g = golden.spatial_smooth(R, 12)
    s_j = np.asarray(ops.spatial_smooth(jnp.asarray(R), 12))
    np.testing.assert_allclose(s_j, s_g, rtol=2e-5, atol=1e-6)


def test_music_spectrum_matches_golden():
    x = _iq([60.0, 110.0], 8, 16384)
    R = golden.sample_covariance(golden.frame_samples(x, 2048, 0))
    grid = np.linspace(0, 180, 721)
    A_g = golden.ula_steering(grid, 8, 0.5)
    P_g = golden.music_spectrum(R, A_g, num_sources=2)
    A_j = ops.ula_steering(grid, 8, 0.5)
    P_j = np.asarray(ops.music_spectrum(jnp.asarray(R), A_j, num_sources=2))
    # eigh implementations differ; compare spectra, which are subspace
    # functions (invariant to basis rotation within the subspace).
    np.testing.assert_allclose(P_j, P_g, rtol=2e-3, atol=2e-4)


def test_capon_spectrum_matches_golden():
    x = _iq([60.0, 110.0], 8, 16384)
    R = golden.sample_covariance(golden.frame_samples(x, 2048, 0))
    grid = np.linspace(0, 180, 721)
    A_g = golden.ula_steering(grid, 8, 0.5)
    P_g = golden.capon_spectrum(R, A_g, diag_load=1e-4)
    A_j = ops.ula_steering(grid, 8, 0.5)
    P_j = np.asarray(ops.capon_spectrum(jnp.asarray(R), A_j, diag_load=1e-4))
    np.testing.assert_allclose(P_j, P_g, rtol=2e-3, atol=2e-4)


def test_bartlett_spectrum_matches_golden():
    x = _iq([60.0, 110.0], 8, 16384)
    R = golden.sample_covariance(golden.frame_samples(x, 2048, 0))
    grid = np.linspace(0, 180, 721)
    A_g = golden.ula_steering(grid, 8, 0.5)
    P_g = golden.bartlett_spectrum(R, A_g)
    from doa_tpu.ops.bartlett import bartlett_spectrum
    A_j = ops.ula_steering(grid, 8, 0.5)
    P_j = np.asarray(bartlett_spectrum(jnp.asarray(R), A_j))
    np.testing.assert_allclose(P_j, P_g, rtol=2e-3, atol=2e-4)


def test_root_music_matches_golden():
    x = _iq([60.0, 110.0], 8, 16384, snr=15, seed=7)
    R = golden.sample_covariance(golden.frame_samples(x, 2048, 0))
    t_g = golden.root_music(R, 2, 0.5)
    t_j = np.asarray(ops.root_music(jnp.asarray(R), 2, 0.5))
    np.testing.assert_allclose(t_j, t_g, atol=0.05)


def test_find_local_max_matches_golden():
    rng = np.random.default_rng(0)
    P = rng.random((6, 200)).astype(np.float32)
    # smooth it so there are real peaks
    P = np.apply_along_axis(lambda r: np.convolve(r, np.ones(9) / 9, "same"),
                            -1, P)
    v_g, l_g = golden.find_local_max(P, 3, 0.0, 180.0)
    v_j, l_j = ops.find_local_max(jnp.asarray(P), 3, 0.0, 180.0)
    np.testing.assert_allclose(np.asarray(v_j), v_g, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(l_j), l_g, atol=1e-4)


def test_find_local_max_refine_improves():
    # Peak between grid points: refinement should cut the bias.
    theta_true = 72.31
    x = _iq([theta_true], 8, 32768, snr=20)
    R = golden.sample_covariance(golden.frame_samples(x, 4096, 0))
    grid_pts = 181  # 1-degree grid
    A = ops.ula_steering(np.linspace(0, 180, grid_pts), 8, 0.5)
    P = ops.music_spectrum(jnp.asarray(R), A, num_sources=1)
    _, l_raw = ops.find_local_max(P, 1, 0.0, 180.0, refine=False)
    _, l_ref = ops.find_local_max(P, 1, 0.0, 180.0, refine=True)
    err_raw = np.abs(np.asarray(l_raw) - theta_true).mean()
    err_ref = np.abs(np.asarray(l_ref) - theta_true).mean()
    assert err_ref < err_raw
    assert err_ref < 0.1


def test_streaming_covariance_matches_batch():
    from doa_tpu.ops.covariance import (
        streaming_covariance, init_streaming_carry)

    x = _iq([70.0], 8, 4096)
    S, hop = 512, 256
    carry = init_streaming_carry(8, S, hop)
    Rs = []
    for i in range(x.shape[0] // hop):
        carry, R = streaming_covariance(
            carry, jnp.asarray(x[i * hop:(i + 1) * hop]), S, hop)
        Rs.append(np.asarray(R))
    # After the ring fills (from chunk index S/hop - 1 on), streaming R must
    # equal the batch covariance of the corresponding window.
    R_batch = golden.sample_covariance(golden.frame_samples(x, S, S - hop))
    n_fill = S // hop
    for b in range(R_batch.shape[0]):
        np.testing.assert_allclose(
            Rs[b + n_fill - 1], R_batch[b], rtol=3e-4, atol=2e-5)
