"""Parity: real-valued (split re/im) path vs the jnp-complex reference
ops. This is the correctness gate for the split-complex production
path."""

import numpy as np
import jax.numpy as jnp
import pytest

import golden
from doa_tpu import ops
from doa_tpu.cpx import Cpx, matmul, einsum, expj
from doa_tpu.ops import cpx_ops


def _iq(thetas, n, T, snr=10, seed=3, **kw):
    return golden.synthetic_ula_iq(thetas, n, 0.5, T, snr_db=snr, seed=seed,
                                   **kw)


def test_cpx_matmul_gauss():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((5, 7)) + 1j * rng.standard_normal((5, 7))
         ).astype(np.complex64)
    b = (rng.standard_normal((7, 3)) + 1j * rng.standard_normal((7, 3))
         ).astype(np.complex64)
    for gauss in (True, False):
        c = matmul(Cpx.from_complex(a), Cpx.from_complex(b), gauss=gauss)
        np.testing.assert_allclose(c.to_numpy(), a @ b, rtol=1e-4,
                                   atol=1e-5)


def test_cpx_arith():
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(10) + 1j * rng.standard_normal(10)).astype(
        np.complex64)
    b = (rng.standard_normal(10) + 1j * rng.standard_normal(10)).astype(
        np.complex64)
    ca, cb = Cpx.from_complex(a), Cpx.from_complex(b)
    np.testing.assert_allclose((ca * cb).to_numpy(), a * b, rtol=1e-5)
    np.testing.assert_allclose((ca / cb).to_numpy(), a / b, rtol=1e-4)
    np.testing.assert_allclose((ca + cb).to_numpy(), a + b, rtol=1e-5)
    np.testing.assert_allclose(ca.conj().to_numpy(), a.conj(), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ca.abs2()), np.abs(a) ** 2,
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(expj(jnp.asarray([0.5])).to_numpy()),
                               np.exp(0.5j), rtol=1e-6)


@pytest.mark.parametrize("fb", [False, True])
def test_cov_cpx_parity(fb):
    x = _iq([70.0, 120.0], 8, 8192)
    f = golden.frame_samples(x, 512, 0)
    R_ref = golden.sample_covariance(f, fb_average=fb)
    R_cpx = cpx_ops.sample_covariance_cpx(Cpx.from_complex(f),
                                          fb_average=fb)
    np.testing.assert_allclose(R_cpx.to_numpy(), R_ref, rtol=3e-4,
                               atol=2e-5)


@pytest.mark.parametrize("S,O", [(512, 0), (512, 256), (256, 100),
                                 (512, 500)])
def test_cov_from_stream_cpx_parity(S, O):
    x = _iq([70.0], 8, 8192)
    R_ref = golden.sample_covariance(golden.frame_samples(x, S, O))
    R_cpx = cpx_ops.cov_from_stream_cpx(Cpx.from_complex(x), S, O)
    np.testing.assert_allclose(R_cpx.to_numpy(), R_ref, rtol=3e-4,
                               atol=2e-5)


def test_spatial_smooth_cpx_parity():
    x = _iq([70.0, 100.0], 16, 8192)
    R = golden.sample_covariance(golden.frame_samples(x, 512, 0))
    s_ref = golden.spatial_smooth(R, 12)
    s_cpx = cpx_ops.spatial_smooth_cpx(Cpx.from_complex(R), 12)
    np.testing.assert_allclose(s_cpx.to_numpy(), s_ref, rtol=2e-4,
                               atol=1e-5)


def test_noise_projector_cpx_parity():
    x = _iq([60.0, 110.0], 8, 16384)
    R = golden.sample_covariance(golden.frame_samples(x, 2048, 0))
    M_ref = np.asarray(ops.noise_projector(jnp.asarray(R), 2))
    M_cpx = cpx_ops.noise_projector_cpx(Cpx.from_complex(R), 2)
    np.testing.assert_allclose(M_cpx.to_numpy(), M_ref, rtol=2e-3,
                               atol=2e-4)


def test_principal_eigvec_cpx_projector_parity():
    # eigenvectors have phase ambiguity: compare rank-1 projectors.
    x = _iq([75.0], 8, 8192, snr=25)
    R = golden.sample_covariance(golden.frame_samples(x, 1024, 0))
    from doa_tpu.ops.subspace import principal_eigvec
    v_ref = np.asarray(principal_eigvec(jnp.asarray(R)))
    v_cpx = cpx_ops.principal_eigvec_cpx(Cpx.from_complex(R)).to_numpy()
    P_ref = np.einsum("bi,bj->bij", v_ref, v_ref.conj())
    P_cpx = np.einsum("bi,bj->bij", v_cpx, v_cpx.conj())
    np.testing.assert_allclose(P_cpx, P_ref, rtol=2e-3, atol=2e-4)


def test_music_spectrum_cpx_parity():
    x = _iq([60.0, 110.0], 8, 16384)
    R = golden.sample_covariance(golden.frame_samples(x, 2048, 0))
    grid = np.linspace(0, 180, 721)
    A = golden.ula_steering(grid, 8, 0.5).astype(np.complex64)
    P_ref = golden.music_spectrum(R, A, num_sources=2)
    P_cpx = np.asarray(cpx_ops.music_spectrum_cpx(
        Cpx.from_complex(R), Cpx.from_complex(A), 2))
    np.testing.assert_allclose(P_cpx, P_ref, rtol=5e-3, atol=5e-4)


def test_bartlett_spectrum_cpx_parity():
    x = _iq([60.0, 110.0], 8, 16384)
    R = golden.sample_covariance(golden.frame_samples(x, 2048, 0))
    grid = np.linspace(0, 180, 721)
    A = golden.ula_steering(grid, 8, 0.5).astype(np.complex64)
    P_ref = golden.bartlett_spectrum(R, A)
    P_cpx = np.asarray(cpx_ops.bartlett_spectrum_cpx(
        Cpx.from_complex(R), Cpx.from_complex(A)))
    np.testing.assert_allclose(P_cpx, P_ref, rtol=5e-3, atol=5e-4)


def test_capon_spectrum_cpx_parity():
    x = _iq([60.0, 110.0], 8, 16384)
    R = golden.sample_covariance(golden.frame_samples(x, 2048, 0))
    grid = np.linspace(0, 180, 721)
    A = golden.ula_steering(grid, 8, 0.5).astype(np.complex64)
    P_ref = golden.capon_spectrum(R, A, diag_load=1e-4)
    P_cpx = np.asarray(cpx_ops.capon_spectrum_cpx(
        Cpx.from_complex(R), Cpx.from_complex(A), diag_load=1e-4))
    np.testing.assert_allclose(P_cpx, P_ref, rtol=5e-3, atol=5e-4)
