"""Min-Norm (Kumaresan–Tufts) estimator: golden parity + pipeline e2e.

Golden conventions pinned by tests/golden.py::{min_norm_weight,
min_norm_spectrum, root_min_norm}; the op under test is
doa_tpu/ops/min_norm.py on all three paths (complex, subspace-embedded,
complex-projector split planes)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import golden
from doa_tpu.configs import ArrayGeometry, DoaConfig, Estimator, GridSpec1D
from doa_tpu.cpx import Cpx


def _R(thetas, n=8, T=16384, snr=10, seed=3, S=512):
    x = golden.synthetic_ula_iq(thetas, n, 0.5, T, snr_db=snr, seed=seed)
    return golden.sample_covariance(golden.frame_samples(x, S, 0)), x


def test_min_norm_spectrum_matches_golden():
    from doa_tpu.ops.min_norm import min_norm_spectrum

    R, _ = _R([60.0, 110.0])
    A = golden.ula_steering(np.linspace(0, 180, 361), 8, 0.5)
    P_g = golden.min_norm_spectrum(R, A, 2)
    P_j = np.asarray(min_norm_spectrum(
        jnp.asarray(R.astype(np.complex64)),
        jnp.asarray(A.astype(np.complex64)), 2))
    np.testing.assert_allclose(P_j, P_g, rtol=2e-3, atol=2e-4)


def test_min_norm_weight_from_signal_matches_golden():
    """The embedded-subspace weight path (power iteration's V) must
    reproduce the eigh-based golden weight."""
    from doa_tpu.ops.cpx_ops import signal_subspace_embedded
    from doa_tpu.ops.min_norm import min_norm_weight_from_signal

    R, _ = _R([50.0, 95.0], snr=15)
    w_g = golden.min_norm_weight(R, 2)
    Rc = Cpx(jnp.asarray(R.real.astype(np.float32)),
             jnp.asarray(R.imag.astype(np.float32)))
    V = signal_subspace_embedded(Rc, 2, iters=24)
    w_emb = np.asarray(min_norm_weight_from_signal(V))  # (B, 2N)
    N = R.shape[-1]
    w_j = w_emb[:, :N] + 1j * w_emb[:, N:]
    np.testing.assert_allclose(w_j, w_g, rtol=5e-3, atol=5e-4)


def test_min_norm_denominators_agree_across_paths():
    """subspace-embedded vs complex-projector split-plane denominators."""
    from doa_tpu.ops.cpx_ops import noise_projector_cpx
    from doa_tpu.ops.cpx_ops import signal_subspace_embedded
    from doa_tpu.ops.min_norm import (min_norm_denominator_cpx,
                                      min_norm_denominator_subspace)

    R, _ = _R([70.0, 130.0], snr=12, seed=5)
    A_h = golden.ula_steering(np.linspace(0, 180, 181), 8, 0.5)
    A = Cpx(jnp.asarray(A_h.real.astype(np.float32)),
            jnp.asarray(A_h.imag.astype(np.float32)))
    Rc = Cpx(jnp.asarray(R.real.astype(np.float32)),
             jnp.asarray(R.imag.astype(np.float32)))
    V = signal_subspace_embedded(Rc, 2, iters=24)
    den_sub = np.asarray(min_norm_denominator_subspace(V, A))
    M = noise_projector_cpx(Rc, 2)
    den_prj = np.asarray(min_norm_denominator_cpx(M, A))
    np.testing.assert_allclose(den_sub, den_prj, rtol=5e-3, atol=1e-5)


def test_root_min_norm_matches_golden_and_truth():
    from doa_tpu.ops.min_norm import root_min_norm

    R, _ = _R([55.0, 100.0], snr=15, seed=7)
    th_g = golden.root_min_norm(R, 2, 0.5)
    th_j = np.asarray(root_min_norm(
        jnp.asarray(R.astype(np.complex64)), 2, 0.5))
    np.testing.assert_allclose(th_j, th_g, atol=0.05)
    np.testing.assert_allclose(th_g.mean(0), [55.0, 100.0], atol=0.5)


@pytest.mark.parametrize("scan_mode", ["dense", "hierarchical"])
def test_min_norm_in_tpu_pipeline(scan_mode):
    """End-to-end: MIN_NORM alongside MUSIC in build_pipeline_tpu on
    both scan modes (the scan mode gates the MUSIC scan only; min-norm
    rides the warm-start V_emb of the interleaved path)."""
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8,
                               norm_spacing=0.5),
        snapshot_size=512, num_sources=2,
        estimators=(Estimator.MUSIC, Estimator.MIN_NORM),
        grid=GridSpec1D(num_points=512), num_max_vals=2,
        scan_mode=scan_mode)
    x = golden.synthetic_ula_iq([60.0, 110.0], 8, 0.5, 16384,
                                snr_db=10, seed=11).astype(np.complex64)
    res = build_pipeline_tpu(cfg)(x)
    mn = np.sort(np.asarray(res.peak_angles["min_norm"]), -1).mean(0)
    mu = np.sort(np.asarray(res.peak_angles["music"]), -1).mean(0)
    np.testing.assert_allclose(mn, [60.0, 110.0], atol=0.5)
    np.testing.assert_allclose(mu, [60.0, 110.0], atol=0.5)


def test_min_norm_in_complex_pipeline_and_eigh_path():
    """Complex/CPU pipeline parity + the eigh (use_power=False) branch
    of the split-complex pipeline."""
    from doa_tpu.pipeline import build_pipeline
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8,
                               norm_spacing=0.5),
        snapshot_size=512, num_sources=2,
        estimators=(Estimator.MIN_NORM,),
        grid=GridSpec1D(num_points=512), num_max_vals=2)
    x = golden.synthetic_ula_iq([60.0, 110.0], 8, 0.5, 16384,
                                snr_db=10, seed=11).astype(np.complex64)
    res_c = build_pipeline(cfg)(x)
    np.testing.assert_allclose(
        np.sort(np.asarray(res_c.peak_angles["min_norm"]), -1).mean(0),
        [60.0, 110.0], atol=0.5)
    cfg_e = dataclasses.replace(cfg, subspace_method="eigh")
    res_e = build_pipeline_tpu(cfg_e)(x)
    np.testing.assert_allclose(
        np.sort(np.asarray(res_e.peak_angles["min_norm"]), -1).mean(0),
        np.sort(np.asarray(res_c.peak_angles["min_norm"]), -1).mean(0),
        atol=0.1)


def test_esprit_in_complex_pipeline():
    """Regression: ESPRIT configured on the complex/CPU path used to
    raise ValueError in the estimator loop (now routed like
    pipeline_tpu to the grid-free handler)."""
    from doa_tpu.pipeline import build_pipeline

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8,
                               norm_spacing=0.5),
        snapshot_size=512, num_sources=2,
        estimators=(Estimator.MUSIC, Estimator.ESPRIT),
        grid=GridSpec1D(num_points=361), num_max_vals=2)
    x = golden.synthetic_ula_iq([60.0, 110.0], 8, 0.5, 16384,
                                snr_db=10, seed=11).astype(np.complex64)
    res = build_pipeline(cfg)(x)
    assert res.esprit_angles is not None
    np.testing.assert_allclose(
        np.sort(np.asarray(res.esprit_angles), -1).mean(0),
        [60.0, 110.0], atol=0.5)
