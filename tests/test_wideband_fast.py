"""Wideband interleaved-ingest path: interleaved rows → deinterleave →
channelizer + per-subband covariances (ops/wideband.py), parity against
the numpy golden and against the planes entry at every fusion mode.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import golden
from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                             GridSpec1D, GridSpec2D, WidebandSpec)
from doa_tpu.cpx import Cpx
from doa_tpu.io.synthetic import (SourceSpec, synth_wideband_ula_iq,
                                  synth_wideband_ura_iq)
from doa_tpu.ops.interleaved import (
    deinterleave, interleave_factor, to_interleaved)
from doa_tpu.ops.wideband import dft_matrix, subband_covariances
from doa_tpu.pipeline_tpu import build_pipeline_tpu


@pytest.mark.parametrize("variant", ["interleaved", "planes",
                                     "to_interleaved"])
@pytest.mark.parametrize("N,F,S,overlap", [
    (4, 16, 256, 0),        # TPACK=16 | F
    (8, 8, 256, 64),        # subband-domain overlap (hop_sub < S_sub)
    (4, 16, 512, 128),
])
def test_subband_cov_parity(N, F, S, overlap, variant):
    """Per-subband covariances of the corrected capture, entered as raw
    interleaved rows, as planes, or as planes converted to rows, equal
    the float64 golden channelizer + covariance."""
    rng = np.random.default_rng(0)
    T = 4096
    x = (rng.standard_normal((T, N))
         + 1j * rng.standard_normal((T, N))).astype(np.complex64)
    c = (rng.standard_normal(N)
         + 1j * rng.standard_normal(N)).astype(np.complex64)
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=N),
        snapshot_size=S, overlap=overlap,
        wideband=WidebandSpec(num_subbands=F, fractional_bw=0.1))
    tp = interleave_factor(N)
    if variant == "interleaved":
        xc = deinterleave(jnp.asarray(np.ascontiguousarray(x).view(
            np.float32).reshape(T // tp, 2 * N * tp)), N)
    elif variant == "planes":
        xc = Cpx.from_complex(x)
    else:
        p = Cpx.from_complex(x)
        xc = deinterleave(to_interleaved(p.re, p.im), N)
    cc = Cpx.from_complex(c)
    W = dft_matrix(F)
    R = subband_covariances(
        xc * Cpx(cc.re[None, :], cc.im[None, :]),
        Cpx(jnp.asarray(W.real), jnp.asarray(W.imag)), cfg)
    R_ref = golden.subband_covariances(x.astype(np.complex128) * c, F, S,
                                       overlap)
    assert R.re.shape == R_ref.shape
    scale = float(np.abs(R_ref).max())
    np.testing.assert_allclose(np.asarray(R.re), R_ref.real,
                               atol=2e-5 * scale)
    np.testing.assert_allclose(np.asarray(R.im), R_ref.imag,
                               atol=2e-5 * scale)


_ULA_MODES = [("incoherent", "dense", "power"),
              ("incoherent", "hierarchical", "power"),
              ("incoherent", "dense", "eigh"),
              ("cssm", "dense", "power"),
              ("cssm_auto", "dense", "power")]


@pytest.mark.parametrize("fusion,scan_mode,subspace", _ULA_MODES)
def test_pipeline_wideband_fast_parity_ula(fusion, scan_mode, subspace):
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=62.0, freq_norm=0.0, bandwidth_norm=0.5),
         SourceSpec(theta_deg=111.0, freq_norm=0.0, bandwidth_norm=0.5)],
        8, 0.5, 8 * 256 * 6, fractional_bw=0.1, snr_db=15,
        seed=3).astype(np.complex64)
    c = np.exp(1j * np.linspace(0, 0.5, 8)).astype(np.complex64)
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8,
                               norm_spacing=0.5),
        snapshot_size=256, num_sources=2, num_max_vals=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=256),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1,
                              fusion=fusion),
        subspace_method=subspace, scan_mode=scan_mode)
    pipe = build_pipeline_tpu(cfg)
    assert pipe.wb_fast
    a0 = np.asarray(pipe(Cpx.from_complex(x),
                         correction=c).peak_angles["music"])
    a1 = np.asarray(pipe(x, correction=c).peak_angles["music"])
    np.testing.assert_allclose(a1, a0, atol=5e-3)
    med = np.sort(np.median(a1, axis=0))
    assert abs(med[0] - 62.0) < 2.5 and abs(med[1] - 111.0) < 2.5, med


@pytest.mark.parametrize("fusion,scan_mode", [
    ("incoherent", "dense"), ("incoherent", "hierarchical"),
    ("cssm_auto", "dense")])
def test_pipeline_wideband_fast_parity_ura(fusion, scan_mode):
    x = synth_wideband_ura_iq(
        [SourceSpec(az_deg=-20.0, el_deg=30.0, freq_norm=0.0,
                    bandwidth_norm=0.5),
         SourceSpec(az_deg=35.0, el_deg=60.0, freq_norm=0.0,
                    bandwidth_norm=0.5)],
        (4, 4), 0.5, 16 * 128 * 4, fractional_bw=0.1, snr_db=15,
        seed=3).astype(np.complex64)
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=16, shape=(4, 4),
                               norm_spacing=0.5),
        snapshot_size=16 * 128, num_sources=2, num_max_vals=2,
        estimators=(Estimator.MUSIC,),
        grid2d=GridSpec2D(num_az=61, num_el=31),
        wideband=WidebandSpec(num_subbands=16, fractional_bw=0.1,
                              fusion=fusion),
        scan_mode=scan_mode)
    pipe = build_pipeline_tpu(cfg)
    assert pipe.wb_fast
    a0 = np.asarray(pipe(Cpx.from_complex(x)).peak_angles["music"])
    tp = interleave_factor(16)
    a1 = np.asarray(pipe.interleaved(np.ascontiguousarray(x).view(
        np.float32).reshape(x.shape[0] // tp, -1)).peak_angles["music"])
    np.testing.assert_allclose(a1, a0, atol=5e-3)


@pytest.mark.parametrize("snr_db", [15, 0])
@pytest.mark.parametrize("scan_mode", ["dense", "hierarchical"])
def test_wideband_warm_start_subspace(snr_db, scan_mode):
    """Warm-started per-window subspace iteration (3 E-applies from the
    capture-mean subspace) must match the cold 8-apply iteration's
    angles — including at 0 dB where convergence is slowest."""
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=62.0, freq_norm=0.0, bandwidth_norm=0.5),
         SourceSpec(theta_deg=111.0, freq_norm=0.0, bandwidth_norm=0.5)],
        8, 0.5, 8 * 256 * 6, fractional_bw=0.1, snr_db=snr_db,
        seed=3).astype(np.complex64)
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8,
                               norm_spacing=0.5),
        snapshot_size=256, num_sources=2, num_max_vals=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=256),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1),
        scan_mode=scan_mode, subspace_warm_start=False)
    cold = build_pipeline_tpu(cfg)
    warm = build_pipeline_tpu(
        dataclasses.replace(cfg, subspace_warm_start=True))
    a0 = np.asarray(cold(x).peak_angles["music"])
    a1 = np.asarray(warm(x).peak_angles["music"])
    tol = 0.05 if snr_db >= 10 else 0.5
    np.testing.assert_allclose(np.sort(a1, -1), np.sort(a0, -1),
                               atol=tol)
    med = np.sort(np.median(a1, axis=0))
    atol = 0.5 if snr_db >= 10 else 2.0
    assert abs(med[0] - 62.0) < atol and abs(med[1] - 111.0) < atol, med


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_wideband_quantized_scan(dtype):
    """cfg.compute_dtype now reaches the wideband subband scans (the
    F1 quantized-scan capability applied to wideband): reduced
    precision must still localize well-separated sources."""
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=62.0, freq_norm=0.0, bandwidth_norm=0.5),
         SourceSpec(theta_deg=111.0, freq_norm=0.0, bandwidth_norm=0.5)],
        8, 0.5, 8 * 256 * 6, fractional_bw=0.1, snr_db=15,
        seed=3).astype(np.complex64)
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8,
                               norm_spacing=0.5),
        snapshot_size=256, num_sources=2, num_max_vals=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=256),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1),
        compute_dtype=dtype)
    pipe = build_pipeline_tpu(cfg)
    med = np.sort(np.median(
        np.asarray(pipe(x).peak_angles["music"]), axis=0))
    tol = 1.5 if dtype == "bfloat16" else 3.0
    assert abs(med[0] - 62.0) < tol and abs(med[1] - 111.0) < tol, med


def test_wb_fast_gating():
    """tp ∤ F falls back to the planes path (no wb_fast)."""
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=4),  # TPACK=16
        snapshot_size=256,
        wideband=WidebandSpec(num_subbands=8))               # 16 ∤ 8
    pipe = build_pipeline_tpu(cfg)
    assert not pipe.wb_fast
    x = (np.random.default_rng(0).standard_normal((2048, 4))
         + 0j).astype(np.complex64)
    pipe(x)  # planes path still serves the call
