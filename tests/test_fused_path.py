"""Interleaved-ingest path: ops.interleaved.cov_embedded and the
warm-start subspace stage against the numpy golden (float64).

Reference semantics: autocorrelate / antenna_correction (SURVEY §2.1
C1/C5) with the correction folded via cov(diag(c)x) = (c cᴴ) ∘ cov(x).
Tolerances hold at the CPU backend's exact f32 matmuls; bf16 and int8
ingest are compared against the golden on the SAME rounded samples, so
only the f32 accumulation differs.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import golden
from doa_tpu.cpx import Cpx, embed_hermitian
from doa_tpu.io.native import quantize_interleaved_int8
from doa_tpu.ops import cpx_ops
from doa_tpu.ops.interleaved import (
    cov_embedded, interleave_factor, to_interleaved)


def _x(N=16, T=16 * 256, thetas=(60.0, 110.0), snr=10, seed=3):
    return golden.synthetic_ula_iq(list(thetas), N, 0.5, T,
                                   snr_db=snr, seed=seed)


def _embed_np(R):
    top = np.concatenate([R.real, -R.imag], axis=-1)
    bot = np.concatenate([R.imag, R.real], axis=-1)
    return np.concatenate([top, bot], axis=-2)


def test_raw_c64_buffer_is_interleaved_layout():
    """A C-ordered complex64 capture viewed as f32 must equal the
    to_interleaved conversion bit-for-bit (the zero-copy ingest claim)."""
    x = _x().astype(np.complex64)
    xc = Cpx.from_complex(x)
    T, N = x.shape
    tp = interleave_factor(N)
    raw = np.ascontiguousarray(x).view(np.float32).reshape(
        T // tp, 2 * N * tp)
    conv = np.asarray(to_interleaved(xc.re, xc.im))
    np.testing.assert_array_equal(raw, conv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("overlap,fb", [(0, False), (128, False),
                                        (0, True), (192, True),
                                        (100, False), (156, True)])
def test_cov_embedded_parity(overlap, fb, dtype):
    """E(R) from interleaved rows == the golden windowed covariance of
    the corrected samples (f32, bf16 and int8 ingest × overlap × FB)."""
    N, S = 16, 256
    x = _x(N=N).astype(np.complex64)
    rng = np.random.default_rng(0)
    corr = ((1.0 + 0.1 * rng.standard_normal(N))
            * np.exp(1j * rng.uniform(-0.3, 0.3, N))).astype(np.complex64)
    tp = interleave_factor(N)
    xil = jnp.asarray(np.ascontiguousarray(x).view(np.float32).reshape(
        x.shape[0] // tp, 2 * N * tp))
    if dtype == "int8":
        xil = quantize_interleaved_int8(xil)[0]
    elif dtype == "bfloat16":
        xil = xil.astype(jnp.bfloat16)
    # golden on the same (rounded) samples, in float64
    xr = np.asarray(xil.astype(jnp.float32), np.float64).reshape(-1, N, 2)
    xg = (xr[..., 0] + 1j * xr[..., 1]) * corr.astype(np.complex128)
    R_ref = golden.sample_covariance(golden.frame_samples(xg, S, overlap),
                                     fb_average=fb)
    E_ref = _embed_np(R_ref)
    R, E = cov_embedded(
        xil, jnp.asarray(corr.real), jnp.asarray(corr.imag), N=N,
        snapshot_size=S, overlap=overlap, fb=fb, compute_dtype=dtype)
    E = np.asarray(E)
    assert E.shape == E_ref.shape
    np.testing.assert_allclose(E, E_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(E_ref).max())
    np.testing.assert_allclose(np.asarray(R.re), R_ref.real, rtol=1e-4,
                               atol=1e-5 * np.abs(E_ref).max())


@pytest.mark.parametrize("N,K", [(16, 2), (8, 2), (8, 3)])
def test_subspace_packed_projector_parity(N, K):
    """The transposed-layout subspace iteration the interleaved path
    runs (cold and warm-started from the capture-mean subspace) spans
    the golden eigh signal subspace."""
    x = _x(N=N, T=50 * 1024, thetas=(60.0, 110.0, 88.0)[:max(K, 2)])
    R = golden.sample_covariance(golden.frame_samples(x, 1024, 0))
    w, v = np.linalg.eigh(_embed_np(R))
    Vg = v[..., -2 * K:]
    Pref = np.einsum("bik,bjk->bij", Vg, Vg)
    E = embed_hermitian(Cpx.from_complex(R))
    Vt_bar = cpx_ops.signal_subspace_from_E_T(
        jnp.mean(E, axis=0)[None], K, iters=16)
    init = jnp.broadcast_to(Vt_bar, (E.shape[0],) + Vt_bar.shape[1:])
    for kw in (dict(iters=16), dict(iters=16, init=init)):
        V = np.swapaxes(np.asarray(
            cpx_ops.signal_subspace_from_E_T(E, K, **kw)), -1, -2)
        Pnew = np.einsum("bik,bjk->bij", V, V)
        np.testing.assert_allclose(Pnew, Pref, atol=2e-5)
        orth = np.einsum("bik,bil->bkl", V, V)
        np.testing.assert_allclose(
            orth, np.broadcast_to(np.eye(2 * K), orth.shape), atol=5e-6)


def test_zero_copy_c64_entry_matches_planes():
    """build_pipeline_tpu on the interleaved path: raw complex64 ndarray
    in (zero-copy view) must match the Cpx-planes route."""
    from doa_tpu import PRESETS
    from doa_tpu.pipeline_tpu import build_pipeline_tpu
    cfg = PRESETS["c2_ula8_2src"]
    x = _x(N=8, T=8 * 2048).astype(np.complex64)
    pipe = build_pipeline_tpu(cfg)
    assert pipe.fast_path
    out_raw = pipe(x)                      # ndarray → interleaved view
    out_cpx = pipe(Cpx.from_complex(x))    # planes route
    np.testing.assert_allclose(
        np.asarray(out_raw.peak_angles["music"]),
        np.asarray(out_cpx.peak_angles["music"]), atol=1e-4)
    r = pipe.interleaved(np.ascontiguousarray(x).view(np.float32).reshape(
        x.shape[0] // interleave_factor(8), -1))
    np.testing.assert_allclose(
        np.asarray(r.peak_angles["music"]),
        np.asarray(out_raw.peak_angles["music"]), atol=1e-4)


def test_cov_embedded_variants_agree():
    """Interleaved-row Gram == the split-planes stacked Gram
    (cpx_ops.cov_from_stream_cpx), correction and FB folded alike."""
    N, S = 16, 256
    x = _x(N=N, T=8 * S + 100)
    xc = Cpx.from_complex(x)
    rng = np.random.default_rng(7)
    c = Cpx(jnp.asarray(rng.standard_normal(N).astype(np.float32)),
            jnp.asarray(rng.standard_normal(N).astype(np.float32)))
    T = (x.shape[0] // interleave_factor(N)) * interleave_factor(N)
    xil = to_interleaved(xc.re[:T], xc.im[:T])
    for ov, fb in ((0, False), (128, True)):
        _, Ei = cov_embedded(xil, c.re, c.im, N=N, snapshot_size=S,
                             overlap=ov, fb=fb)
        R = cpx_ops.apply_correction_to_cov(
            cpx_ops.cov_from_stream_cpx(xc, S, ov), c)
        if fb:
            R = cpx_ops.forward_backward_cpx(R)
        Ep = np.asarray(embed_hermitian(R))
        np.testing.assert_allclose(np.asarray(Ei), Ep, rtol=1e-5,
                                   atol=1e-5 * np.abs(Ep).max())


def test_int8_ingest_mode():
    """cov_dtype='int8' (ingest-quantized mode): a pre-quantized int8
    interleaved buffer through the interleaved path must estimate the
    planted scene, and the quantized covariance must equal scale2*R of
    the quantized samples exactly (int32 Gram accumulation)."""
    from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                                 GridSpec1D)
    from doa_tpu.io import SourceSpec, synth_ula_iq
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=512, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=512), num_max_vals=2,
        cov_dtype="int8")
    x = synth_ula_iq(
        [SourceSpec(theta_deg=62.0, freq_norm=0.1),
         SourceSpec(theta_deg=117.0, freq_norm=0.3)],
        16, 0.5, 64 * 512, snr_db=10, seed=3).astype(np.complex64)
    T = x.shape[0]
    tp = 128 // 32
    xil = np.ascontiguousarray(x).view(np.float32).reshape(
        T // tp, 32 * tp)
    xq, scale = quantize_interleaved_int8(jnp.asarray(xil))
    pipe = build_pipeline_tpu(cfg, return_spectra=False)
    assert pipe.fast_path
    res = pipe.interleaved(xq)
    ang = np.sort(np.asarray(res.peak_angles["music"]), -1)
    assert np.abs(ang[:, 0] - 62.0).max() < 0.5, ang
    assert np.abs(ang[:, 1] - 117.0).max() < 0.5, ang

    # f32 pipeline on the DEQUANTIZED samples == int8 pipeline (the
    # Gram is exact in int32, so the only difference is the global
    # scale2, which peaks/angles are invariant to)
    cfg_f = dataclasses.replace(cfg, cov_dtype="float32")
    xdq = np.asarray(xq, np.float32) / float(scale)
    res_f = build_pipeline_tpu(cfg_f, return_spectra=False).interleaved(
        jnp.asarray(xdq))
    np.testing.assert_allclose(
        ang, np.sort(np.asarray(res_f.peak_angles["music"]), -1),
        atol=1e-3)

    # a float buffer through the int8 mode auto-quantizes on device
    # (the fast_int8 preset works via the ordinary entries); the c64
    # front door works too
    res_auto = pipe.interleaved(jnp.asarray(xil))
    np.testing.assert_allclose(
        np.sort(np.asarray(res_auto.peak_angles["music"]), -1),
        ang, atol=0.2)
    res_c64 = pipe(x)
    np.testing.assert_allclose(
        np.sort(np.asarray(res_c64.peak_angles["music"]), -1),
        ang, atol=0.2)
