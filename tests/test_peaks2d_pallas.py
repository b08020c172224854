"""Parity tests for the 2-D peak extraction (ops.peaks.find_local_max_2d)
against the numpy reference golden.find_local_max_2d: random spectra,
edge cases (no interior maximum, ties, boundary peaks, plateaus) and
MUSIC-shaped spectra at the c5 grid, with and without refinement."""

import numpy as np
import pytest

import golden
from doa_tpu.ops.peaks import find_local_max_2d


def _check(P, k, refine):
    az_rng, el_rng = (-90.0, 90.0), (0.0, 90.0)
    v_ref, az_ref, el_ref = golden.find_local_max_2d(
        P, k, az_rng, el_rng, refine=refine)
    v_k, az_k, el_k = find_local_max_2d(
        P, k, az_rng, el_rng, refine=refine)
    np.testing.assert_allclose(np.asarray(v_k), np.asarray(v_ref),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(az_k), np.asarray(az_ref),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(el_k), np.asarray(el_ref),
                               atol=1e-5)


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("shape", [(7, 181, 91), (5, 61, 31),
                                   (3, 13, 9)])
def test_random_spectra_parity(shape, refine):
    rng = np.random.default_rng(0)
    P = rng.random(shape).astype(np.float32) + 0.1
    _check(P, 2, refine)
    _check(P, 4, refine)


@pytest.mark.parametrize("refine", [False, True])
def test_edge_cases_parity(refine):
    B, Ga, Ge = 6, 21, 17
    P = np.full((B, Ga, Ge), 0.5, np.float32)
    # window 0: monotone ramp — NO interior local max (global fallback)
    P[0] = np.linspace(0, 1, Ga * Ge).reshape(Ga, Ge)
    # window 1: single sharp peak — k=2 pads with the best peak
    P[1, 10, 8] = 5.0
    # window 2: two exact ties — first-flat-index tie-break
    P[2, 5, 5] = 3.0
    P[2, 15, 11] = 3.0
    # window 3: peak on the az boundary row (excluded) + interior peak
    P[3, 0, 7] = 9.0
    P[3, 12, 4] = 2.0
    # window 4: plateau (strict >/>= asymmetry picks the left/up edge)
    P[4, 8, 6] = 2.0
    P[4, 8, 7] = 2.0
    # window 5: peaks in opposite corners of the interior
    P[5, 1, 1] = 4.0
    P[5, Ga - 2, Ge - 2] = 3.5
    _check(P, 2, refine)


def test_pipeline_c5_shape_parity():
    """MUSIC-shaped spectra (reciprocal of a smooth denominator) at the
    c5 grid, through both k values the presets use."""
    rng = np.random.default_rng(3)
    B, Ga, Ge = 8, 181, 91
    az = np.linspace(-90, 90, Ga)[None, :, None]
    el = np.linspace(0, 90, Ge)[None, None, :]
    c_az = rng.uniform(-60, 60, (B, 1, 1))
    c_el = rng.uniform(20, 70, (B, 1, 1))
    den = ((az - c_az) / 30) ** 2 + ((el - c_el) / 20) ** 2 + 1e-3
    P = (1.0 / den + 0.01 * rng.random((B, Ga, Ge))).astype(np.float32)
    P /= P.max(axis=(1, 2), keepdims=True)
    _check(P, 2, True)
    _check(P, 1, False)


def test_peaks_impl_knob_pipeline():
    """The URA pipeline's 2-D peaks equal the golden peaks of its own
    returned spectrum (peak extraction is exact: no knob selects
    another implementation)."""
    from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                                 GridSpec2D)
    from doa_tpu.io import SourceSpec, synth_ura_iq
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    g2 = GridSpec2D(num_az=25, num_el=13)
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=16,
                               norm_spacing=0.5, shape=(4, 4)),
        snapshot_size=128, num_sources=1,
        estimators=(Estimator.MUSIC,), grid2d=g2, num_max_vals=1)
    x = synth_ura_iq(
        [SourceSpec(az_deg=-20.0, el_deg=30.0, freq_norm=0.1)],
        (4, 4), 0.5, 64 * 128, snr_db=10, seed=5).astype(np.complex64)
    res = build_pipeline_tpu(cfg)(x)
    P = np.asarray(res.spectra["music"]).reshape(-1, g2.num_az, g2.num_el)
    v, az, el = golden.find_local_max_2d(
        P, 1, (g2.az_lo_deg, g2.az_hi_deg), (g2.el_lo_deg, g2.el_hi_deg),
        refine=True)
    ang = np.asarray(res.peak_angles["music"])
    np.testing.assert_allclose(np.asarray(res.peak_values["music"]), v,
                               rtol=1e-6)
    np.testing.assert_allclose(ang[..., 0], az, atol=1e-5)
    np.testing.assert_allclose(ang[..., 1], el, atol=1e-5)
    assert np.abs(np.median(az) + 20.0) < 2.0, np.median(az)
