"""Multi-device sharding tests on the 8-device virtual CPU mesh: halo
exchange correctness (sharded == single-device), grid TP, distributed
covariance psum."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import golden
from doa_tpu.configs import DoaConfig, ArrayGeometry, GridSpec1D, Estimator
from doa_tpu.parallel import (
    MeshSpec, make_mesh, build_sharded_pipeline, distributed_covariance)
from doa_tpu.parallel.sharded import num_valid_windows
from doa_tpu.pipeline import build_pipeline
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu.io import SourceSpec, synth_ula_iq


CFG = DoaConfig(
    geometry=ArrayGeometry(kind="ula", num_elements=8, norm_spacing=0.5),
    snapshot_size=512,
    overlap=256,
    num_sources=2,
    estimators=(Estimator.MUSIC, Estimator.CAPON),
    grid=GridSpec1D(num_points=512),
    num_max_vals=2,
)


def _capture(T=16384):
    return synth_ula_iq(
        [SourceSpec(theta_deg=62.0), SourceSpec(theta_deg=117.0,
                                                freq_norm=0.3)],
        8, 0.5, T, snr_db=10, seed=9)


@pytest.mark.parametrize("spec", [MeshSpec(8, 1), MeshSpec(4, 2),
                                  MeshSpec(2, 4)])
def test_sharded_matches_single_device_exact(spec):
    """eigh path: sharded must reproduce the complex reference pipeline."""
    cfg = dataclasses.replace(CFG, subspace_method="eigh")
    x = _capture()
    mesh = make_mesh(spec)
    out = build_sharded_pipeline(cfg, mesh)(x)
    B_valid = num_valid_windows(x.shape[0], cfg)

    ref = build_pipeline(cfg)(x)
    for est in ("music", "capon"):
        P_s = np.asarray(out[f"spectrum_{est}"])[:B_valid]
        P_r = np.asarray(ref.spectra[est])
        np.testing.assert_allclose(P_s, P_r, rtol=2e-3, atol=2e-4)
        a_s = np.asarray(out[f"peak_angles_{est}"])[:B_valid]
        a_r = np.asarray(ref.peak_angles[est])
        np.testing.assert_allclose(a_s, a_r, atol=0.01)


def test_sharded_power_matches_single_device_power():
    """power path (the default): sharded == single-device pipeline."""
    x = _capture()
    mesh = make_mesh(MeshSpec(4, 2))
    out = build_sharded_pipeline(CFG, mesh)(x)
    B_valid = num_valid_windows(x.shape[0], CFG)
    ref = build_pipeline_tpu(CFG)(x)
    for est in ("music", "capon"):
        a_s = np.sort(np.asarray(out[f"peak_angles_{est}"])[:B_valid], -1)
        a_r = np.sort(np.asarray(ref.peak_angles[est]), -1)
        np.testing.assert_allclose(a_s, a_r, atol=0.05)


def test_sharded_angle_accuracy():
    x = _capture()
    mesh = make_mesh(MeshSpec(4, 2))
    out = build_sharded_pipeline(CFG, mesh)(x)
    B_valid = num_valid_windows(x.shape[0], CFG)
    locs = np.sort(np.asarray(out["peak_angles_music"])[:B_valid], axis=-1)
    assert np.abs(locs[:, 0] - 62.0).max() < 1.0
    assert np.abs(locs[:, 1] - 117.0).max() < 1.0


def test_distributed_covariance_matches_full():
    x = _capture(8192)
    mesh = make_mesh(MeshSpec(8, 1))
    R_dist = distributed_covariance(mesh)(x).to_numpy()
    R_full = golden.sample_covariance(x[None])[0]
    np.testing.assert_allclose(R_dist, R_full, rtol=3e-4, atol=2e-5)


def test_num_valid_windows():
    assert num_valid_windows(16384, CFG) == (16384 - 512) // 256 + 1
    assert num_valid_windows(100, CFG) == 0


def test_sharded_gridfree_estimators():
    cfg = dataclasses.replace(
        CFG, estimators=(Estimator.MUSIC, Estimator.ROOT_MUSIC,
                         Estimator.ESPRIT))
    x = _capture()
    mesh = make_mesh(MeshSpec(4, 2))
    out = build_sharded_pipeline(cfg, mesh)(x)
    B_valid = num_valid_windows(x.shape[0], cfg)
    for key in ("root_music_angles", "esprit_angles"):
        a = np.asarray(out[key])[:B_valid]
        assert np.abs(a[:, 0] - 62.0).max() < 0.5, (key, a)
        assert np.abs(a[:, 1] - 117.0).max() < 0.5, (key, a)


def test_sharded_2d_planar():
    from doa_tpu.configs import ArrayGeometry, GridSpec2D
    from doa_tpu.io import synth_ura_iq

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=64,
                               norm_spacing=0.5, shape=(8, 8)),
        snapshot_size=512, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid2d=GridSpec2D(num_az=44, num_el=24, az_lo_deg=-90,
                          az_hi_deg=90, el_lo_deg=0, el_hi_deg=90),
        num_max_vals=2)
    truths = [(-30.0, 20.0), (40.0, 55.0)]
    from doa_tpu.io import SourceSpec
    x = synth_ura_iq(
        [SourceSpec(az_deg=truths[0][0], el_deg=truths[0][1],
                    freq_norm=0.1),
         SourceSpec(az_deg=truths[1][0], el_deg=truths[1][1],
                    freq_norm=0.3)],
        (8, 8), 0.5, 8 * 512, snr_db=10, seed=0)
    mesh = make_mesh(MeshSpec(4, 2))
    out = build_sharded_pipeline(cfg, mesh)(x)
    ang = np.asarray(out["peak_angles_music"])  # (B, 2, 2)
    B_valid = num_valid_windows(x.shape[0], cfg)
    for b in range(B_valid):
        for k in range(2):
            d = min(np.hypot(ang[b, k, 0] - t[0], ang[b, k, 1] - t[1])
                    for t in truths)
            assert d < 5.0, ang[b]


@pytest.mark.parametrize("spec", [MeshSpec(4, 2), MeshSpec(2, 4)])
def test_sharded_wideband_ep_parity(spec):
    """EP-sharded wideband (subbands over the second mesh axis) must
    match the single-device wideband pipeline."""
    from doa_tpu.configs import WidebandSpec
    from doa_tpu.io.synthetic import synth_wideband_ula_iq

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8,
                               norm_spacing=0.5),
        snapshot_size=256, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=128),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1),
        num_max_vals=2)
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=62.0, freq_norm=0.0, bandwidth_norm=0.5),
         SourceSpec(theta_deg=117.0, freq_norm=0.0, bandwidth_norm=0.5)],
        8, 0.5, 16 * 1024, snr_db=12, seed=7, fractional_bw=0.1)
    mesh = make_mesh(spec)
    out = build_sharded_pipeline(cfg, mesh)(x)
    ref = build_pipeline_tpu(cfg)(x)
    P_s = np.asarray(out["spectrum_music"])
    P_r = np.asarray(ref.spectra["music"])
    assert P_s.shape == P_r.shape
    np.testing.assert_allclose(P_s, P_r, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        np.sort(np.asarray(out["peak_angles_music"]), -1),
        np.sort(np.asarray(ref.peak_angles["music"]), -1), atol=0.05)


@pytest.mark.parametrize("spec", [MeshSpec(4, 2), MeshSpec(2, 4)])
def test_sharded_wideband_fast_parity(spec):
    """The interleaved wideband ingest under shard_map (per-device
    deinterleave of the local block, EP over subbands) must match the
    single-device pipeline's interleaved and planes routes."""
    from doa_tpu.configs import WidebandSpec
    from doa_tpu.io.synthetic import synth_wideband_ula_iq

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8,
                               norm_spacing=0.5),
        snapshot_size=256, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=128),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1),
        num_max_vals=2)
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=62.0, freq_norm=0.0, bandwidth_norm=0.5),
         SourceSpec(theta_deg=117.0, freq_norm=0.0, bandwidth_norm=0.5)],
        8, 0.5, 16 * 1024, snr_db=12, seed=7,
        fractional_bw=0.1).astype(np.complex64)
    c = np.exp(1j * np.linspace(0, 0.4, 8)).astype(np.complex64)
    mesh = make_mesh(spec)
    pipe_fast = build_sharded_pipeline(cfg, mesh)
    assert pipe_fast.fast
    out_f = pipe_fast(x, correction=c)
    single = build_pipeline_tpu(cfg)
    assert single.wb_fast
    out_x = single(x, correction=c)
    np.testing.assert_allclose(np.asarray(out_f["spectrum_music"]),
                               np.asarray(out_x.spectra["music"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(out_f["peak_angles_music"]),
        np.asarray(out_x.peak_angles["music"]), atol=5e-3)
    from doa_tpu.cpx import Cpx
    ref = single(Cpx.from_complex(x), correction=c)
    np.testing.assert_allclose(
        np.sort(np.asarray(out_f["peak_angles_music"]), -1),
        np.sort(np.asarray(ref.peak_angles["music"]), -1), atol=0.05)


@pytest.mark.parametrize("spec", [MeshSpec(4, 2), MeshSpec(2, 4)])
def test_sharded_wideband_cssm_parity(spec):
    """Coherent (CSSM) sharded wideband: EP-sharded focused covariances
    psum-fused, then the SAME mesh axis reused for the TP grid scan —
    must match the single-device CSSM pipeline."""
    from doa_tpu.configs import WidebandSpec
    from doa_tpu.io.synthetic import synth_wideband_ula_iq

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8,
                               norm_spacing=0.5),
        snapshot_size=256, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=128),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1,
                              fusion="cssm"),
        num_max_vals=2)
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=62.0, freq_norm=0.0, bandwidth_norm=0.5),
         SourceSpec(theta_deg=117.0, freq_norm=0.0, bandwidth_norm=0.5)],
        8, 0.5, 16 * 1024, snr_db=12, seed=7, fractional_bw=0.1)
    mesh = make_mesh(spec)
    out = build_sharded_pipeline(cfg, mesh)(x)
    ref = build_pipeline_tpu(cfg)(x)
    P_r = np.asarray(ref.spectra["music"])
    P_s = np.asarray(out["spectrum_music"])
    assert P_s.shape == P_r.shape
    np.testing.assert_allclose(P_s, P_r, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        np.sort(np.asarray(out["peak_angles_music"]), -1),
        np.sort(np.asarray(ref.peak_angles["music"]), -1), atol=0.05)


def test_sharded_new_estimators_parity():
    """MIN_NORM (grid-sharded scan, zero extra comms) and
    UNITARY_ESPRIT (snap-sharded grid-free) in the sharded pipeline
    vs the single-device pipeline."""
    cfg = dataclasses.replace(
        CFG, estimators=(Estimator.MUSIC, Estimator.MIN_NORM,
                         Estimator.UNITARY_ESPRIT))
    x = _capture()
    mesh = make_mesh(MeshSpec(4, 2))
    out = build_sharded_pipeline(cfg, mesh)(x)
    B_valid = num_valid_windows(x.shape[0], cfg)
    ref = build_pipeline_tpu(cfg)(x)
    a_s = np.sort(np.asarray(out["peak_angles_min_norm"])[:B_valid], -1)
    a_r = np.sort(np.asarray(ref.peak_angles["min_norm"]), -1)
    np.testing.assert_allclose(a_s, a_r, atol=0.05)
    u_s = np.asarray(out["unitary_esprit_angles"])[:B_valid]
    u_r = np.asarray(ref.unitary_esprit_angles)
    np.testing.assert_allclose(u_s, u_r, atol=0.05)


def test_sharded_halo_impl_knob():
    """sharded.halo_exchange (lax.ppermute under shard_map): every time
    shard gets its right neighbor's first `overlap` rows appended, the
    last shard a zero halo — and the sharded pipeline built on it is
    deterministic across builds."""
    from jax.sharding import PartitionSpec as P

    from doa_tpu.parallel.mesh import SNAP_AXIS
    from doa_tpu.parallel.sharded import halo_exchange

    mesh = make_mesh(MeshSpec(4, 2))
    rows, ov = 16, 5
    xr = np.arange(4 * rows * 3, dtype=np.float32).reshape(4 * rows, 3)
    got = np.asarray(jax.jit(jax.shard_map(
        lambda b: halo_exchange(b, ov, SNAP_AXIS), mesh=mesh,
        in_specs=(P(SNAP_AXIS, None),), out_specs=P(SNAP_AXIS, None),
        check_vma=False))(jnp.asarray(xr)))
    got = got.reshape(4, rows + ov, 3)
    for d in range(4):
        np.testing.assert_array_equal(got[d, :rows],
                                      xr[d * rows:(d + 1) * rows])
        halo = (xr[(d + 1) * rows:(d + 1) * rows + ov] if d < 3
                else np.zeros((ov, 3), np.float32))
        np.testing.assert_array_equal(got[d, rows:], halo)
    x = _capture()
    B_valid = num_valid_windows(x.shape[0], CFG)
    out_a = build_sharded_pipeline(CFG, mesh)(x)
    out_b = build_sharded_pipeline(CFG, mesh)(x)
    for k in out_a:
        a, b = np.asarray(out_a[k]), np.asarray(out_b[k])
        if a.ndim:
            a, b = a[:B_valid], b[:B_valid]
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", [MeshSpec(4, 2), MeshSpec(2, 4)])
def test_sharded_beamspace_parity(spec):
    """Beamspace through the sharded pipeline (TP shards the projected
    grid, the tiny beam matrix is replicated): peaks must match the
    single-device beamspace path for MUSIC, Capon and Bartlett."""
    from doa_tpu.configs import BeamspaceSpec

    cfg = dataclasses.replace(
        CFG, estimators=(Estimator.MUSIC, Estimator.CAPON,
                         Estimator.BARTLETT),
        beamspace=BeamspaceSpec(num_beams=5, center_deg=90.0),
        num_max_vals=2)
    x = _capture()
    mesh = make_mesh(spec)
    out = build_sharded_pipeline(cfg, mesh)(x)
    B_valid = num_valid_windows(x.shape[0], cfg)
    ref = build_pipeline_tpu(cfg)(x)
    for est in ("music", "capon", "bartlett"):
        a_s = np.sort(np.asarray(out[f"peak_angles_{est}"])[:B_valid], -1)
        a_r = np.sort(np.asarray(ref.peak_angles[est]), -1)
        np.testing.assert_allclose(a_s, a_r, atol=0.05)


def test_sharded_cssm_auto_parity():
    """EP-sharded two-pass auto-focused CSSM vs the single-device
    pipeline: same runtime-estimated focusing (the fused coarse
    spectrum is psum-replicated, so every device derives identical
    focusing directions) → same peaks."""
    from doa_tpu.configs import WidebandSpec
    from doa_tpu.io.synthetic import synth_wideband_ula_iq

    cfg = dataclasses.replace(
        CFG, geometry=ArrayGeometry(kind="ula", num_elements=16,
                                    norm_spacing=0.5),
        snapshot_size=512, overlap=0, estimators=(Estimator.MUSIC,),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.3,
                              fusion="cssm_auto"))
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=65.0, freq_norm=0.0, bandwidth_norm=0.4),
         SourceSpec(theta_deg=115.0, freq_norm=0.0, bandwidth_norm=0.4)],
        16, 0.5, 16 * 512, fractional_bw=0.3, snr_db=10, seed=2)
    mesh = make_mesh(MeshSpec(2, 4))
    out = build_sharded_pipeline(cfg, mesh)(x)
    from doa_tpu.pipeline_tpu import build_pipeline_tpu
    ref = build_pipeline_tpu(cfg)(x)
    a_s = np.sort(np.asarray(out["peak_angles_music"]), -1)
    a_r = np.sort(np.asarray(ref.peak_angles["music"]), -1)
    # pass-1 coarse covariances differ slightly (sharded pools window
    # means across time shards exactly like the single program — any
    # residual is f32 reduction order), so compare peak medians
    np.testing.assert_allclose(np.median(a_s, 0), np.median(a_r, 0),
                               atol=0.2)
    np.testing.assert_allclose(np.median(a_s, 0), [65.0, 115.0],
                               atol=2.0)


@pytest.mark.parametrize("spec", [MeshSpec(8, 1), MeshSpec(4, 2),
                                  MeshSpec(2, 4)])
def test_sharded_fast_narrowband_parity(spec):
    """The interleaved path under shard_map: interleaved ingest +
    embedded-covariance Gram + warm subspaces from the psum'd global
    capture mean + scan into the O(k) merge — must match the
    single-device interleaved pipeline at every mesh shape, with
    overlap > 0 and a calibration correction."""
    cfg = CFG
    x = _capture().astype(np.complex64)
    c = np.exp(1j * np.linspace(0, 0.3, 8)).astype(np.complex64)
    mesh = make_mesh(spec)
    pipe = build_sharded_pipeline(cfg, mesh)
    assert pipe.fast
    out = pipe(x, correction=c)
    B_valid = num_valid_windows(x.shape[0], cfg)
    ref = build_pipeline_tpu(cfg)(x, correction=c)
    for est in ("music", "capon"):
        a_s = np.sort(np.asarray(out[f"peak_angles_{est}"])[:B_valid],
                      -1)
        a_r = np.sort(np.asarray(ref.peak_angles[est]), -1)
        np.testing.assert_allclose(a_s, a_r, atol=5e-3)
    P_s = np.asarray(out["spectrum_music"])[:B_valid]
    P_r = np.asarray(ref.spectra["music"])
    np.testing.assert_allclose(P_s, P_r, rtol=5e-3, atol=2e-3)
    # escalation counters ride the fast path (healthy capture → 0)
    assert int(out["escalation_flagged"]) == 0
    assert int(out["escalation_overflow"]) == 0


def test_sharded_fast_gridfree_and_minnorm():
    """Grid-free estimators + Min-Norm on the fast sharded path."""
    cfg = dataclasses.replace(
        CFG,
        estimators=(Estimator.MUSIC, Estimator.ROOT_MUSIC,
                    Estimator.ESPRIT, Estimator.MIN_NORM))
    x = _capture().astype(np.complex64)
    mesh = make_mesh(MeshSpec(4, 2))
    pipe = build_sharded_pipeline(cfg, mesh)
    assert pipe.fast
    out = pipe(x)
    B_valid = num_valid_windows(x.shape[0], cfg)
    for key in ("root_music_angles", "esprit_angles"):
        a = np.asarray(out[key])[:B_valid]
        assert np.abs(a[:, 0] - 62.0).max() < 0.5, (key, a)
        assert np.abs(a[:, 1] - 117.0).max() < 0.5, (key, a)
    ref = build_pipeline_tpu(cfg)(x)
    a_s = np.sort(np.asarray(out["peak_angles_min_norm"])[:B_valid], -1)
    a_r = np.sort(np.asarray(ref.peak_angles["min_norm"]), -1)
    np.testing.assert_allclose(a_s, a_r, atol=0.05)


def test_local_peaks_merge_2d_parity():
    """The 2-D O(k) az-row-halo merge (VERDICT r4 missing #4) must
    reproduce dense find_local_max_2d exactly: same peak rule,
    tie-break, refinement, and global-max normalization — with comm
    per call independent of G."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from doa_tpu.configs import GridSpec2D
    from doa_tpu.ops.peaks import find_local_max_2d
    from doa_tpu.parallel.mesh import GRID_AXIS, SNAP_AXIS
    from doa_tpu.parallel.sharded import _local_peaks_merge_2d

    g2 = GridSpec2D(num_az=24, num_el=13, az_lo_deg=-90, az_hi_deg=90,
                    el_lo_deg=0, el_hi_deg=90)
    rng = np.random.default_rng(0)
    B, G = 16, 24 * 13
    az = np.linspace(-90, 90, 24)[None, :, None]
    el = np.linspace(0, 90, 13)[None, None, :]
    ca = rng.uniform(-60, 60, (B, 1, 1))
    ce = rng.uniform(20, 70, (B, 1, 1))
    Pmat = (1.0 / (((az - ca) / 30) ** 2 + ((el - ce) / 20) ** 2 + 1e-2)
            + 0.05 * rng.random((B, 24, 13))).astype(
                np.float32).reshape(B, G)
    mesh = make_mesh(MeshSpec(2, 4))

    for refine in (False, True):
        def fn(P_loc):
            v, l, gmax = _local_peaks_merge_2d(P_loc, 2, g2, refine)
            return v, l

        sm = jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=(P(SNAP_AXIS, GRID_AXIS),),
            out_specs=(P(SNAP_AXIS, None), P(SNAP_AXIS, None)),
            check_vma=False))
        v_m, l_m = sm(jnp.asarray(Pmat))
        Pn = Pmat / Pmat.max(-1, keepdims=True)
        v_r, az_r, el_r = find_local_max_2d(
            jnp.asarray(Pn).reshape(B, 24, 13), 2,
            (-90.0, 90.0), (0.0, 90.0), refine=refine)
        np.testing.assert_allclose(np.asarray(v_m), np.asarray(v_r),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(l_m)[..., 0],
                                   np.asarray(az_r), atol=1e-5)
        np.testing.assert_allclose(np.asarray(l_m)[..., 1],
                                   np.asarray(el_r), atol=1e-5)


def test_sharded_fast_peaks_only_mode():
    """return_spectra=False (the production streaming shape): peaks
    must equal the spectra-mode merge AND the single-device streaming
    pipeline at (8,1) and grid-sharded meshes, with no spectrum
    outputs."""
    cfg = dataclasses.replace(CFG, estimators=(Estimator.MUSIC,))
    x = _capture().astype(np.complex64)
    B_valid = num_valid_windows(x.shape[0], cfg)
    ref = build_pipeline_tpu(cfg, return_spectra=False)(x)
    a_r = np.asarray(ref.peak_angles["music"])
    for spec in (MeshSpec(8, 1), MeshSpec(4, 2)):
        mesh = make_mesh(spec)
        pipe = build_sharded_pipeline(cfg, mesh, return_spectra=False)
        assert pipe.fast
        out = pipe(x)
        assert not any(k.startswith("spectrum") for k in out)
        a_s = np.asarray(out["peak_angles_music"])[:B_valid]
        np.testing.assert_allclose(np.sort(a_s, -1), np.sort(a_r, -1),
                                   atol=5e-3)
        full = build_sharded_pipeline(cfg, mesh)(x)
        np.testing.assert_allclose(
            a_s, np.asarray(full["peak_angles_music"])[:B_valid],
            atol=5e-3)


def test_sharded_wideband_peaks_only_mode():
    """return_spectra=False reaches the wideband and CSSM sharded
    builders too: no spectrum outputs, identical peaks."""
    from doa_tpu.configs import WidebandSpec
    from doa_tpu.io.synthetic import synth_wideband_ula_iq

    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=62.0, freq_norm=0.0, bandwidth_norm=0.5),
         SourceSpec(theta_deg=117.0, freq_norm=0.0,
                    bandwidth_norm=0.5)],
        8, 0.5, 16 * 1024, snr_db=12, seed=7, fractional_bw=0.1)
    mesh = make_mesh(MeshSpec(4, 2))
    for fusion in ("incoherent", "cssm"):
        cfg = DoaConfig(
            geometry=ArrayGeometry(kind="ula", num_elements=8,
                                   norm_spacing=0.5),
            snapshot_size=256, num_sources=2,
            estimators=(Estimator.MUSIC,),
            grid=GridSpec1D(num_points=128),
            wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1,
                                  fusion=fusion),
            num_max_vals=2)
        full = build_sharded_pipeline(cfg, mesh)(x)
        lean = build_sharded_pipeline(cfg, mesh,
                                      return_spectra=False)(x)
        assert not any(k.startswith("spectrum") for k in lean), fusion
        np.testing.assert_allclose(
            np.asarray(lean["peak_angles_music"]),
            np.asarray(full["peak_angles_music"]), atol=1e-5)


@pytest.mark.parametrize("spec", [MeshSpec(4, 2), MeshSpec(2, 4)])
def test_sharded_wideband_tops_parity(spec):
    """EP-sharded TOPS (one psum of the (G, B, K, K) CC accumulator
    over the subband axis; replicated reference-band subspace) must
    match the single-device fusion='tops' pipeline."""
    from doa_tpu.configs import WidebandSpec
    from doa_tpu.io.synthetic import synth_wideband_ula_iq

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8,
                               norm_spacing=0.5),
        snapshot_size=256, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=128),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.4,
                              fusion="tops"),
        num_max_vals=2)
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=62.0, freq_norm=0.0, bandwidth_norm=0.5),
         SourceSpec(theta_deg=117.0, freq_norm=0.0, bandwidth_norm=0.5)],
        8, 0.5, 16 * 1024, snr_db=12, seed=7, fractional_bw=0.4)
    mesh = make_mesh(spec)
    out = build_sharded_pipeline(cfg, mesh)(x)
    ref = build_pipeline_tpu(cfg)(x)
    P_s = np.asarray(out["spectrum_tops"])
    P_r = np.asarray(ref.spectra["tops"])
    assert P_s.shape == P_r.shape
    np.testing.assert_allclose(P_s, P_r, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        np.sort(np.asarray(out["peak_angles_tops"]), -1),
        np.sort(np.asarray(ref.peak_angles["tops"]), -1), atol=0.05)
    # and the lean streaming shape drops the spectrum without moving
    # the peaks
    lean = build_sharded_pipeline(cfg, mesh, return_spectra=False)(x)
    assert not any(k.startswith("spectrum") for k in lean)
    np.testing.assert_allclose(
        np.asarray(lean["peak_angles_tops"]),
        np.asarray(out["peak_angles_tops"]), atol=1e-5)
