"""Power-iteration signal subspace vs exact eigh: projector parity,
spectrum parity, and end-to-end pipeline parity (the interleaved path)."""

import dataclasses

import numpy as np
import jax.numpy as jnp

import golden
from doa_tpu import PRESETS
from doa_tpu.configs import Estimator
from doa_tpu.cpx import Cpx
from doa_tpu.io import SourceSpec, synth_ula_iq
from doa_tpu.ops import cpx_ops
from doa_tpu.pipeline_tpu import build_pipeline_tpu


def _R(snr=10, seed=3):
    x = golden.synthetic_ula_iq([60.0, 110.0], 8, 0.5, 16384, snr_db=snr,
                                seed=seed)
    return golden.sample_covariance(golden.frame_samples(x, 2048, 0))


def test_signal_subspace_projector_matches_eigh():
    R = _R()
    V = cpx_ops.signal_subspace_embedded(Cpx.from_complex(R), 2, iters=16)
    # orthonormality
    G = np.einsum("bik,bil->bkl", np.asarray(V), np.asarray(V))
    np.testing.assert_allclose(G, np.broadcast_to(np.eye(4), G.shape),
                               atol=1e-3)
    M_pow = cpx_ops.noise_projector_from_signal(V).to_numpy()
    En = golden.noise_subspace(R, 2)
    M_ref = np.einsum("bnm,bkm->bnk", En, En.conj())
    np.testing.assert_allclose(M_pow, M_ref, atol=2e-3)


def test_subspace_denominator_matches_projector():
    R = _R()
    A = golden.ula_steering(np.linspace(0, 180, 721), 8, 0.5).astype(
        np.complex64)
    Ac = Cpx.from_complex(A)
    Rc = Cpx.from_complex(R)
    V = cpx_ops.signal_subspace_embedded(Rc, 2, iters=16)
    den_sub = np.asarray(cpx_ops.music_denominator_subspace(V, Ac))
    M = cpx_ops.noise_projector_cpx(Rc, 2)
    den_ref = np.asarray(cpx_ops.music_denominator_cpx(M, Ac))
    np.testing.assert_allclose(den_sub, den_ref, rtol=5e-3, atol=5e-3)


def test_low_snr_still_converges():
    R = _R(snr=0, seed=9)
    V = cpx_ops.signal_subspace_embedded(Cpx.from_complex(R), 2, iters=24)
    M_pow = cpx_ops.noise_projector_from_signal(V).to_numpy()
    En = golden.noise_subspace(R, 2)
    M_ref = np.einsum("bnm,bkm->bnk", En, En.conj())
    np.testing.assert_allclose(M_pow, M_ref, atol=5e-3)


def test_pipeline_power_matches_eigh_end_to_end():
    base = PRESETS["c2_ula8_2src"]
    cfg_eigh = dataclasses.replace(
        base, subspace_method="eigh",
        estimators=(Estimator.MUSIC, Estimator.ROOT_MUSIC))
    cfg_pow = dataclasses.replace(
        base, subspace_method="power",
        estimators=(Estimator.MUSIC, Estimator.ROOT_MUSIC))
    x = synth_ula_iq(
        [SourceSpec(theta_deg=60.0, freq_norm=0.1),
         SourceSpec(theta_deg=110.0, freq_norm=0.31)],
        8, 0.5, 8 * 2048, snr_db=10, seed=1)
    r_e = build_pipeline_tpu(cfg_eigh)(x)
    r_p = build_pipeline_tpu(cfg_pow)(x)
    np.testing.assert_allclose(
        np.asarray(r_p.peak_angles["music"]),
        np.asarray(r_e.peak_angles["music"]), atol=0.05)
    np.testing.assert_allclose(
        np.asarray(r_p.root_music_angles),
        np.asarray(r_e.root_music_angles), atol=0.1)


def test_pipeline_jacobi_matches_eigh():
    base = PRESETS["c2_ula8_2src"]
    cfg_e = dataclasses.replace(base, subspace_method="eigh")
    cfg_j = dataclasses.replace(base, subspace_method="jacobi")
    x = synth_ula_iq(
        [SourceSpec(theta_deg=60.0, freq_norm=0.1),
         SourceSpec(theta_deg=110.0, freq_norm=0.31)],
        8, 0.5, 8 * 2048, snr_db=10, seed=1)
    r_e = build_pipeline_tpu(cfg_e)(x)
    r_j = build_pipeline_tpu(cfg_j)(x)
    np.testing.assert_allclose(
        np.asarray(r_j.peak_angles["music"]),
        np.asarray(r_e.peak_angles["music"]), atol=0.05)


def test_subspace_guard_flags_and_fixes_pathological_spread():
    """Huge signal-eigenvalue spread + few iterations: the raw power
    path degrades; the guard's residual flags it and the eigh fallback
    restores eigh-path angles (VERDICT r1 item 7)."""
    import dataclasses
    from doa_tpu import PRESETS
    from doa_tpu.io import SourceSpec, synth_ula_iq
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    # amplitude ratio 30 → embedded eigenvalue spread ~900 ≫ the NS
    # envelope at 4 power iterations
    x = synth_ula_iq(
        [SourceSpec(theta_deg=60.0, freq_norm=0.1, amplitude=30.0),
         SourceSpec(theta_deg=110.0, freq_norm=0.31, amplitude=1.0)],
        8, 0.5, 16 * 2048, snr_db=20, seed=6)
    base = dataclasses.replace(PRESETS["c2_ula8_2src"],
                               estimators=(PRESETS["c2_ula8_2src"]
                                           .estimators[0],),
                               power_iters=4)
    eigh_cfg = dataclasses.replace(base, subspace_method="eigh")
    guard_cfg = dataclasses.replace(base, subspace_check=True)

    a_eigh = np.sort(np.asarray(
        build_pipeline_tpu(eigh_cfg)(x).peak_angles["music"]), -1)
    res_guard = build_pipeline_tpu(guard_cfg)(x)
    a_guard = np.sort(np.asarray(res_guard.peak_angles["music"]), -1)
    resid = np.asarray(res_guard.subspace_residual)
    assert resid is not None and resid.shape[0] == a_guard.shape[0]
    # guarded result must agree with eigh even where raw power would not
    np.testing.assert_allclose(a_guard, a_eigh, atol=0.2)


def test_subspace_residual_small_when_converged():
    import dataclasses
    from doa_tpu import PRESETS
    from doa_tpu.io import SourceSpec, synth_ula_iq
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    x = synth_ula_iq([SourceSpec(theta_deg=60.0, freq_norm=0.1),
                      SourceSpec(theta_deg=110.0, freq_norm=0.31)],
                     8, 0.5, 8 * 2048, snr_db=10, seed=1)
    cfg = dataclasses.replace(PRESETS["c2_ula8_2src"],
                              subspace_check=True)
    res = build_pipeline_tpu(cfg)(x)
    assert np.asarray(res.subspace_residual).max() < 0.05


def test_schedule_envelope_source_imbalance():
    """The power-schedule robustness envelope, re-measured for the MGS
    orthonormalization (exp_mgs.py, r2 s4): between orthonormalizations
    the basis conditioning still grows as spread^(2^squarings), but MGS
    deflates sequentially instead of through a near-singular Gram, so
    the default e1 schedule now holds to spread 10⁴ (planted sweep:
    bad-rate 0 at 40 dB) while e4 still silently loses a −20 dB source
    (breaks by spread 100). e1 is also the FASTEST schedule under MGS —
    the speed-vs-robustness dial is gone; squarings remain a documented
    correctness hazard only."""
    from doa_tpu.configs import ArrayGeometry, DoaConfig, GridSpec1D

    def _run(cfg, imb_db, seed=0):
        amp = 10 ** (-imb_db / 20)
        x = synth_ula_iq(
            [SourceSpec(theta_deg=60.0, freq_norm=0.1, amplitude=1.0),
             SourceSpec(theta_deg=110.0, freq_norm=0.3, amplitude=amp)],
            16, 0.5, 16 * 1024, snr_db=10, seed=seed)
        res = build_pipeline_tpu(cfg)(x)
        return np.sort(np.median(np.asarray(res.peak_angles["music"]),
                                 axis=0))

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=1024), num_max_vals=2)
    # default (e1 + MGS) schedule: exact far past the old ≲10 dB
    # envelope. 20 dB is the e2e ceiling of THIS scenario — at 30 dB
    # the weak source's eigenvalue (N·p = 0.016) sits below the noise
    # floor (σ² = 0.1 at 10 dB SNR), an SNR limit, not a subspace one
    # (the planted-spectrum sweep shows the subspace itself holds to
    # spread 10⁴ — exp_mgs.py).
    for imb_db in (5.0, 10.0, 20.0):
        ang = _run(cfg, imb_db)
        assert abs(ang[0] - 60.0) < 0.5, (imb_db, ang)
        assert abs(ang[1] - 110.0) < 0.5, (imb_db, ang)
    # the guard still composes (and stays a no-op here)
    cfg_g = dataclasses.replace(cfg, subspace_check=True)
    ang = _run(cfg_g, 20.0)
    assert abs(ang[0] - 60.0) < 0.5, ang
    assert abs(ang[1] - 110.0) < 0.5, ang
    # squarings remain a correctness hazard: at −20 dB e4's subspace
    # degrades past the 0.5° bound e1 meets (conditioning grows
    # spread^4 between orths; planted sweep: bad-rate 1.0 by spread
    # 100) — pins the doc claim that squarings buy nothing but risk
    cfg_4 = dataclasses.replace(cfg, power_schedule="e4")
    ang = _run(cfg_4, 20.0)
    assert abs(ang[1] - 110.0) > 0.5, ang


def test_escalation_closes_extreme_imbalance():
    """Automatic subspace escalation (default ON, VERDICT r2 item 5):
    at 25 dB source imbalance the cold e1@8 iteration converges to a
    wrong-but-invariant subspace — the invariance residual is BLIND to
    it (~1e-3), but the eigengap detector (γ = min captured Rayleigh /
    noise-floor mean, free from the final apply product) fires and
    drives extra MGS rounds. The default config must match eigh's
    angles per window; disabling escalation must reproduce the old
    failure (pins that the detector does the work, not a larger
    default iteration count)."""
    from doa_tpu.configs import ArrayGeometry, DoaConfig, GridSpec1D

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=1024), num_max_vals=2)
    amp = 10 ** (-25 / 20)
    x = synth_ula_iq(
        [SourceSpec(theta_deg=60.0, freq_norm=0.1, amplitude=1.0),
         SourceSpec(theta_deg=110.0, freq_norm=0.3, amplitude=amp)],
        16, 0.5, 8 * 1024, snr_db=10, seed=100)
    a_def = np.sort(np.asarray(
        build_pipeline_tpu(cfg)(x).peak_angles["music"]), -1)
    a_eigh = np.sort(np.asarray(build_pipeline_tpu(
        dataclasses.replace(cfg, subspace_method="eigh")
    )(x).peak_angles["music"]), -1)
    np.testing.assert_allclose(a_def, a_eigh, atol=0.1)
    a_off = np.sort(np.asarray(build_pipeline_tpu(
        dataclasses.replace(cfg, subspace_escalate=False)
    )(x).peak_angles["music"]), -1)
    err_off = np.abs(a_off - np.array([60.0, 110.0])).max()
    assert err_off > 0.5, (
        f"scenario no longer stresses the envelope (err {err_off})")


def test_warm_start_matches_cold_narrowband():
    """subspace_warm_start on the fused narrowband path: 3 E-applies
    from the capture-mean subspace must match the cold 8-apply result —
    including at 20 dB source imbalance (the mean subspace contains the
    weak direction, so warm refinement cannot lose it)."""
    from doa_tpu.configs import ArrayGeometry, DoaConfig, GridSpec1D

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=1024), num_max_vals=2)
    for imb_db in (0.0, 20.0):
        amp = 10 ** (-imb_db / 20)
        # B = 48 ≥ 32 so the warm start actually engages (it is the
        # package default, so "cold" is the explicit opt-out; an earlier
        # version of this test compared warm to itself at B=16)
        x = synth_ula_iq(
            [SourceSpec(theta_deg=60.0, freq_norm=0.1, amplitude=1.0),
             SourceSpec(theta_deg=110.0, freq_norm=0.3, amplitude=amp)],
            16, 0.5, 48 * 1024, snr_db=10, seed=0).astype(np.complex64)
        cold = build_pipeline_tpu(
            dataclasses.replace(cfg, subspace_warm_start=False))
        warm = build_pipeline_tpu(
            dataclasses.replace(cfg, subspace_warm_start=True))
        assert cold.fast_path and warm.fast_path
        a0 = np.sort(np.asarray(cold(x).peak_angles["music"]), -1)
        a1 = np.sort(np.asarray(warm(x).peak_angles["music"]), -1)
        np.testing.assert_allclose(a1, a0, atol=0.05)
        med = np.median(a1, axis=0)
        assert abs(med[0] - 60.0) < 0.5 and abs(med[1] - 110.0) < 0.5, (
            imb_db, med)


def test_warm_start_abrupt_scene_change():
    """Adversarial nonstationarity (VERDICT r2 item 4): one capture,
    two disjoint scenes — the sources JUMP 60/110 → 30/150 at the
    midpoint, so the capture-mean covariance spans four directions with
    K=2 and every window's warm refinement starts far from its own
    fixed point. Warm must still match cold per window (the init
    affects speed, not the fixed point: each E-apply contracts the
    subspace angle by λ_{K+1}/λ_K, and the mean subspace is never
    orthogonal to a half's true subspace), and each half must estimate
    its OWN scene. Second variant: a source-COUNT change (one source →
    two with K=2) — the weaker stress of a rank-deficient first half."""
    from doa_tpu.configs import ArrayGeometry, DoaConfig, GridSpec1D

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=1024), num_max_vals=2)
    half = 24 * 1024
    xa = synth_ula_iq(
        [SourceSpec(theta_deg=60.0, freq_norm=0.1),
         SourceSpec(theta_deg=110.0, freq_norm=0.3)],
        16, 0.5, half, snr_db=10, seed=3)
    xb = synth_ula_iq(
        [SourceSpec(theta_deg=30.0, freq_norm=0.17),
         SourceSpec(theta_deg=150.0, freq_norm=0.26)],
        16, 0.5, half, snr_db=10, seed=4)
    x = np.concatenate([xa, xb], axis=0).astype(np.complex64)
    warm = build_pipeline_tpu(cfg)
    cold = build_pipeline_tpu(
        dataclasses.replace(cfg, subspace_warm_start=False))
    assert warm.fast_path
    aw = np.sort(np.asarray(warm(x).peak_angles["music"]), -1)
    ac = np.sort(np.asarray(cold(x).peak_angles["music"]), -1)
    np.testing.assert_allclose(aw, ac, atol=0.05)
    B = aw.shape[0]
    np.testing.assert_allclose(np.median(aw[:B // 2], 0),
                               [60.0, 110.0], atol=0.5)
    np.testing.assert_allclose(np.median(aw[B // 2:], 0),
                               [30.0, 150.0], atol=0.5)

    xa1 = synth_ula_iq([SourceSpec(theta_deg=70.0, freq_norm=0.12)],
                       16, 0.5, half, snr_db=10, seed=5)
    xb2 = synth_ula_iq(
        [SourceSpec(theta_deg=40.0, freq_norm=0.21),
         SourceSpec(theta_deg=140.0, freq_norm=0.33)],
        16, 0.5, half, snr_db=10, seed=6)
    x2 = np.concatenate([xa1, xb2], axis=0).astype(np.complex64)
    aw2 = np.asarray(warm(x2).peak_angles["music"])   # [:, 0] strongest
    ac2 = np.asarray(cold(x2).peak_angles["music"])
    h = aw2.shape[0] // 2
    # One-source half under K=2: the SECOND subspace direction is a
    # noise eigendirection — arbitrary under EVERY subspace method
    # (measured: cold-vs-EIGH spurious second peaks differ by up to
    # 77° here), so per-window equality of the spurious peak is not
    # part of the contract. The REAL source and the well-posed half
    # are:
    np.testing.assert_allclose(aw2[:h, 0], ac2[:h, 0], atol=0.05)
    np.testing.assert_allclose(aw2[:h, 0], 70.0, atol=0.5)
    np.testing.assert_allclose(np.sort(aw2[h:], -1),
                               np.sort(ac2[h:], -1), atol=0.05)
    np.testing.assert_allclose(np.median(np.sort(aw2[h:], -1), 0),
                               [40.0, 140.0], atol=0.5)


def test_near_rayleigh_resolution_mgs():
    """The r2-s4 threshold fix: at sep = 2° (~1/3 beamwidth, 16-el ULA)
    the MGS subspace iteration resolves both sources WITHOUT the guard —
    the old NS orthonormalizer collapsed to one direction below 4°
    (docs/ACCURACY.md history note). Pins MUSIC (embedded-real MGS) and
    ESPRIT (complex MGS) together."""
    import dataclasses
    from doa_tpu.configs import ArrayGeometry, DoaConfig, GridSpec1D
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024, num_sources=2,
        estimators=(Estimator.MUSIC, Estimator.ESPRIT),
        grid=GridSpec1D(num_points=1024), num_max_vals=2)
    truth = [89.0, 91.0]
    x = synth_ula_iq([SourceSpec(theta_deg=truth[0], freq_norm=0.1),
                      SourceSpec(theta_deg=truth[1], freq_norm=0.3)],
                     16, 0.5, 16 * 1024, snr_db=10, seed=6)
    res = build_pipeline_tpu(cfg)(x)
    mu = np.sort(np.median(np.asarray(res.peak_angles["music"]), 0))
    es = np.sort(np.median(np.asarray(res.esprit_angles), 0))
    np.testing.assert_allclose(mu, truth, atol=0.3)
    np.testing.assert_allclose(es, truth, atol=0.3)


def test_escalation_skips_source_free_capture():
    """The r3 headline-regression fix (VERDICT r3 weak #1 / missing
    #4): a SOURCE-FREE capture (noise-only R — spectrum monitoring
    before any signal appears) has γ ≈ 1 in EVERY window; the old
    whole-batch trigger escalated forever with nothing to converge to
    (3× bench regression). The γ_max signal floor must gate escalation
    off: results with escalation armed are BIT-identical to
    escalation-off, and the detector view confirms the dominant
    Rayleigh sits in the Wishart noise bulk."""
    import jax.numpy as jnp
    from doa_tpu.cpx import embed_hermitian

    rng = np.random.default_rng(7)
    B, N, S, K = 64, 16, 1024, 2
    x = (rng.standard_normal((B * S, N))
         + 1j * rng.standard_normal((B * S, N))).astype(np.complex64)
    R = golden.sample_covariance(golden.frame_samples(x, S, 0))
    E = embed_hermitian(Cpx.from_complex(R))
    v_off = cpx_ops.signal_subspace_from_E_T(E, K, iters=8,
                                             escalate_extra=0)
    v_on = cpx_ops.signal_subspace_from_E_T(E, K, iters=8,
                                            escalate_extra=40)
    np.testing.assert_array_equal(np.asarray(v_on), np.asarray(v_off))
    # detector view: γ_max under the default signal floor everywhere
    n2 = 2 * N
    tr = jnp.einsum("bii->b", E)[:, None, None] / n2
    W = jnp.einsum("bkn,bnm->bkm", v_off, E / tr)
    _, gmax, _ = cpx_ops.escalation_detector(W, v_off, n2)
    assert float(jnp.max(gmax)) < 2.5, np.asarray(gmax)


def _planted_E(lams_per_window):
    """Common planted-spectrum builder: one shared eigenbasis, one
    eigenvalue vector per window → E f32[B, n2, n2]."""
    n2 = len(lams_per_window[0])
    rng = np.random.default_rng(11)
    Q, _ = np.linalg.qr(rng.standard_normal((n2, n2)).astype(np.float32))
    return jnp.asarray(np.stack(
        [(Q * np.asarray(l, np.float32)) @ Q.T
         for l in lams_per_window]).astype(np.float32))


def test_escalation_pays_per_window_mixed_batch():
    """Pay-per-window escalation (VERDICT r3 weak #2): ONE threshold
    window in a healthy batch escalates alone — the flagged window
    reaches the eigh subspace, every healthy window is BIT-identical
    to the escalation-off result (gathered, untouched, scattered
    back)."""
    import jax.numpy as jnp

    n2, K = 16, 2
    healthy = [100.0, 100.0, 50.0, 50.0] + [0.1] * (n2 - 4)
    bad = [100.0, 100.0, 0.14, 0.14] + [0.1] * (n2 - 4)
    lams = [healthy] * 5 + [bad] + [healthy] * 2
    E = _planted_E(lams)
    v_off = cpx_ops.signal_subspace_from_E_T(E, K, iters=4,
                                             escalate_extra=0)
    v_on = cpx_ops.signal_subspace_from_E_T(E, K, iters=4,
                                            escalate_extra=60)
    on, off = np.asarray(v_on), np.asarray(v_off)
    for b in (0, 1, 2, 3, 4, 6, 7):
        np.testing.assert_array_equal(on[b], off[b])
    # the flagged window's escalated subspace matches exact eigh
    V_exact = np.asarray(cpx_ops.eigh_signal_subspace_from_E(
        E[5:6], K))[0]                                  # (n2, 2K)
    P_ref = V_exact @ V_exact.T
    P_on = on[5].T @ on[5]
    P_off = off[5].T @ off[5]
    assert np.abs(P_on - P_ref).max() < 1e-3
    assert np.abs(P_off - P_ref).max() > 1e-2, (
        "scenario no longer stresses the cold iteration")


def test_escalation_capacity_caps_worst_first():
    """More flagged windows than subspace_escalate_capacity: the worst
    (by detector score) escalate, the overflow stays at the base
    iteration — a documented bound, not silent wrong output."""
    n2, K = 16, 2
    verybad = [100.0, 100.0, 0.11, 0.11] + [0.1] * (n2 - 4)
    mild = [100.0, 100.0, 0.2, 0.2] + [0.1] * (n2 - 4)
    healthy = [100.0, 100.0, 50.0, 50.0] + [0.1] * (n2 - 4)
    E = _planted_E([mild, verybad, healthy, verybad, mild, healthy])
    v_off = cpx_ops.signal_subspace_from_E_T(E, K, iters=8,
                                             escalate_extra=0)
    v_cap = cpx_ops.signal_subspace_from_E_T(E, K, iters=8,
                                             escalate_extra=60,
                                             escalate_capacity=2)
    on, off = np.asarray(v_cap), np.asarray(v_off)
    changed = [b for b in range(6)
               if not np.array_equal(on[b], off[b])]
    assert changed == [1, 3], changed   # the two γ≈1.1 windows win
    # full capacity escalates all four flagged windows
    v_all = np.asarray(cpx_ops.signal_subspace_from_E_T(
        E, K, iters=8, escalate_extra=60))
    changed_all = [b for b in range(6)
                   if not np.array_equal(v_all[b], off[b])]
    assert changed_all == [0, 1, 3, 4], changed_all


def test_squared_schedules_warn_escalation_disarmed():
    """power_schedule e2/e4 silently disarmed the escalation safety
    net (r3 weak #6) — now a config-time warning pins the contract."""
    import warnings

    import pytest
    from doa_tpu.configs import ArrayGeometry, DoaConfig

    with pytest.warns(UserWarning, match="DISARMS subspace_escalate"):
        DoaConfig(geometry=ArrayGeometry(num_elements=8),
                  num_sources=2, power_schedule="e2")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        DoaConfig(geometry=ArrayGeometry(num_elements=8),
                  num_sources=2, power_schedule="e2",
                  subspace_escalate=False)
        DoaConfig(geometry=ArrayGeometry(num_elements=8),
                  num_sources=2, power_schedule="e1")


def test_escalation_stats_counts():
    """Observability (VERDICT r4 weak #3): return_stats reports how
    many windows flagged and how many exceeded the capacity (staying
    unescalated), without changing the subspace output."""
    n2, K = 16, 2
    verybad = [100.0, 100.0, 0.11, 0.11] + [0.1] * (n2 - 4)
    mild = [100.0, 100.0, 0.2, 0.2] + [0.1] * (n2 - 4)
    healthy = [100.0, 100.0, 50.0, 50.0] + [0.1] * (n2 - 4)
    E = _planted_E([mild, verybad, healthy, verybad, mild, healthy])

    v_plain = cpx_ops.signal_subspace_from_E_T(E, K, iters=8,
                                               escalate_extra=60)
    v, (flagged, overflow) = cpx_ops.signal_subspace_from_E_T(
        E, K, iters=8, escalate_extra=60, return_stats=True)
    np.testing.assert_array_equal(np.asarray(v), np.asarray(v_plain))
    assert int(flagged) == 4 and int(overflow) == 0

    _, (flagged_c, overflow_c) = cpx_ops.signal_subspace_from_E_T(
        E, K, iters=8, escalate_extra=60, escalate_capacity=2,
        return_stats=True)
    assert int(flagged_c) == 4 and int(overflow_c) == 2

    E_ok = _planted_E([healthy] * 4)
    _, (f0, o0) = cpx_ops.signal_subspace_from_E_T(
        E_ok, K, iters=8, escalate_extra=60, return_stats=True)
    assert int(f0) == 0 and int(o0) == 0
    # disarmed detector reports zeros (not garbage)
    _, (fd, od) = cpx_ops.signal_subspace_from_E_T(
        E, K, iters=8, escalate_extra=0, return_stats=True)
    assert int(fd) == 0 and int(od) == 0


def test_escalation_counts_in_pipeline_result():
    """DoaResult carries the per-call escalation counters on the power
    paths (zero on a healthy planted capture), and StreamStats
    accumulates them."""
    from doa_tpu.configs import ArrayGeometry, DoaConfig, GridSpec1D

    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8,
                               norm_spacing=0.5),
        snapshot_size=256, num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=256), num_max_vals=2)
    x = synth_ula_iq([SourceSpec(theta_deg=60.0),
                      SourceSpec(theta_deg=110.0, freq_norm=0.3)],
                     8, 0.5, 64 * 256, snr_db=10,
                     seed=1).astype(np.complex64)
    res = build_pipeline_tpu(cfg)(x)
    assert res.escalation_flagged is not None
    assert int(res.escalation_flagged) == 0
    assert int(res.escalation_overflow) == 0

    from doa_tpu.io.stream import StreamingDriver
    drv = StreamingDriver(build_pipeline_tpu(cfg), 32 * 256)
    for i, r in drv.run_iter([x[:32 * 256], x[32 * 256:]]):
        drv._fence_emit(i, r)
    assert drv.stats.windows_escalated == 0
    assert drv.stats.escalation_overflow == 0


def test_small_snapshot_noise_never_escalates():
    """ADVICE r4: at short snapshot counts the Wishart noise-bulk edge
    (1 + sqrt(n2/S))^2 rises past the static 2.5 signal floor (S=64,
    n2=32 -> 2.91), so a fixed floor lets PURE-NOISE captures qualify
    as signal-bearing and spuriously escalate. The config-derived
    floor (escalate_kwargs_for) scales with the edge: noise-only
    results stay BIT-identical to escalation-off at S=64."""
    import jax.numpy as jnp
    from doa_tpu.configs import ArrayGeometry, DoaConfig
    from doa_tpu.cpx import embed_hermitian

    rng = np.random.default_rng(21)
    B, N, S, K = 256, 16, 64, 2
    x = (rng.standard_normal((B * S, N))
         + 1j * rng.standard_normal((B * S, N))).astype(np.complex64)
    R = golden.sample_covariance(golden.frame_samples(x, S, 0))
    E = embed_hermitian(Cpx.from_complex(R))

    cfg = DoaConfig(geometry=ArrayGeometry(num_elements=N),
                    snapshot_size=S, num_sources=K)
    kw = cfg.escalate_kwargs
    assert kw["escalate_signal_floor"] > 4.0   # 1.5 x 2.91 edge
    # headline operating point keeps the measured 2.5 default
    assert DoaConfig(
        geometry=ArrayGeometry(num_elements=N), snapshot_size=1024,
        num_sources=K).escalate_kwargs["escalate_signal_floor"] == 2.5

    v_off = cpx_ops.signal_subspace_from_E_T(E, K, iters=8,
                                             escalate_extra=0)
    v_on, (flagged, _) = cpx_ops.signal_subspace_from_E_T(
        E, K, iters=8, return_stats=True, **kw)
    assert int(flagged) == 0
    np.testing.assert_array_equal(np.asarray(v_on), np.asarray(v_off))

    # the OLD fixed floor would have fired on this pure-noise capture
    # (gamma_max exceeds 2.5 somewhere in a 256-window batch at S=64)
    _, (flagged_fixed, _) = cpx_ops.signal_subspace_from_E_T(
        E, K, iters=8, escalate_extra=40, escalate_signal_floor=2.5,
        return_stats=True)
    assert int(flagged_fixed) > 0, (
        "scenario no longer stresses the fixed floor")
