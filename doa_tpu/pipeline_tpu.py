"""Production pipeline on the split-complex (real-planes) path.

Same structure as doa_tpu.pipeline but with no complex dtype in the
compiled program: inputs are (re, im) f32 planes or interleaved IQ rows,
all ops come from doa_tpu.ops.cpx_ops, eigendecompositions run on real
2N embeddings. Every stage is plain jax.numpy/lax that XLA compiles for
the device it runs on.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from doa_tpu.configs import AvgMethod, DoaConfig, Estimator
from doa_tpu.cpx import Cpx
from doa_tpu.ops import cpx_ops
from doa_tpu.ops.interleaved import (
    cov_embedded, deinterleave, interleave_factor)
from doa_tpu.ops.peaks import find_local_max, find_local_max_2d
from doa_tpu.ops.root_music import root_music_cpx
from doa_tpu.pipeline import DoaResult, _steering_fn, _steering_matrix


def compute_covariances_cpx(x: Cpx, cfg: DoaConfig,
                            correction: Cpx | None = None) -> Cpx:
    """Covariance windows with the calibration correction FOLDED INTO R
    ((c cᴴ) ∘ R — exact, see cpx_ops.apply_correction_to_cov) instead of
    scaling the T×N sample stream: saves two full passes over the input
    at the headline config. Order matters: correction → FB averaging →
    spatial smoothing, matching the reference chain."""
    R = cpx_ops.cov_from_stream_cpx(
        x, cfg.snapshot_size, cfg.overlap, fb_average=False)
    if correction is not None:
        R = cpx_ops.apply_correction_to_cov(R, correction)
    if cfg.avg_method == AvgMethod.FORWARD_BACKWARD:
        R = cpx_ops.forward_backward_cpx(R)
    if cfg.smoothing.enabled:
        R = cpx_ops.spatial_smooth_cpx(R, cfg.smoothing.subarray_size)
    return R


def warm_signal_subspace(E_win, cfg: DoaConfig):
    """Embedded windows E f32[B, 2N, 2N] → (V_emb f32[B, 2N, 2K],
    escalation stats (flagged, overflow) int32 scalars — zeros when the
    detector is disarmed). With cfg.subspace_warm_start and B ≥ 32 every
    window starts from the capture-mean subspace and refines with
    power_iters_warm E-applies (see configs.subspace_warm_start)."""
    if cfg.subspace_warm_start and E_win.shape[0] >= 32:
        Vt_bar = cpx_ops.signal_subspace_from_E_T(
            jnp.mean(E_win, axis=0)[None], cfg.num_sources,
            iters=max(cfg.power_iters, 8), **cfg.escalate_kwargs)
        init = jnp.broadcast_to(
            Vt_bar, (E_win.shape[0],) + Vt_bar.shape[1:])
        Vt, esc_stats = cpx_ops.signal_subspace_from_E_T(
            E_win, cfg.num_sources, iters=cfg.power_iters_warm,
            init=init, return_stats=True, **cfg.escalate_kwargs)
    else:
        Vt, esc_stats = cpx_ops.signal_subspace_from_E_T(
            E_win, cfg.num_sources, iters=cfg.power_iters,
            squarings=cfg.power_squarings, return_stats=True,
            **(cfg.escalate_kwargs if cfg.power_squarings == 0 else {}))
    return jnp.swapaxes(Vt, -1, -2), esc_stats


def build_pipeline_tpu(cfg: DoaConfig, refine_peaks: bool = True,
                       return_covariance: bool = False,
                       donate_inputs: bool = False,
                       return_spectra: bool = True):
    """→ callable(x: complex (T, N) numpy | Cpx, correction) → DoaResult.

    The jitted core signature is all-real:
        run(xr, xi, cr, ci, Ar, Ai) → dict of f32 arrays (+ R planes).

    donate_inputs=True donates the sample planes to the compiled call
    (XLA reuses their HBM for intermediates — the streaming double-
    buffer mode). Callers must then treat each input array as consumed:
    do NOT re-call with the same device buffers (fine for streaming,
    wrong for benchmarks that loop over one resident array).

    return_spectra=False drops the (B, G) pseudospectra from the result
    (peaks only — the production streaming shape).
    """
    A_host, x_rng = _steering_matrix(cfg)
    bs = cfg.beamspace.enabled
    if bs:
        from doa_tpu.ops.beamspace import (
            beamspace_steering, dft_beam_matrix, embed_beam_matrix)
        Bm_host = dft_beam_matrix(
            cfg.geometry.num_elements, cfg.beamspace.num_beams,
            cfg.beamspace.center_deg, cfg.geometry.norm_spacing)
        Bt_host = embed_beam_matrix(Bm_host)      # (2N, 2Nb) tiny const
        A_host = beamspace_steering(A_host, Bm_host)
    A_re = np.ascontiguousarray(A_host.real.astype(np.float32))
    A_im = np.ascontiguousarray(A_host.imag.astype(np.float32))
    want_root = (Estimator.ROOT_MUSIC in cfg.estimators
                 and cfg.geometry.kind == "ula")
    is_2d = cfg.grid2d is not None and cfg.geometry.kind == "ura"

    wb = cfg.wideband.enabled
    wb_cssm = wb and cfg.wideband.fusion == "cssm"
    wb_auto = wb and cfg.wideband.fusion == "cssm_auto"
    wb_tops = wb and cfg.wideband.fusion == "tops"
    wb_key = "tops" if wb_tops else "music"
    if wb:
        from doa_tpu.ops.wideband import (
            dft_matrix, focusing_matrices, wideband_steering_stack)
        W_host = dft_matrix(cfg.wideband.num_subbands)
        # CSSM needs the DFT + the (F, N, N) focusing matrices; the
        # incoherent path needs the DFT + the (F, G, N) per-subband
        # steering stack. Device-resident, passed as jit ARGUMENTS
        # (closed-over device arrays would be constant-folded, which
        # some backends can't fetch, and a 100+MB steering stack must
        # not be baked into the HLO).
        extra_host = (focusing_matrices(cfg) if wb_cssm
                      else wideband_steering_stack(cfg, _steering_fn(cfg)))
        wb_args = tuple(
            jax.device_put(np.ascontiguousarray(p)) for p in (
                W_host.real.astype(np.float32),
                W_host.imag.astype(np.float32),
                extra_host.real.astype(np.float32),
                extra_host.imag.astype(np.float32)))

    def _peaks(P):
        """(values, angles): 1-D → angles (B, k); 2-D → (B, k, 2) az/el."""
        if is_2d:
            g2 = cfg.grid2d
            P2 = P.reshape(P.shape[0], g2.num_az, g2.num_el)
            v, az, el = find_local_max_2d(
                P2, cfg.num_max_vals,
                (g2.az_lo_deg, g2.az_hi_deg), (g2.el_lo_deg, g2.el_hi_deg),
                refine=refine_peaks)
            return v, jnp.stack([az, el], axis=-1)
        v, l = find_local_max(P, cfg.num_max_vals, x_rng[0], x_rng[1],
                              refine=refine_peaks)
        return v, l

    N_el = cfg.geometry.num_elements
    use_power = cfg.subspace_method == "power"
    tp = interleave_factor(N_el)
    # Interleaved-ingest paths (call.interleaved, scan_capture, the
    # zero-copy complex64 route). Narrowband: the Gram of interleaved
    # rows emits E(R) directly (ops.interleaved.cov_embedded) into the
    # warm-start subspace iteration. Wideband: the rows deinterleave
    # into the same channelizer + subband covariances as the planes
    # path.
    import math
    fast_cov = (not wb and not cfg.smoothing.enabled and use_power
                and math.gcd(cfg.snapshot_size, cfg.hop) % tp == 0)
    wb_fast = (wb and cfg.snapshot_size % cfg.wideband.num_subbands == 0
               and cfg.wideband.num_subbands % tp == 0)
    want_unitary = (Estimator.UNITARY_ESPRIT in cfg.estimators
                    and cfg.geometry.kind == "ula")
    need_R = (Estimator.CAPON in cfg.estimators
              or Estimator.BARTLETT in cfg.estimators
              or Estimator.ESPRIT in cfg.estimators
              or want_unitary or want_root or return_covariance)
    scan_mode = cfg.scan_mode

    def _estimate(R, E_win, Ar, Ai):
        """Everything downstream of the covariance stage. Exactly one of
        R (Cpx windows) / E_win (embedded windows) may be None."""
        if bs:
            # Project onto the beam sector HERE (covariance stays
            # element-space, shared with the plain path); every
            # downstream subspace/scan tensor shrinks N → Nb.
            from doa_tpu.ops.beamspace import (beamspace_cov_cpx,
                                               beamspace_embedded)
            if E_win is not None:
                E_win = beamspace_embedded(E_win, Bt_host)
            if R is not None:
                R = beamspace_cov_cpx(R, Bm_host)
        A = Cpx(Ar, Ai)
        spectra, pvals, pangs = {}, {}, {}
        root_angles = None
        M = None

        def _noise_M(M):
            """Complex noise projector (eigh/jacobi path), computed once
            and shared by every projector-based estimator."""
            if M is not None:
                return M
            if cfg.subspace_method == "jacobi":
                from doa_tpu.cpx import embed_hermitian, unembed_hermitian
                from doa_tpu.ops.jacobi import subspace_projector_jacobi
                N_eff = R.shape[-1]
                P_emb = subspace_projector_jacobi(
                    embed_hermitian(R), 2 * (N_eff - cfg.num_sources))
                return unembed_hermitian(P_emb)
            return cpx_ops.noise_projector_cpx(R, cfg.num_sources)
        V_emb = None
        sub_res = None
        esc_stats = (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
        want_mn = Estimator.MIN_NORM in cfg.estimators
        if (use_power
                and (Estimator.MUSIC in cfg.estimators or want_root
                     or want_mn)):
            if E_win is not None:
                V_emb, esc_stats = warm_signal_subspace(E_win, cfg)
            else:
                V_emb, esc_stats = cpx_ops.signal_subspace_embedded(
                    R, cfg.num_sources, iters=cfg.power_iters,
                    squarings=cfg.power_squarings, return_stats=True,
                    **(cfg.escalate_kwargs
                       if cfg.power_squarings == 0 else {}))
            if cfg.subspace_check:
                from doa_tpu.cpx import embed_hermitian
                E_chk = (E_win if E_win is not None
                         else embed_hermitian(R))
                V_emb, sub_res = cpx_ops.guarded_signal_subspace(
                    E_chk, V_emb, cfg.num_sources,
                    tol=cfg.subspace_tol)
        hier = scan_mode == "hierarchical" and use_power
        for est in cfg.estimators:
            if est == Estimator.MUSIC:
                if hier and cfg.geometry.kind == "ula":
                    from doa_tpu.ops.hierarchical import (
                        music_hierarchical_ula)
                    v, l = music_hierarchical_ula(
                        V_emb, A, cfg.num_max_vals,
                        cfg.geometry.norm_spacing,
                        coarse_rng=x_rng,
                        compute_dtype=jnp.dtype(cfg.compute_dtype))
                    pvals[est.value] = v
                    pangs[est.value] = l
                    continue
                if hier and is_2d:
                    from doa_tpu.ops.hierarchical import (
                        music_hierarchical_ura)
                    v, az, el = music_hierarchical_ura(
                        V_emb, A, cfg.num_max_vals, cfg.geometry.shape,
                        cfg.geometry.norm_spacing, cfg.grid2d,
                        compute_dtype=jnp.dtype(cfg.compute_dtype))
                    pvals[est.value] = v
                    pangs[est.value] = jnp.stack([az, el], axis=-1)
                    continue
                if use_power:
                    den = cpx_ops.music_denominator_subspace(
                        V_emb, A,
                        compute_dtype=jnp.dtype(cfg.compute_dtype))
                else:
                    M = _noise_M(M)
                    den = cpx_ops.music_denominator_cpx(
                        M, A, compute_dtype=jnp.dtype(cfg.compute_dtype))
                den = jnp.maximum(den, 0.0)
                P = 1.0 / jnp.maximum(den, jnp.finfo(jnp.float32).tiny)
                P = P / jnp.max(P, axis=-1, keepdims=True)
            elif est == Estimator.MIN_NORM:
                from doa_tpu.ops.min_norm import (
                    min_norm_denominator_cpx,
                    min_norm_denominator_subspace)
                if use_power:
                    den = min_norm_denominator_subspace(
                        V_emb, A,
                        compute_dtype=jnp.dtype(cfg.compute_dtype))
                else:
                    M = _noise_M(M)
                    den = min_norm_denominator_cpx(
                        M, A, compute_dtype=jnp.dtype(cfg.compute_dtype))
                P = 1.0 / jnp.maximum(den, jnp.finfo(jnp.float32).tiny)
                P = P / jnp.max(P, axis=-1, keepdims=True)
            elif est == Estimator.CAPON:
                if (scan_mode == "hierarchical"
                        and cfg.geometry.kind == "ula"):
                    from doa_tpu.ops.hierarchical import (
                        capon_hierarchical_ula)
                    v, l = capon_hierarchical_ula(
                        R, A, cfg.num_max_vals,
                        cfg.geometry.norm_spacing,
                        diag_load=cfg.capon_diag_load,
                        coarse_rng=x_rng)
                    pvals[est.value] = v
                    pangs[est.value] = l
                    continue
                if scan_mode == "hierarchical" and is_2d:
                    from doa_tpu.ops.hierarchical import (
                        capon_hierarchical_ura)
                    v, az, el = capon_hierarchical_ura(
                        R, A, cfg.num_max_vals, cfg.geometry.shape,
                        cfg.geometry.norm_spacing, cfg.grid2d,
                        diag_load=cfg.capon_diag_load)
                    pvals[est.value] = v
                    pangs[est.value] = jnp.stack([az, el], axis=-1)
                    continue
                P = cpx_ops.capon_spectrum_cpx(
                    R, A, diag_load=cfg.capon_diag_load)
            elif est == Estimator.BARTLETT:
                P = cpx_ops.bartlett_spectrum_cpx(R, A)
            elif est in (Estimator.ROOT_MUSIC, Estimator.ESPRIT,
                         Estimator.UNITARY_ESPRIT):
                continue  # grid-free; handled after the scan loop
            else:  # pragma: no cover — configs validate estimators
                raise ValueError(f"unknown estimator {est}")
            v, l = _peaks(P)
            if return_spectra:
                spectra[est.value] = P
            pvals[est.value] = v
            pangs[est.value] = l
        if want_root:
            nproj = (cpx_ops.noise_projector_from_signal(V_emb)
                     if use_power else None)
            root_angles = root_music_cpx(
                R, cfg.num_sources, cfg.geometry.norm_spacing,
                noise_proj=nproj)
        esprit_angles = None
        if (Estimator.ESPRIT in cfg.estimators
                and cfg.geometry.kind == "ula"):
            from doa_tpu.ops.esprit import esprit_cpx
            esprit_angles = esprit_cpx(
                R, cfg.num_sources, cfg.geometry.norm_spacing)
        elif (Estimator.ESPRIT in cfg.estimators
                and cfg.geometry.kind == "ura"):
            from doa_tpu.ops.esprit import esprit_2d_cpx
            az, el = esprit_2d_cpx(
                R, cfg.num_sources, cfg.geometry.norm_spacing,
                cfg.geometry.shape)
            esprit_angles = jnp.stack([az, el], axis=-1)  # (B, K, 2)
        unitary_angles = None
        if want_unitary:
            from doa_tpu.ops.esprit import unitary_esprit_cpx
            unitary_angles = unitary_esprit_cpx(
                R, cfg.num_sources, cfg.geometry.norm_spacing)
        return dict(
            spectra=spectra, peak_values=pvals, peak_angles=pangs,
            root_music_angles=root_angles,
            esprit_angles=esprit_angles,
            unitary_esprit_angles=unitary_angles,
            covariance=((R.re, R.im) if return_covariance else None),
            subspace_residual=sub_res,
            escalation_flagged=esc_stats[0],
            escalation_overflow=esc_stats[1],
        )

    def run(xr, xi, cr, ci, Ar, Ai, *wb_extra):
        if wb_cssm or wb_auto:
            # Coherent fusion: focused covariance → the full narrowband
            # estimator suite (incl. FB averaging, smoothing, Capon and
            # the grid-free root-MUSIC/ESPRIT — wideband grid-free DoA).
            # "cssm_auto" focuses at RUNTIME coarse estimates (two-pass,
            # on-device Newton-Schulz polar); "cssm" at the static set.
            x = Cpx(xr, xi) * Cpx(cr[None, :], ci[None, :])
            if wb_auto:
                from doa_tpu.ops.wideband import (
                    auto_focused_covariance_cpx)
                Wr, Wi, Asr, Asi = wb_extra
                R = auto_focused_covariance_cpx(
                    x, Cpx(Asr, Asi), Cpx(Wr, Wi), cfg)
            else:
                from doa_tpu.ops.wideband import cssm_covariance_cpx
                Wr, Wi, Tr, Ti = wb_extra
                R = cssm_covariance_cpx(x, Cpx(Wr, Wi), Cpx(Tr, Ti),
                                        cfg)
            if cfg.avg_method == AvgMethod.FORWARD_BACKWARD:
                R = cpx_ops.forward_backward_cpx(R)
            if cfg.smoothing.enabled:
                R = cpx_ops.spatial_smooth_cpx(
                    R, cfg.smoothing.subarray_size)
            return _estimate(R, None, Ar, Ai)
        if wb:
            from doa_tpu.ops.wideband import (
                wideband_music_cpx, wideband_music_hierarchical_cpx)
            spectra, pvals, pangs = {}, {}, {}
            x = Cpx(xr, xi) * Cpx(cr[None, :], ci[None, :])
            Wr, Wi, Asr, Asi = wb_extra
            if wb_tops:
                from doa_tpu.ops.tops import wideband_tops_cpx
                P = wideband_tops_cpx(x, Cpx(Asr, Asi), Cpx(Wr, Wi),
                                      cfg)
                v, l = _peaks(P)
                spectra[wb_key] = P
            elif scan_mode == "hierarchical" and use_power:
                v, l = wideband_music_hierarchical_cpx(
                    x, Cpx(Asr, Asi), Cpx(Wr, Wi), cfg,
                    cfg.num_max_vals, x_rng=x_rng,
                    grid2d=cfg.grid2d if is_2d else None)
            else:
                P = wideband_music_cpx(x, Cpx(Asr, Asi), Cpx(Wr, Wi),
                                       cfg)
                v, l = _peaks(P)
                spectra[wb_key] = P
            pvals[wb_key] = v
            pangs[wb_key] = l
            return dict(spectra=spectra, peak_values=pvals,
                        peak_angles=pangs, root_music_angles=None,
                        esprit_angles=None, covariance=None,
                        subspace_residual=None)
        R = compute_covariances_cpx(Cpx(xr, xi), cfg,
                                    correction=Cpx(cr, ci))
        if fast_cov:
            # planes input on the fast path: embed and join the
            # interleaved path's warm-start subspace stage
            from doa_tpu.cpx import embed_hermitian
            return _estimate(R if need_R else None, embed_hermitian(R),
                             Ar, Ai)
        return _estimate(R, None, Ar, Ai)

    def run_ilv(xil, cr, ci, Ar, Ai, *wb_extra):
        """Interleaved-ingest entry (fast paths only): xil is the raw
        c64 capture buffer viewed as [T/TPACK, 2N·TPACK] (f32, or a
        bf16/int8 ingest buffer) — no host preprocessing."""
        if wb:
            x = deinterleave(xil, N_el)
            return run_planes(x.re, x.im, cr, ci, Ar, Ai, *wb_extra)
        R, E_win = cov_embedded(
            xil, cr, ci, N=N_el, snapshot_size=cfg.snapshot_size,
            overlap=cfg.overlap,
            fb=cfg.avg_method == AvgMethod.FORWARD_BACKWARD,
            compute_dtype=jnp.dtype(cfg.cov_dtype))
        return _estimate(R if need_R else None, E_win, Ar, Ai)

    from doa_tpu.cpx import f32_matmuls
    run_planes = run
    run_ilv_py = run_ilv
    run = jax.jit(f32_matmuls(run),
                  donate_argnums=(0, 1) if donate_inputs else ())
    run_ilv = jax.jit(f32_matmuls(run_ilv),
                      donate_argnums=(0,) if donate_inputs else ())

    # Carry for continuous framing across blocks: window starts are
    # global hop-multiples, so the earliest window spanning a block
    # boundary starts hop·ceil(overlap/hop) samples before it — the
    # carry is THAT long (== overlap only when hop | overlap; overlap=0
    # → no carry).
    _carry_samples = cfg.hop * -(-cfg.overlap // cfg.hop)

    def _scan_capture_core(blks, cr, ci, Ar, Ai, *wb_extra):
        """blks: f32[M, rows, width] → stacked peak outputs, one
        lax.scan step per block: the whole capture is ONE device
        program (no per-block dispatch at all — the streaming analog
        of pipelined fencing, SURVEY §7.2 M4). The first block's carry
        is zeros, so its first `scan_capture.prefix_windows` windows
        reference a zero prefix (callers drop them — exact from the
        first real window on)."""
        carry_rows = _carry_samples // tp

        def body(carry, blk):
            x = blk if carry_rows == 0 else jnp.concatenate(
                [carry, blk], axis=0)
            out = run_ilv_py(x, cr, ci, Ar, Ai, *wb_extra)
            keep = {k: out[k] for k in
                    ("peak_values", "peak_angles", "root_music_angles",
                     "esprit_angles", "unitary_esprit_angles")
                    if out.get(k) is not None}
            new_carry = carry if carry_rows == 0 else x[-carry_rows:]
            return new_carry, keep

        init = jnp.zeros((carry_rows, blks.shape[-1]), jnp.float32)
        return jax.lax.scan(body, init, blks)[1]

    scan_capture_jit = jax.jit(
        f32_matmuls(_scan_capture_core),
        donate_argnums=(0,) if donate_inputs else ())

    def scan_capture(blocks, correction=None):
        """blocks: f32[M, T_blk/TPACK, 2N·TPACK] pre-staged interleaved
        blocks (device or host) → dict of stacked (M, B_blk, ...) peak
        results. Requires an interleaved path, TPACK | carry, and
        hop | T_blk (so each block consumes a whole number of hops and
        the carry length is invariant — continuous-stream framing).
        Wideband additionally needs F | overlap (subband-domain framing
        must align with the input-domain carry)."""
        if not (fast_cov or wb_fast):
            raise ValueError("scan_capture requires an interleaved "
                             "path (power subspace, no smoothing)")
        if wb_fast and cfg.overlap % cfg.wideband.num_subbands:
            raise ValueError("wideband scan_capture needs subbands | "
                             "overlap (else the effective subband hop "
                             "misaligns with the input-domain carry)")
        if _carry_samples % tp:
            raise ValueError(f"scan_capture needs TPACK ({tp}) | carry "
                             f"({_carry_samples})")
        blocks = jnp.asarray(blocks)
        T_blk = blocks.shape[1] * tp
        if T_blk % cfg.hop:
            raise ValueError(f"scan_capture needs hop ({cfg.hop}) | "
                             f"block samples ({T_blk})")
        cr, ci = _correction_planes(cfg.geometry.num_elements,
                                    correction)
        return scan_capture_jit(blocks, cr, ci, A_re_d, A_im_d,
                                *(wb_args if wb_fast else ()))

    # windows of block 0 that reference the zero prefix (drop them)
    scan_capture.prefix_windows = _carry_samples // cfg.hop

    A_re_d = jax.device_put(A_re)
    A_im_d = jax.device_put(A_im)

    def _correction_planes(N, correction):
        if correction is None:
            return jnp.ones((N,), jnp.float32), jnp.zeros((N,), jnp.float32)
        if isinstance(correction, Cpx):
            return correction.re, correction.im
        c = np.asarray(correction)
        return (jnp.asarray(c.real.astype(np.float32)),
                jnp.asarray(c.imag.astype(np.float32)))

    def call(x, correction=None) -> DoaResult:
        N = cfg.geometry.num_elements
        cr, ci = _correction_planes(N, correction)
        if ((fast_cov or wb_fast) and isinstance(x, np.ndarray)
                and x.dtype == np.complex64):
            # Zero-copy ingest: C-ordered c64 (T, N) IS the interleaved
            # f32 layout — no split_c64, no device-side conversion.
            T = (x.shape[0] // tp) * tp
            xil = np.ascontiguousarray(x[:T]).view(np.float32).reshape(
                T // tp, 2 * N * tp)
            xil_d = jnp.asarray(xil)
            if fast_cov and cfg.cov_dtype == "int8":
                # fast_int8 preset through the ordinary entry: quantize
                # on device (one pass); resident int8 buffers enter via
                # call.interleaved and skip this
                from doa_tpu.io.native import quantize_interleaved_int8
                xil_d = quantize_interleaved_int8(xil_d)[0]
            out = run_ilv(xil_d, cr, ci, A_re_d, A_im_d,
                          *(wb_args if wb_fast else ()))
            return DoaResult(**out)
        if isinstance(x, Cpx):
            xr, xi = x.re, x.im
        else:
            from doa_tpu.io.native import split_c64
            re, im = split_c64(np.asarray(x))  # native one-pass deinterleave
            xr, xi = jnp.asarray(re), jnp.asarray(im)
        extra = wb_args if wb else ()
        out = run(xr, xi, cr, ci, A_re_d, A_im_d, *extra)
        return DoaResult(**out)

    def call_interleaved(xil, correction=None) -> DoaResult:
        """xil: [T/TPACK, 2N·TPACK] (device or host; f32, bf16 or int8)
        — production ingest entry; requires an interleaved path
        (raises otherwise)."""
        if not (fast_cov or wb_fast):
            raise ValueError("interleaved entry requires an "
                             "interleaved path (power subspace, no "
                             "smoothing)")
        cr, ci = _correction_planes(cfg.geometry.num_elements, correction)
        xil = jnp.asarray(xil)
        if (fast_cov and cfg.cov_dtype == "int8"
                and jnp.issubdtype(xil.dtype, jnp.floating)):
            # float buffer into the int8 mode: quantize on device;
            # pre-quantized int8 buffers pass through untouched
            from doa_tpu.io.native import quantize_interleaved_int8
            xil = quantize_interleaved_int8(xil)[0]
        return DoaResult(**run_ilv(xil, cr, ci,
                                   A_re_d, A_im_d,
                                   *(wb_args if wb_fast else ())))

    call.jitted = run
    call.jitted_ilv = run_ilv if (fast_cov or wb_fast) else None
    call.wb_args = wb_args if wb else None
    call.wb_fast = wb_fast
    call.interleaved = call_interleaved
    call.scan_capture = scan_capture
    call.fast_path = fast_cov
    call.steering_planes = (A_re_d, A_im_d)
    call.config = cfg
    return call
