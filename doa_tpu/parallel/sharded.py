"""Sharded DoA pipeline under `jax.shard_map` (SURVEY §7.2 M5).

Runs entirely on the split-complex (re/im planes) path and uses the same
ops as the single-device pipeline (power-iteration subspace, stacked
Grams); XLA hands the collectives to the device's communication library
(NCCL over NVLink on a GPU host).

Layout (mesh axes from doa_tpu.parallel.mesh):

    x planes f32[T, N]   → P("snap", None)   time axis across devices
    A planes f32[G, N]   → P("grid", None)   steering grid across devices
    out peaks            → P("snap", None)   window batch follows time

Per device: halo-exchange `overlap` samples from the right time-neighbor
(`lax.ppermute`), chunk-Gram covariance for the windows that START in the
local block, subspace iteration, scan the LOCAL angle block, `all_gather`
the spectrum row over "grid" for normalization + peak extraction. Windows
at the global tail whose halo wrapped past the end are invalid; callers
slice to `num_valid_windows(T, cfg)`.
"""

from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from doa_tpu.configs import AvgMethod, DoaConfig, Estimator
from doa_tpu.cpx import f32_matmuls, Cpx
from doa_tpu.ops import cpx_ops
from doa_tpu.ops.peaks import find_local_max
from doa_tpu.parallel.mesh import GRID_AXIS, SNAP_AXIS
from doa_tpu.pipeline import _steering_matrix


def num_valid_windows(T: int, cfg: DoaConfig) -> int:
    """Global window count for a T-sample capture (windows fully inside)."""
    S, hop = cfg.snapshot_size, cfg.hop
    return 0 if T < S else (T - S) // hop + 1


def halo_exchange(plane, overlap: int, axis_name: str):
    """Per-shard (T_loc, ...) block → (T_loc + overlap, ...) with the
    right neighbor's first `overlap` rows appended (lax.ppermute; call
    inside shard_map on the time axis). The last shard's halo is zero:
    its tail windows are invalid by construction (num_valid_windows)."""
    n = jax.lax.axis_size(axis_name)
    if overlap == 0 or n == 1:
        return plane
    halo = jax.lax.ppermute(plane[:overlap], axis_name,
                            [(i + 1, i) for i in range(n - 1)])
    return jnp.concatenate([plane, halo], axis=0)


def _local_peaks_merge_1d(P_loc, num_max_vals: int, x_rng, refine: bool):
    """O(k) tensor-parallel peak extraction (replaces the O(B·G)
    spectrum all_gather): one-column spectrum halos from the grid
    neighbors make every LOCAL bin's peak test exact, peaks + sub-bin
    refinement run on the local block with the global angle mapping,
    and only (value, angle) candidates — O(k) per device — cross the
    interconnect, merged by an iterative-argmax top-k. Matches dense
    find_local_max semantics including the pad-with-best-peak /
    global-argmax fallbacks.

    → (values, angles, global_row_max) — values normalized by the
    global row max (pmax, O(B) comm)."""
    from doa_tpu.ops.peaks import _refine_frac, _topk_lastaxis

    k = num_max_vals
    n = jax.lax.axis_size(GRID_AXIS)
    me = jax.lax.axis_index(GRID_AXIS)
    B, G_loc = P_loc.shape
    G = G_loc * n
    dx = (x_rng[1] - x_rng[0]) / (G - 1)
    inf = jnp.float32(jnp.inf)

    if n == 1:
        P_ext = jnp.pad(P_loc, ((0, 0), (1, 1)), constant_values=jnp.inf)
    else:
        left = jax.lax.ppermute(                      # my left halo =
            P_loc[:, -1:], GRID_AXIS,                 # left nbr's last col
            [(i, i + 1) for i in range(n - 1)])
        right = jax.lax.ppermute(
            P_loc[:, :1], GRID_AXIS,
            [(i + 1, i) for i in range(n - 1)])
        left = jnp.where(me == 0, inf, left)          # global edge bins
        right = jnp.where(me == n - 1, inf, right)    # are never peaks
        P_ext = jnp.concatenate([left, P_loc, right], axis=1)

    neg_inf = jnp.float32(-jnp.inf)
    is_max = jnp.zeros_like(P_ext, dtype=bool)
    is_max = is_max.at[:, 1:-1].set(
        (P_ext[:, 1:-1] > P_ext[:, :-2])
        & (P_ext[:, 1:-1] >= P_ext[:, 2:]))
    masked = jnp.where(is_max, P_ext, neg_inf)
    vals, idx = _topk_lastaxis(masked, k)             # extended coords
    x_min_ext = x_rng[0] + (me * G_loc - 1) * dx
    if refine:
        locs = x_min_ext + _refine_frac(P_ext, idx, G_loc + 2) * dx
    else:
        locs = x_min_ext + idx.astype(P_ext.dtype) * dx

    rmax_i = jnp.argmax(P_loc, axis=-1, keepdims=True)
    rmax_v = jnp.take_along_axis(P_loc, rmax_i, axis=-1)  # (B, 1)
    rmax_l = x_rng[0] + (me * G_loc + rmax_i).astype(P_loc.dtype) * dx

    # O(k) exchange: k candidates + the row-max per device.
    all_v = jax.lax.all_gather(vals, GRID_AXIS, axis=1, tiled=True)
    all_l = jax.lax.all_gather(locs, GRID_AXIS, axis=1, tiled=True)
    all_rv = jax.lax.all_gather(rmax_v, GRID_AXIS, axis=1, tiled=True)
    all_rl = jax.lax.all_gather(rmax_l, GRID_AXIS, axis=1, tiled=True)

    mv, mpos = _topk_lastaxis(all_v, k)
    ml = jnp.take_along_axis(all_l, mpos, axis=-1)
    gpos = jnp.argmax(all_rv, axis=-1, keepdims=True)
    gmax = jnp.take_along_axis(all_rv, gpos, axis=-1)      # (B, 1)
    gloc = jnp.take_along_axis(all_rl, gpos, axis=-1)
    have_any = jnp.isfinite(mv[:, 0:1])
    best_v = jnp.where(have_any, mv[:, 0:1], gmax)
    best_l = jnp.where(have_any, ml[:, 0:1], gloc)
    valid = jnp.isfinite(mv)
    v = jnp.where(valid, mv, best_v)
    l = jnp.where(valid, ml, best_l)
    return v / gmax, l, gmax


def _local_peaks_merge_2d(P_loc, num_max_vals: int, g2, refine: bool):
    """O(k) tensor-parallel 2-D peak extraction (VERDICT r4 missing
    #4): the az-major flattened grid is sharded in whole-az-row blocks
    (requires n_grid | num_az), so 2-D peak neighborhoods cross shard
    boundaries only along az — ONE az-row halo from each grid neighbor
    (comm (B, Ge) per call, independent of G — vs the (B, G) spectrum
    all_gather this replaces: 135 MB/call at the c5 shape) makes every
    local bin's 4-neighbor test exact. Local top-k candidates +
    per-device row maxima merge exactly like the 1-D version; az
    refinement reads the halo rows, el refinement is shard-local.

    P_loc: f32[B, Ga_loc·Ge] (local az-row block, flattened az-major)
    → (values/gmax (B, k), angles (B, k, 2) az/el, gmax (B, 1))."""
    from doa_tpu.ops.peaks import _topk_lastaxis

    k = num_max_vals
    n = jax.lax.axis_size(GRID_AXIS)
    me = jax.lax.axis_index(GRID_AXIS)
    B, Gl = P_loc.shape
    Ge = g2.num_el
    Ga = g2.num_az
    Ga_loc = Gl // Ge
    P3 = P_loc.reshape(B, Ga_loc, Ge)
    inf = jnp.float32(jnp.inf)
    neg_inf = jnp.float32(-jnp.inf)

    if n == 1:
        up = jnp.full((B, 1, Ge), inf, P3.dtype)
        dn = up
    else:
        up = jax.lax.ppermute(                    # my top halo = left
            P3[:, -1:, :], GRID_AXIS,             # nbr's last az row
            [(i, i + 1) for i in range(n - 1)])
        dn = jax.lax.ppermute(
            P3[:, :1, :], GRID_AXIS,
            [(i + 1, i) for i in range(n - 1)])
        up = jnp.where(me == 0, inf, up)          # global az edges are
        dn = jnp.where(me == n - 1, inf, dn)      # never peaks (P > inf
    Pe = jnp.concatenate([up, P3, dn], axis=1)    # is False)

    mid = P3[:, :, 1:-1]
    core = ((mid > Pe[:, :-2, 1:-1]) & (mid >= Pe[:, 2:, 1:-1])
            & (mid > P3[:, :, :-2]) & (mid >= P3[:, :, 2:]))
    is_max = jnp.zeros_like(P3, dtype=bool)
    is_max = is_max.at[:, :, 1:-1].set(core)
    masked = jnp.where(is_max, P3, neg_inf).reshape(B, Gl)
    vals, idx = _topk_lastaxis(masked, k)         # local flat coords
    ra = idx // Ge
    ce = idx - ra * Ge

    if refine:
        # separable reciprocal-space parabolas; the az profile's ±1
        # rows come from the extended block (halo rows included)
        tiny = jnp.finfo(P3.dtype).tiny
        q = lambda v: 1.0 / jnp.maximum(v, tiny)  # noqa: E731
        flat_e = Pe.reshape(B, (Ga_loc + 2) * Ge)
        pick_e = lambda r, c: jnp.take_along_axis(  # noqa: E731
            flat_e, r * Ge + c, axis=-1)
        q0 = q(pick_e(ra + 1, ce))
        qm = q(pick_e(ra, ce))
        qp = q(pick_e(ra + 2, ce))
        dd = qm - 2.0 * q0 + qp
        da_ = jnp.where(jnp.abs(dd) > 0, 0.5 * (qm - qp) / dd, 0.0)
        ga = me * Ga_loc + ra                     # global az row
        da_ = jnp.where((ga > 0) & (ga < Ga - 1),
                        jnp.clip(da_, -0.5, 0.5), 0.0)
        flat_l = P3.reshape(B, Gl)
        pick_l = lambda r, c: jnp.take_along_axis(  # noqa: E731
            flat_l, r * Ge + c, axis=-1)
        qm = q(pick_l(ra, jnp.maximum(ce - 1, 0)))
        qp = q(pick_l(ra, jnp.minimum(ce + 1, Ge - 1)))
        dd = qm - 2.0 * q0 + qp
        de_ = jnp.where(jnp.abs(dd) > 0, 0.5 * (qm - qp) / dd, 0.0)
        de_ = jnp.where((ce > 0) & (ce < Ge - 1),
                        jnp.clip(de_, -0.5, 0.5), 0.0)
        fa = (me * Ga_loc + ra).astype(P3.dtype) + da_
        fe = ce.astype(P3.dtype) + de_
    else:
        fa = (me * Ga_loc + ra).astype(P3.dtype)
        fe = ce.astype(P3.dtype)
    daz = (g2.az_hi_deg - g2.az_lo_deg) / (Ga - 1)
    dele = (g2.el_hi_deg - g2.el_lo_deg) / (Ge - 1)
    az = g2.az_lo_deg + fa * daz
    el = g2.el_lo_deg + fe * dele

    # per-device row max (value + refined-free location) for the
    # global normalization and the no-peak fallback
    flat = P_loc
    rmax_i = jnp.argmax(flat, axis=-1, keepdims=True)
    rmax_v = jnp.take_along_axis(flat, rmax_i, axis=-1)   # (B, 1)
    r_ra = rmax_i // Ge
    r_ce = rmax_i - r_ra * Ge
    rmax_az = g2.az_lo_deg + (me * Ga_loc + r_ra).astype(
        P3.dtype) * daz
    rmax_el = g2.el_lo_deg + r_ce.astype(P3.dtype) * dele

    # O(k) exchange: k candidates + the row max per device
    cat = lambda t: jax.lax.all_gather(  # noqa: E731
        t, GRID_AXIS, axis=1, tiled=True)
    all_v, all_az, all_el = cat(vals), cat(az), cat(el)
    all_rv, all_raz, all_rel = cat(rmax_v), cat(rmax_az), cat(rmax_el)

    mv, mpos = _topk_lastaxis(all_v, k)
    maz = jnp.take_along_axis(all_az, mpos, axis=-1)
    mel = jnp.take_along_axis(all_el, mpos, axis=-1)
    gpos = jnp.argmax(all_rv, axis=-1, keepdims=True)
    gmax = jnp.take_along_axis(all_rv, gpos, axis=-1)     # (B, 1)
    gaz = jnp.take_along_axis(all_raz, gpos, axis=-1)
    gel = jnp.take_along_axis(all_rel, gpos, axis=-1)
    have_any = jnp.isfinite(mv[:, 0:1])
    best_v = jnp.where(have_any, mv[:, 0:1], gmax)
    best_az = jnp.where(have_any, maz[:, 0:1], gaz)
    best_el = jnp.where(have_any, mel[:, 0:1], gel)
    valid = jnp.isfinite(mv)
    v = jnp.where(valid, mv, best_v)
    az_o = jnp.where(valid, maz, best_az)
    el_o = jnp.where(valid, mel, best_el)
    return (v / gmax, jnp.stack([az_o, el_o], axis=-1), gmax)


def build_sharded_pipeline(cfg: DoaConfig, mesh: Mesh,
                           refine_peaks: bool = True,
                           return_spectra: bool = True):
    """→ callable(x: complex (T, N) | Cpx, correction) → dict of sharded
    outputs. T must be divisible by (n_snap * hop).

    return_spectra=False drops the (B, G) spectrum outputs (peaks only
    — the production streaming shape, mirroring build_pipeline_tpu).

    Wideband configs use the EXPERT-PARALLEL layout (SURVEY §2.5 EP):
    the time axis is snap-sharded as usual, each device channelizes its
    local block, the SUBBAND axis is sharded over the mesh's second
    axis (each device owns F/n_grid subbands' covariance → subspace →
    spectrum chain against its slice of the per-subband steering
    stack), and the incoherent fusion is one psum over that axis —
    comm volume O(B·G) per device, independent of F."""
    if cfg.wideband.enabled:
        return _build_sharded_wideband(cfg, mesh, refine_peaks,
                                       return_spectra)
    A_host, x_rng = _steering_matrix(cfg)
    bs = cfg.beamspace.enabled
    if bs:
        # Beamspace composes with TP by REPLICATING the tiny (N, Nb)
        # beam matrix and sharding the PROJECTED steering grid: the
        # covariance stays element-space per shard (halo/psum layout
        # unchanged), each device projects R → BᴴRB once (a constant-
        # folded N×Nb einsum pair), and every downstream subspace/scan
        # tensor shrinks N → Nb — TP shards exactly the axis beamspace
        # thins, so the two compose multiplicatively.
        from doa_tpu.ops.beamspace import (beamspace_steering,
                                           dft_beam_matrix)
        Bm_host = dft_beam_matrix(
            cfg.geometry.num_elements, cfg.beamspace.num_beams,
            cfg.beamspace.center_deg, cfg.geometry.norm_spacing)
        A_host = beamspace_steering(A_host, Bm_host)
    S, hop, overlap = cfg.snapshot_size, cfg.hop, cfg.overlap
    fb = cfg.avg_method == AvgMethod.FORWARD_BACKWARD
    n_grid = mesh.shape[GRID_AXIS]
    G = A_host.shape[0]
    if G % n_grid:
        raise ValueError(f"grid size {G} not divisible by n_grid {n_grid}")
    use_power = cfg.subspace_method == "power"
    is_2d = cfg.grid2d is not None and cfg.geometry.kind == "ura"
    # 2-D O(k) merge needs whole az rows per grid shard (n_grid | num_az)
    use_2d_merge = (is_2d and n_grid > 0
                    and (G // n_grid) % cfg.grid2d.num_el == 0)
    # Interleaved-ingest path: the same composition as the single-
    # device pipeline's, per device — interleaved rows in (the halo
    # exchange runs on rows), the embedded-covariance Gram, warm-start
    # subspaces from the psum'd GLOBAL capture mean, and the scan
    # feeding the O(k) peak merge.
    import math as _math
    from doa_tpu.ops.interleaved import interleave_factor
    N_el = cfg.geometry.num_elements
    tp = interleave_factor(N_el)
    fast = (use_power and not bs and not cfg.smoothing.enabled
            and _math.gcd(S, hop) % tp == 0)

    def _peaks(P_full):
        """Peaks on the gathered spectrum row: 1-D angles or (az, el)."""
        if is_2d:
            from doa_tpu.ops.peaks import find_local_max_2d

            g2 = cfg.grid2d
            P2 = P_full.reshape(P_full.shape[0], g2.num_az, g2.num_el)
            v, az, el = find_local_max_2d(
                P2, cfg.num_max_vals,
                (g2.az_lo_deg, g2.az_hi_deg),
                (g2.el_lo_deg, g2.el_hi_deg), refine=refine_peaks)
            return v, jnp.stack([az, el], axis=-1)
        return find_local_max(P_full, cfg.num_max_vals, x_rng[0],
                              x_rng[1], refine=refine_peaks)

    def _merge_peaks(out, est, P_loc):
        """Shared peak extraction + merge: 1-D → O(k) column-halo
        merge; 2-D → O(k) az-row-halo merge when shard boundaries
        align with az rows, full-spectrum gather otherwise. The
        spectrum output stays GRID-sharded on the merge paths (and is
        dropped entirely under return_spectra=False)."""
        if is_2d and use_2d_merge:
            v, l, gmax = _local_peaks_merge_2d(
                P_loc, cfg.num_max_vals, cfg.grid2d, refine_peaks)
            if return_spectra:
                out[f"spectrum_{est.value}"] = P_loc / gmax
        elif is_2d:
            P_full = jax.lax.all_gather(P_loc, GRID_AXIS, axis=1,
                                        tiled=True)
            P_full = P_full / jnp.max(P_full, axis=-1, keepdims=True)
            v, l = _peaks(P_full)
            if return_spectra:
                out[f"spectrum_{est.value}"] = P_full
        else:
            v, l, gmax = _local_peaks_merge_1d(
                P_loc, cfg.num_max_vals, x_rng, refine_peaks)
            if return_spectra:
                out[f"spectrum_{est.value}"] = P_loc / gmax
        out[f"peak_values_{est.value}"] = v
        out[f"peak_angles_{est.value}"] = l

    def shard_fn(xr, xi, cr, ci, Ar, Ai):
        x = Cpx(halo_exchange(xr, overlap, SNAP_AXIS),
                halo_exchange(xi, overlap, SNAP_AXIS))
        # Correction folded into R ((c cᴴ) ∘ R, exact — see
        # cpx_ops.apply_correction_to_cov) BEFORE FB/smoothing: two fewer
        # full passes over the time-sharded sample planes per device.
        R = cpx_ops.cov_from_stream_cpx(x, S, overlap, fb_average=False)
        R = cpx_ops.apply_correction_to_cov(R, Cpx(cr, ci))
        if fb:
            R = cpx_ops.forward_backward_cpx(R)
        if cfg.smoothing.enabled:
            R = cpx_ops.spatial_smooth_cpx(R, cfg.smoothing.subarray_size)
        if bs:
            from doa_tpu.ops.beamspace import beamspace_cov_cpx
            R = beamspace_cov_cpx(R, Bm_host)
        A = Cpx(Ar, Ai)
        V_emb = None
        if use_power and (Estimator.MUSIC in cfg.estimators
                          or Estimator.MIN_NORM in cfg.estimators
                          or Estimator.ROOT_MUSIC in cfg.estimators):
            V_emb = cpx_ops.signal_subspace_embedded(
                R, cfg.num_sources, iters=cfg.power_iters,
                squarings=cfg.power_squarings,
                **(cfg.escalate_kwargs
                   if cfg.power_squarings == 0 else {}))
        M_proj = None
        out = {}
        for est in cfg.estimators:
            if est == Estimator.MUSIC:
                if use_power:
                    den = cpx_ops.music_denominator_subspace(
                        V_emb, A,
                        compute_dtype=jnp.dtype(cfg.compute_dtype))
                    den = jnp.maximum(den, 0.0)
                else:
                    M_proj = (M_proj if M_proj is not None else
                              cpx_ops.noise_projector_cpx(
                                  R, cfg.num_sources))
                    den = cpx_ops.music_denominator_cpx(
                        M_proj, A,
                        compute_dtype=jnp.dtype(cfg.compute_dtype))
                P_loc = 1.0 / jnp.maximum(den,
                                          jnp.finfo(jnp.float32).tiny)
            elif est == Estimator.MIN_NORM:
                # w is per-window (grid-independent), so the grid-
                # sharded scan needs no extra comms at all.
                from doa_tpu.ops.min_norm import (
                    min_norm_denominator_cpx,
                    min_norm_denominator_subspace)
                if use_power:
                    den = min_norm_denominator_subspace(
                        V_emb, A,
                        compute_dtype=jnp.dtype(cfg.compute_dtype))
                else:
                    M_proj = (M_proj if M_proj is not None else
                              cpx_ops.noise_projector_cpx(
                                  R, cfg.num_sources))
                    den = min_norm_denominator_cpx(M_proj, A)
                P_loc = 1.0 / jnp.maximum(den,
                                          jnp.finfo(jnp.float32).tiny)
            elif est == Estimator.CAPON:
                P_loc = cpx_ops.capon_spectrum_cpx(
                    R, A, diag_load=cfg.capon_diag_load, normalize=False)
            elif est == Estimator.BARTLETT:
                P_loc = cpx_ops.bartlett_spectrum_cpx(
                    R, A, normalize=False)
            else:
                continue  # grid-free; handled after the scan loop
            # O(k) TP: local peaks + candidate merge (1-D columns or
            # 2-D az rows); comm volume is independent of G (VERDICT
            # r1 item 5; r4 missing #4 for 2-D).
            _merge_peaks(out, est, P_loc)
        if (Estimator.ROOT_MUSIC in cfg.estimators
                and cfg.geometry.kind == "ula"):
            from doa_tpu.ops.root_music import root_music_cpx

            nproj = (cpx_ops.noise_projector_from_signal(V_emb)
                     if V_emb is not None else None)
            out["root_music_angles"] = root_music_cpx(
                R, cfg.num_sources, cfg.geometry.norm_spacing,
                noise_proj=nproj)
        if (Estimator.ESPRIT in cfg.estimators
                and cfg.geometry.kind == "ula"):
            from doa_tpu.ops.esprit import esprit_cpx

            out["esprit_angles"] = esprit_cpx(
                R, cfg.num_sources, cfg.geometry.norm_spacing)
        if (Estimator.UNITARY_ESPRIT in cfg.estimators
                and cfg.geometry.kind == "ula"):
            from doa_tpu.ops.esprit import unitary_esprit_cpx

            out["unitary_esprit_angles"] = unitary_esprit_cpx(
                R, cfg.num_sources, cfg.geometry.norm_spacing)
        return out

    def _gridfree(out, R, V_emb):
        if (Estimator.ROOT_MUSIC in cfg.estimators
                and cfg.geometry.kind == "ula"):
            from doa_tpu.ops.root_music import root_music_cpx

            nproj = (cpx_ops.noise_projector_from_signal(V_emb)
                     if V_emb is not None else None)
            out["root_music_angles"] = root_music_cpx(
                R, cfg.num_sources, cfg.geometry.norm_spacing,
                noise_proj=nproj)
        if (Estimator.ESPRIT in cfg.estimators
                and cfg.geometry.kind == "ula"):
            from doa_tpu.ops.esprit import esprit_cpx

            out["esprit_angles"] = esprit_cpx(
                R, cfg.num_sources, cfg.geometry.norm_spacing)
        if (Estimator.UNITARY_ESPRIT in cfg.estimators
                and cfg.geometry.kind == "ula"):
            from doa_tpu.ops.esprit import unitary_esprit_cpx

            out["unitary_esprit_angles"] = unitary_esprit_cpx(
                R, cfg.num_sources, cfg.geometry.norm_spacing)

    def shard_fn_fast(xil, cr, ci, Ar, Ai):
        """The single-device interleaved composition per device:
        interleaved rows in, halo on rows, embedded-covariance Gram
        (correction + FB folded), warm subspaces from the psum'd global
        capture mean, MUSIC scan into the O(k) merge."""
        from doa_tpu.ops.interleaved import cov_embedded

        n_snap = mesh.shape[SNAP_AXIS]
        x_ext = halo_exchange(xil, overlap // tp, SNAP_AXIS)
        R, E_win = cov_embedded(
            x_ext, cr, ci, N=N_el, snapshot_size=S, overlap=overlap,
            fb=fb, compute_dtype=jnp.dtype(cfg.cov_dtype))
        B_loc = E_win.shape[0]
        K = cfg.num_sources
        T = xil.shape[0] * tp * n_snap
        B_valid = 0 if T < S else (T - S) // hop + 1
        n_invalid = B_loc * n_snap - B_valid
        me_s = jax.lax.axis_index(SNAP_AXIS)
        if n_invalid:
            # zero the last shard's tail windows (their halo wrapped
            # past the capture end) for the SUBSPACE stage: zero E is
            # source-free to the escalation detector (no spurious
            # flags/capacity use) and keeps the global capture mean
            # equal to the single-chip pipeline's over-valid-windows
            # mean. Their peak outputs are garbage either way — callers
            # slice to num_valid_windows.
            iota_b = jnp.arange(B_loc)
            mask = ((me_s < n_snap - 1)
                    | (iota_b < B_loc - n_invalid)).astype(jnp.float32)
            E_sub_in = E_win * mask[:, None, None]
        else:
            mask = jnp.ones((B_loc,), jnp.float32)
            E_sub_in = E_win
        kw = cfg.escalate_kwargs
        warm = cfg.subspace_warm_start and B_valid >= 32
        if warm:
            Esum = jnp.einsum("b,bij->ij", mask, E_win,
                              preferred_element_type=jnp.float32)
            Ebar = jax.lax.psum(Esum, SNAP_AXIS) / B_valid
            Vt_bar = cpx_ops.signal_subspace_from_E_T(
                Ebar[None], K, iters=max(cfg.power_iters, 8), **kw)
            init = jnp.broadcast_to(Vt_bar,
                                    (B_loc,) + Vt_bar.shape[1:])
            Vt, esc = cpx_ops.signal_subspace_from_E_T(
                E_sub_in, K, iters=cfg.power_iters_warm, init=init,
                return_stats=True, **kw)
        else:
            Vt, esc = cpx_ops.signal_subspace_from_E_T(
                E_sub_in, K, iters=cfg.power_iters,
                squarings=cfg.power_squarings, return_stats=True,
                **(kw if cfg.power_squarings == 0 else {}))
        A = Cpx(Ar, Ai)
        V_emb = jnp.swapaxes(Vt, -1, -2)
        out = {}
        for est in cfg.estimators:
            if est == Estimator.MUSIC:
                den = jnp.maximum(cpx_ops.music_denominator_subspace(
                    V_emb, A, compute_dtype=jnp.dtype(cfg.compute_dtype)),
                    0.0)
                P_loc = 1.0 / jnp.maximum(den,
                                          jnp.finfo(jnp.float32).tiny)
            elif est == Estimator.MIN_NORM:
                from doa_tpu.ops.min_norm import (
                    min_norm_denominator_subspace)
                den = min_norm_denominator_subspace(
                    V_emb, A, compute_dtype=jnp.dtype(cfg.compute_dtype))
                P_loc = 1.0 / jnp.maximum(den,
                                          jnp.finfo(jnp.float32).tiny)
            elif est == Estimator.CAPON:
                P_loc = cpx_ops.capon_spectrum_cpx(
                    R, A, diag_load=cfg.capon_diag_load,
                    normalize=False)
            elif est == Estimator.BARTLETT:
                P_loc = cpx_ops.bartlett_spectrum_cpx(
                    R, A, normalize=False)
            else:
                continue  # grid-free; handled below
            _merge_peaks(out, est, P_loc)
        _gridfree(out, R, V_emb)
        out["escalation_flagged"] = jax.lax.psum(esc[0], SNAP_AXIS)
        out["escalation_overflow"] = jax.lax.psum(esc[1], SNAP_AXIS)
        return out

    spec_sharded = P(SNAP_AXIS, None) if (is_2d and not use_2d_merge) \
        else P(SNAP_AXIS, GRID_AXIS)
    out_specs = {}
    for est in cfg.estimators:
        if est in (Estimator.MUSIC, Estimator.CAPON,
                   Estimator.MIN_NORM, Estimator.BARTLETT):
            if return_spectra:
                out_specs[f"spectrum_{est.value}"] = spec_sharded
            out_specs[f"peak_values_{est.value}"] = P(SNAP_AXIS, None)
            out_specs[f"peak_angles_{est.value}"] = P(SNAP_AXIS, None)
    if (Estimator.ROOT_MUSIC in cfg.estimators
            and cfg.geometry.kind == "ula"):
        out_specs["root_music_angles"] = P(SNAP_AXIS, None)
    if (Estimator.ESPRIT in cfg.estimators
            and cfg.geometry.kind == "ula"):
        out_specs["esprit_angles"] = P(SNAP_AXIS, None)
    if (Estimator.UNITARY_ESPRIT in cfg.estimators
            and cfg.geometry.kind == "ula"):
        out_specs["unitary_esprit_angles"] = P(SNAP_AXIS, None)

    if fast:
        out_specs["escalation_flagged"] = P()
        out_specs["escalation_overflow"] = P()
        mapped = jax.shard_map(
            shard_fn_fast,
            mesh=mesh,
            in_specs=(P(SNAP_AXIS, None), P(), P(),
                      P(GRID_AXIS, None), P(GRID_AXIS, None)),
            out_specs=out_specs,
            check_vma=False,
        )
    else:
        mapped = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(SNAP_AXIS, None), P(SNAP_AXIS, None), P(), P(),
                      P(GRID_AXIS, None), P(GRID_AXIS, None)),
            out_specs=out_specs,
            check_vma=False,
        )
    jitted = jax.jit(f32_matmuls(mapped))

    A_sh = NamedSharding(mesh, P(GRID_AXIS, None))
    Ar_d = jax.device_put(
        np.ascontiguousarray(A_host.real.astype(np.float32)), A_sh)
    Ai_d = jax.device_put(
        np.ascontiguousarray(A_host.imag.astype(np.float32)), A_sh)

    def _corr_planes(N, correction):
        if correction is None:
            return (jnp.ones((N,), jnp.float32),
                    jnp.zeros((N,), jnp.float32))
        if isinstance(correction, Cpx):
            return correction.re, correction.im
        c = np.asarray(correction)
        return (jnp.asarray(c.real.astype(np.float32)),
                jnp.asarray(c.imag.astype(np.float32)))

    def call(x, correction=None):
        n_snap = mesh.shape[SNAP_AXIS]
        if fast:
            # interleaved ingest: a C-ordered c64 capture IS the layout
            if isinstance(x, Cpx):
                x = (np.asarray(x.re)
                     + 1j * np.asarray(x.im)).astype(np.complex64)
            x = np.ascontiguousarray(np.asarray(x, dtype=np.complex64))
            T, N = x.shape
            if T % (n_snap * hop):
                raise ValueError(
                    f"T={T} must be divisible by n_snap*hop="
                    f"{n_snap * hop}")
            xil_h = x.view(np.float32).reshape(T // tp, 2 * N * tp)
            xil = jax.device_put(
                xil_h, NamedSharding(mesh, P(SNAP_AXIS, None)))
            cr, ci = _corr_planes(N, correction)
            return jitted(xil, cr, ci, Ar_d, Ai_d)
        if isinstance(x, Cpx):
            xr_h, xi_h = np.asarray(x.re), np.asarray(x.im)
        else:
            from doa_tpu.io.native import split_c64
            xr_h, xi_h = split_c64(np.asarray(x))
        T = xr_h.shape[0]
        if T % (n_snap * hop):
            raise ValueError(
                f"T={T} must be divisible by n_snap*hop={n_snap * hop}")
        x_sh = NamedSharding(mesh, P(SNAP_AXIS, None))
        xr = jax.device_put(xr_h, x_sh)
        xi = jax.device_put(xi_h, x_sh)
        cr, ci = _corr_planes(xr_h.shape[1], correction)
        return jitted(xr, xi, cr, ci, Ar_d, Ai_d)

    call.jitted = jitted
    call.mesh = mesh
    call.fast = fast
    call.steering_planes = (Ar_d, Ai_d)
    return call


def _build_sharded_wideband(cfg: DoaConfig, mesh: Mesh,
                            refine_peaks: bool = True,
                            return_spectra: bool = True):
    """EP-sharded wideband (see build_sharded_pipeline).

    fusion="cssm" reuses the mesh's second axis TWICE: as the EP axis
    for the per-subband focused covariances (one psum fuses them into
    R_coh, replicated over the axis), then as the TP axis for the
    narrowband scan of R_coh (grid-sharded steering + O(k) local-peak
    merge) — the coherent fusion point is a single N×N psum, after
    which the axis would otherwise idle."""
    if cfg.wideband.fusion in ("cssm", "cssm_auto"):
        return _build_sharded_cssm(cfg, mesh, refine_peaks,
                                   return_spectra)
    if cfg.wideband.fusion == "tops":
        return _build_sharded_tops(cfg, mesh, refine_peaks,
                                   return_spectra)
    from doa_tpu.ops.wideband import (
        dft_matrix, wideband_steering_stack)
    from doa_tpu.pipeline import _steering_fn

    A_host, x_rng = _steering_matrix(cfg)  # narrowband grid (angle map)
    F = cfg.wideband.num_subbands
    S = cfg.snapshot_size
    if S % F:
        raise ValueError("snapshot_size must be divisible by subbands")
    S_sub = S // F
    hop_sub = max(S_sub - cfg.overlap // F, 1)
    n_ep = mesh.shape[GRID_AXIS]
    if F % n_ep:
        raise ValueError(f"subbands {F} not divisible by EP axis {n_ep}")
    F_loc = F // n_ep
    is_2d = cfg.grid2d is not None and cfg.geometry.kind == "ura"
    W_host = dft_matrix(F)
    A_stack = wideband_steering_stack(cfg, _steering_fn(cfg))

    def _peaks(P_full):
        if is_2d:
            from doa_tpu.ops.peaks import find_local_max_2d

            g2 = cfg.grid2d
            P2 = P_full.reshape(P_full.shape[0], g2.num_az, g2.num_el)
            v, az, el = find_local_max_2d(
                P2, cfg.num_max_vals,
                (g2.az_lo_deg, g2.az_hi_deg),
                (g2.el_lo_deg, g2.el_hi_deg), refine=refine_peaks)
            return v, jnp.stack([az, el], axis=-1)
        return find_local_max(P_full, cfg.num_max_vals, x_rng[0],
                              x_rng[1], refine=refine_peaks)

    # Interleaved ingest (the single-device wideband gate, F | TPACK
    # rows): each device deinterleaves its local block and runs the
    # planes composition below.
    from doa_tpu.ops.interleaved import deinterleave, interleave_factor
    N_el = cfg.geometry.num_elements
    tp = interleave_factor(N_el)
    fast = F % tp == 0

    def shard_fn(xr, xi, cr, ci, Wr, Wi, Asr, Asi):
        from doa_tpu.ops.wideband import channelize_cpx

        ep = jax.lax.axis_index(GRID_AXIS)
        # local channelization of the local time block (frames are local)
        xs = channelize_cpx(Cpx(xr, xi), Cpx(Wr, Wi))   # (F, M_loc, N)
        xs = Cpx(jax.lax.dynamic_slice_in_dim(xs.re, ep * F_loc, F_loc),
                 jax.lax.dynamic_slice_in_dim(xs.im, ep * F_loc, F_loc))

        def cov_one(sub):
            return cpx_ops.cov_from_stream_cpx(
                sub, S_sub, S_sub - hop_sub, fb_average=False)

        R = jax.vmap(cov_one)(xs)                       # (F_loc, B, N, N)
        R = cpx_ops.apply_correction_to_cov(R, Cpx(cr, ci))
        A_loc = Cpx(Asr, Asi)                           # (F_loc, G, N)
        if cfg.subspace_method == "power":
            # subband_subspaces honors subspace_warm_start; the warm
            # init uses the GLOBAL capture mean (pmean over time
            # shards) so it matches the single-device pipeline's
            from doa_tpu.cpx import embed_hermitian
            from doa_tpu.ops.wideband import subband_subspaces
            Ebar = (jax.lax.pmean(
                jnp.mean(embed_hermitian(R), axis=1), SNAP_AXIS)
                if cfg.subspace_warm_start
                and R.re.shape[1] * mesh.shape[SNAP_AXIS] >= 32
                else None)
            V = subband_subspaces(R, cfg, Ebar=Ebar)

            def spec_one(v, Af):
                den = jnp.maximum(
                    cpx_ops.music_denominator_subspace(
                        v, Af,
                        compute_dtype=jnp.dtype(cfg.compute_dtype)),
                    0.0)
                P = 1.0 / jnp.maximum(den,
                                      jnp.finfo(jnp.float32).tiny)
                return P / jnp.max(P, axis=-1, keepdims=True)

            P_sub = jax.vmap(spec_one)(V, A_loc)        # (F_loc, B, G)
        else:
            Mp = jax.vmap(lambda r: cpx_ops.noise_projector_cpx(
                r, cfg.num_sources))(R)

            def spec_one(mp, Af):
                den = cpx_ops.music_denominator_cpx(
                    mp, Af, compute_dtype=jnp.dtype(cfg.compute_dtype))
                P = 1.0 / jnp.maximum(den,
                                      jnp.finfo(jnp.float32).tiny)
                return P / jnp.max(P, axis=-1, keepdims=True)

            P_sub = jax.vmap(spec_one)(Mp, A_loc)
        # EP fusion: one psum of the local subband-sum over the EP axis.
        P = jax.lax.psum(jnp.sum(P_sub, axis=0), GRID_AXIS) / F
        v, l = _peaks(P)
        out = {"peak_values_music": v, "peak_angles_music": l}
        if return_spectra:
            out["spectrum_music"] = P
        return out

    def shard_fn_fast(xil, cr, ci, Wr, Wi, Asr, Asi):
        x = deinterleave(xil, N_el)
        return shard_fn(x.re, x.im, cr, ci, Wr, Wi, Asr, Asi)

    out_specs = {"peak_values_music": P(SNAP_AXIS, None),
                 "peak_angles_music": P(SNAP_AXIS, None)}
    if return_spectra:
        out_specs["spectrum_music"] = P(SNAP_AXIS, None)
    if fast:
        mapped = jax.shard_map(
            shard_fn_fast, mesh=mesh,
            in_specs=(P(SNAP_AXIS, None), P(), P(), P(), P(),
                      P(GRID_AXIS, None, None),
                      P(GRID_AXIS, None, None)),
            out_specs=out_specs,
            check_vma=False,
        )
    else:
        mapped = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(SNAP_AXIS, None), P(SNAP_AXIS, None), P(), P(),
                      P(), P(), P(GRID_AXIS, None, None),
                      P(GRID_AXIS, None, None)),
            out_specs=out_specs,
            check_vma=False,
        )
    jitted = jax.jit(f32_matmuls(mapped))

    A_sh = NamedSharding(mesh, P(GRID_AXIS, None, None))
    Asr_d = jax.device_put(
        np.ascontiguousarray(A_stack.real.astype(np.float32)), A_sh)
    Asi_d = jax.device_put(
        np.ascontiguousarray(A_stack.imag.astype(np.float32)), A_sh)
    Wr_d = jax.device_put(W_host.real.astype(np.float32))
    Wi_d = jax.device_put(W_host.imag.astype(np.float32))

    def _correction_planes(N, correction):
        if correction is None:
            return (jnp.ones((N,), jnp.float32),
                    jnp.zeros((N,), jnp.float32))
        c = np.asarray(correction)
        return (jnp.asarray(c.real.astype(np.float32)),
                jnp.asarray(c.imag.astype(np.float32)))

    def call(x, correction=None):
        n_snap = mesh.shape[SNAP_AXIS]
        if fast:
            # interleaved ingest: a C-ordered c64 capture IS the layout
            if isinstance(x, Cpx):
                x = (np.asarray(x.re)
                     + 1j * np.asarray(x.im)).astype(np.complex64)
            x = np.ascontiguousarray(np.asarray(x, dtype=np.complex64))
            T, N = x.shape
            if T % (n_snap * S):
                raise ValueError(
                    f"T={T} must be divisible by n_snap*S={n_snap * S} "
                    "on the wideband EP path")
            xil_h = x.view(np.float32).reshape(T // tp, 2 * N * tp)
            xil = jax.device_put(
                xil_h, NamedSharding(mesh, P(SNAP_AXIS, None)))
            cr, ci = _correction_planes(N, correction)
            return jitted(xil, cr, ci, Wr_d, Wi_d, Asr_d, Asi_d)
        if isinstance(x, Cpx):
            xr_h, xi_h = np.asarray(x.re), np.asarray(x.im)
        else:
            from doa_tpu.io.native import split_c64
            xr_h, xi_h = split_c64(np.asarray(x))
        T = xr_h.shape[0]
        if T % (n_snap * S):
            raise ValueError(
                f"T={T} must be divisible by n_snap*S={n_snap * S} on "
                "the wideband EP path")
        x_sh = NamedSharding(mesh, P(SNAP_AXIS, None))
        xr = jax.device_put(xr_h, x_sh)
        xi = jax.device_put(xi_h, x_sh)
        cr, ci = _correction_planes(xr_h.shape[1], correction)
        return jitted(xr, xi, cr, ci, Wr_d, Wi_d, Asr_d, Asi_d)

    call.jitted = jitted
    call.mesh = mesh
    call.fast = fast
    call.wb_args = (Wr_d, Wi_d, Asr_d, Asi_d)
    return call


def _build_sharded_tops(cfg: DoaConfig, mesh: Mesh,
                        refine_peaks: bool = True,
                        return_spectra: bool = True):
    """EP-sharded TOPS (fusion="tops", ops/tops.py).

    Sharding structure: the subband axis is the EP axis (like the
    incoherent builder), the snapshot batch follows the time axis.
    Each device channelizes its local time block (all F bands fall out
    of the frame-DFT at once), keeps its F_loc slice for the expensive
    per-band subspace iteration, and REPLICATES the reference band's
    covariance + subspace (tiny: one band, and it avoids any subspace
    broadcast over the interconnect). The fusion point is ONE psum of the
    (G, B_loc, K, K) Σ CᴴC accumulator over the EP axis — the TOPS
    analog of the incoherent path's spectrum-sum psum — after which
    every device finalizes λ_min and extracts peaks on its local
    window batch. The reference steering row A_r (G, N) rides in
    replicated so the manifold transform Φ_f = A_f ⊙ conj(A_r) needs
    no cross-shard gather."""
    from doa_tpu.ops.tops import (
        tops_accumulate_cc, tops_finalize, tops_leakage_row)
    from doa_tpu.ops.wideband import (
        channelize_cpx, dft_matrix, wideband_steering_stack)
    from doa_tpu.pipeline import _steering_fn

    A_host, x_rng = _steering_matrix(cfg)
    F = cfg.wideband.num_subbands
    S = cfg.snapshot_size
    if S % F:
        raise ValueError("snapshot_size must be divisible by subbands")
    S_sub = S // F
    hop_sub = max(S_sub - cfg.overlap // F, 1)
    n_ep = mesh.shape[GRID_AXIS]
    if F % n_ep:
        raise ValueError(f"subbands {F} not divisible by EP axis {n_ep}")
    F_loc = F // n_ep
    K = cfg.num_sources
    ref = cfg.wideband.tops_ref_band
    sub_iters = max(cfg.power_iters, 16)
    is_2d = cfg.grid2d is not None and cfg.geometry.kind == "ura"
    W_host = dft_matrix(F)
    A_stack = wideband_steering_stack(cfg, _steering_fn(cfg))

    def _peaks(P_full):
        if is_2d:
            from doa_tpu.ops.peaks import find_local_max_2d

            g2 = cfg.grid2d
            P2 = P_full.reshape(P_full.shape[0], g2.num_az, g2.num_el)
            v, az, el = find_local_max_2d(
                P2, cfg.num_max_vals,
                (g2.az_lo_deg, g2.az_hi_deg),
                (g2.el_lo_deg, g2.el_hi_deg), refine=refine_peaks)
            return v, jnp.stack([az, el], axis=-1)
        return find_local_max(P_full, cfg.num_max_vals, x_rng[0],
                              x_rng[1], refine=refine_peaks)

    def shard_fn(xr, xi, cr, ci, Wr, Wi, Asr, Asi, Arr, Ari):
        from doa_tpu.ops.esprit import signal_subspace_cpx

        ep = jax.lax.axis_index(GRID_AXIS)
        xs = channelize_cpx(Cpx(xr, xi), Cpx(Wr, Wi))   # (F, M_loc, N)

        def cov_one(sub):
            return cpx_ops.cov_from_stream_cpx(
                sub, S_sub, S_sub - hop_sub, fb_average=False)

        corr = Cpx(cr, ci)
        # reference band: replicated per-device compute (one band)
        R_ref = cpx_ops.apply_correction_to_cov(
            cov_one(xs[ref]), corr)                     # (B, N, N)
        S_ref = signal_subspace_cpx(R_ref, K, iters=sub_iters)
        # local bands: the expensive per-band work
        xs_loc = Cpx(
            jax.lax.dynamic_slice_in_dim(xs.re, ep * F_loc, F_loc),
            jax.lax.dynamic_slice_in_dim(xs.im, ep * F_loc, F_loc))
        R_loc = cpx_ops.apply_correction_to_cov(
            jax.vmap(cov_one)(xs_loc), corr)            # (F_loc,B,N,N)
        B, N = R_loc.shape[1], R_loc.shape[-1]
        S_loc = signal_subspace_cpx(
            R_loc.reshape(F_loc * B, N, N), K,
            iters=sub_iters).reshape(F_loc, B, N, K)
        A_ref = Cpx(Arr, Ari)                           # (G, N) replic.
        v = tops_leakage_row(A_ref, S_ref)
        w = (ep * F_loc + jnp.arange(F_loc) != ref).astype(jnp.float32)
        ccr, cci, mus = tops_accumulate_cc(
            S_loc, Cpx(Asr, Asi), A_ref, S_ref, v, w)
        ccr = jax.lax.psum(ccr, GRID_AXIS)
        cci = jax.lax.psum(cci, GRID_AXIS)
        mus = jax.lax.psum(mus, GRID_AXIS)
        P_full = tops_finalize(
            ccr, cci, v, F,
            guard=mus if cfg.wideband.tops_guard else None)
        pv, pl = _peaks(P_full)
        out = {"peak_values_tops": pv, "peak_angles_tops": pl}
        if return_spectra:
            out["spectrum_tops"] = P_full
        return out

    out_specs = {"peak_values_tops": P(SNAP_AXIS, None),
                 "peak_angles_tops": P(SNAP_AXIS, None)}
    if return_spectra:
        out_specs["spectrum_tops"] = P(SNAP_AXIS, None)
    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(SNAP_AXIS, None), P(SNAP_AXIS, None), P(), P(),
                  P(), P(), P(GRID_AXIS, None, None),
                  P(GRID_AXIS, None, None), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )
    jitted = jax.jit(f32_matmuls(mapped))

    A_sh = NamedSharding(mesh, P(GRID_AXIS, None, None))
    Asr_d = jax.device_put(
        np.ascontiguousarray(A_stack.real.astype(np.float32)), A_sh)
    Asi_d = jax.device_put(
        np.ascontiguousarray(A_stack.imag.astype(np.float32)), A_sh)
    Arr_d = jax.device_put(
        np.ascontiguousarray(A_stack[ref].real.astype(np.float32)))
    Ari_d = jax.device_put(
        np.ascontiguousarray(A_stack[ref].imag.astype(np.float32)))
    Wr_d = jax.device_put(W_host.real.astype(np.float32))
    Wi_d = jax.device_put(W_host.imag.astype(np.float32))

    def call(x, correction=None):
        n_snap = mesh.shape[SNAP_AXIS]
        if isinstance(x, Cpx):
            xr_h, xi_h = np.asarray(x.re), np.asarray(x.im)
        else:
            from doa_tpu.io.native import split_c64
            xr_h, xi_h = split_c64(np.asarray(x))
        T = xr_h.shape[0]
        if T % (n_snap * S):
            raise ValueError(
                f"T={T} must be divisible by n_snap*S={n_snap * S} on "
                "the wideband EP path")
        x_sh = NamedSharding(mesh, P(SNAP_AXIS, None))
        xr = jax.device_put(xr_h, x_sh)
        xi = jax.device_put(xi_h, x_sh)
        N = xr_h.shape[1]
        if correction is None:
            cr = jnp.ones((N,), jnp.float32)
            ci = jnp.zeros((N,), jnp.float32)
        else:
            c = np.asarray(correction)
            cr = jnp.asarray(c.real.astype(np.float32))
            ci = jnp.asarray(c.imag.astype(np.float32))
        return jitted(xr, xi, cr, ci, Wr_d, Wi_d, Asr_d, Asi_d,
                      Arr_d, Ari_d)

    call.jitted = jitted
    call.mesh = mesh
    call.fast = False
    return call


def _build_sharded_cssm(cfg: DoaConfig, mesh: Mesh,
                        refine_peaks: bool = True,
                        return_spectra: bool = True):
    """EP→TP coherent wideband: subband-sharded focused covariances,
    psum-fused R_coh, grid-sharded narrowband MUSIC scan.

    fusion="cssm_auto" replaces the static host focusing matrices with
    the two-pass runtime flow, kept EP-sharded end to end: each device
    computes its local subbands' coarse spectra (vs its slice of the
    per-subband steering stack), ONE psum fuses the coarse spectrum (it
    is replicated, so every device finds the SAME peak angles), and
    each device then runs the runtime-focusing pass-2 (steering synth +
    NS polar) for only ITS subbands."""
    from doa_tpu.ops.wideband import dft_matrix, focusing_matrices

    A_host, x_rng = _steering_matrix(cfg)
    F = cfg.wideband.num_subbands
    S = cfg.snapshot_size
    if S % F:
        raise ValueError("snapshot_size must be divisible by subbands")
    S_sub = S // F
    hop_sub = max(S_sub - cfg.overlap // F, 1)
    n_ep = mesh.shape[GRID_AXIS]
    if F % n_ep:
        raise ValueError(f"subbands {F} not divisible by EP axis {n_ep}")
    F_loc = F // n_ep
    G = A_host.shape[0]
    if G % n_ep:
        raise ValueError(f"grid size {G} not divisible by TP axis {n_ep}")
    is_2d = cfg.grid2d is not None and cfg.geometry.kind == "ura"
    use_2d_merge = (is_2d and (G // n_ep) % cfg.grid2d.num_el == 0)
    fb = cfg.avg_method == AvgMethod.FORWARD_BACKWARD
    auto = cfg.wideband.fusion == "cssm_auto"
    W_host = dft_matrix(F)
    if auto:
        from doa_tpu.ops.wideband import (subband_spacings,
                                          wideband_steering_stack)
        from doa_tpu.pipeline import _steering_fn
        As_host = wideband_steering_stack(cfg, _steering_fn(cfg))
        spac_all = np.asarray(subband_spacings(cfg), np.float32)  # (F,)
        d0 = np.float32(cfg.geometry.norm_spacing)
        # extra args reuse the (Tr, Ti) slots with the F-sharded
        # per-subband steering stack planes (F_loc, G_full, N)
        T_host = As_host
    else:
        T_host = focusing_matrices(cfg)             # (F, N, N)

    def shard_fn(xr, xi, cr, ci, Wr, Wi, Tr, Ti, Ar, Ai):
        from doa_tpu.ops.wideband import channelize_cpx
        from doa_tpu.cpx import einsum as cpx_einsum

        ep = jax.lax.axis_index(GRID_AXIS)
        xs = channelize_cpx(Cpx(xr, xi), Cpx(Wr, Wi))   # (F, M_loc, N)
        xs = Cpx(jax.lax.dynamic_slice_in_dim(xs.re, ep * F_loc, F_loc),
                 jax.lax.dynamic_slice_in_dim(xs.im, ep * F_loc, F_loc))

        def cov_one(sub):
            return cpx_ops.cov_from_stream_cpx(
                sub, S_sub, S_sub - hop_sub, fb_average=False)

        R = jax.vmap(cov_one)(xs)                       # (F_loc, B, N, N)
        R = cpx_ops.apply_correction_to_cov(R, Cpx(cr, ci))
        if auto:
            from doa_tpu.ops.wideband import runtime_focusing_cpx
            # pass 1, EP-sharded: local coarse spectra vs the LOCAL
            # slice of the subband steering stack; psum over the TIME
            # axis too so every device sees the capture-global mean
            # covariance (the coarse estimate uses the whole capture).
            Rbar = Cpx(jax.lax.psum(jnp.mean(R.re, axis=1), SNAP_AXIS),
                       jax.lax.psum(jnp.mean(R.im, axis=1), SNAP_AXIS))
            n_t = jnp.float32(mesh.shape[SNAP_AXIS])
            Rbar = Cpx(Rbar.re / n_t, Rbar.im / n_t)    # (F_loc, N, N)
            Vb = cpx_ops.signal_subspace_embedded(
                Rbar, cfg.num_sources, iters=max(cfg.power_iters, 16))

            def spec_one(v, Af):
                den = jnp.maximum(
                    cpx_ops.music_denominator_subspace(v[None], Af),
                    0.0)
                Pl = 1.0 / jnp.maximum(den,
                                       jnp.finfo(jnp.float32).tiny)
                return Pl / jnp.max(Pl, axis=-1, keepdims=True)

            A_loc = Cpx(Tr, Ti)                         # (F_loc, G, N)
            P1 = jnp.sum(jax.vmap(spec_one)(Vb, A_loc), axis=0)
            P1 = jax.lax.psum(P1, GRID_AXIS) / F        # (1, G) replicated
            spac_loc = jnp.concatenate(
                [jnp.asarray([d0]),
                 jax.lax.dynamic_slice_in_dim(
                     jnp.asarray(spac_all), ep * F_loc, F_loc)])
            Tf = runtime_focusing_cpx(P1, cfg, spac_loc)  # (F_loc, N, N)
        else:
            Tf = Cpx(Tr, Ti)                            # (F_loc, N, N)
        TR = cpx_einsum("fnm,fbmk->fbnk", Tf, R)
        Rfoc = cpx_einsum("fbnk,fmk->fbnm", TR, Tf.conj())
        # EP fusion: ONE psum of the local focused sum → R_coh.
        R = Cpx(jax.lax.psum(jnp.sum(Rfoc.re, axis=0), GRID_AXIS) / F,
                jax.lax.psum(jnp.sum(Rfoc.im, axis=0), GRID_AXIS) / F)
        if fb:
            R = cpx_ops.forward_backward_cpx(R)
        if cfg.smoothing.enabled:
            R = cpx_ops.spatial_smooth_cpx(R, cfg.smoothing.subarray_size)
        # TP scan on the SAME axis: A is grid-sharded, R replicated.
        A = Cpx(Ar, Ai)
        if cfg.subspace_method == "power":
            V = cpx_ops.signal_subspace_embedded(
                R, cfg.num_sources, iters=cfg.power_iters,
                squarings=cfg.power_squarings,
                **(cfg.escalate_kwargs
                   if cfg.power_squarings == 0 else {}))
            den = jnp.maximum(
                cpx_ops.music_denominator_subspace(
                    V, A, compute_dtype=jnp.dtype(cfg.compute_dtype)),
                0.0)
        else:
            Mp = cpx_ops.noise_projector_cpx(R, cfg.num_sources)
            den = cpx_ops.music_denominator_cpx(
                Mp, A, compute_dtype=jnp.dtype(cfg.compute_dtype))
        P_loc = 1.0 / jnp.maximum(den, jnp.finfo(jnp.float32).tiny)
        if is_2d and use_2d_merge:
            v, l, gmax = _local_peaks_merge_2d(
                P_loc, cfg.num_max_vals, cfg.grid2d, refine_peaks)
            out = {"peak_values_music": v, "peak_angles_music": l}
            if return_spectra:
                out["spectrum_music"] = P_loc / gmax
            return out
        if is_2d:
            P_full = jax.lax.all_gather(P_loc, GRID_AXIS, axis=1,
                                        tiled=True)
            P_full = P_full / jnp.max(P_full, axis=-1, keepdims=True)
            from doa_tpu.ops.peaks import find_local_max_2d

            g2 = cfg.grid2d
            P2 = P_full.reshape(P_full.shape[0], g2.num_az, g2.num_el)
            v, az, el = find_local_max_2d(
                P2, cfg.num_max_vals,
                (g2.az_lo_deg, g2.az_hi_deg),
                (g2.el_lo_deg, g2.el_hi_deg), refine=refine_peaks)
            l = jnp.stack([az, el], axis=-1)
            out = {"peak_values_music": v, "peak_angles_music": l}
            if return_spectra:
                out["spectrum_music"] = P_full
            return out
        v, l, gmax = _local_peaks_merge_1d(
            P_loc, cfg.num_max_vals, x_rng, refine_peaks)
        out = {"peak_values_music": v, "peak_angles_music": l}
        if return_spectra:
            out["spectrum_music"] = P_loc / gmax
        return out

    out_specs = {
        "peak_values_music": P(SNAP_AXIS, None),
        "peak_angles_music": P(SNAP_AXIS, None)}
    if return_spectra:
        out_specs["spectrum_music"] = (
            P(SNAP_AXIS, None) if (is_2d and not use_2d_merge)
            else P(SNAP_AXIS, GRID_AXIS))
    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(SNAP_AXIS, None), P(SNAP_AXIS, None), P(), P(),
                  P(), P(), P(GRID_AXIS, None, None),
                  P(GRID_AXIS, None, None),
                  P(GRID_AXIS, None), P(GRID_AXIS, None)),
        out_specs=out_specs,
        check_vma=False,
    )
    jitted = jax.jit(f32_matmuls(mapped))

    T_sh = NamedSharding(mesh, P(GRID_AXIS, None, None))
    Tr_d = jax.device_put(
        np.ascontiguousarray(T_host.real.astype(np.float32)), T_sh)
    Ti_d = jax.device_put(
        np.ascontiguousarray(T_host.imag.astype(np.float32)), T_sh)
    A_sh = NamedSharding(mesh, P(GRID_AXIS, None))
    Ar_d = jax.device_put(
        np.ascontiguousarray(A_host.real.astype(np.float32)), A_sh)
    Ai_d = jax.device_put(
        np.ascontiguousarray(A_host.imag.astype(np.float32)), A_sh)
    Wr_d = jax.device_put(W_host.real.astype(np.float32))
    Wi_d = jax.device_put(W_host.imag.astype(np.float32))

    def call(x, correction=None):
        n_snap = mesh.shape[SNAP_AXIS]
        if isinstance(x, Cpx):
            xr_h, xi_h = np.asarray(x.re), np.asarray(x.im)
        else:
            from doa_tpu.io.native import split_c64
            xr_h, xi_h = split_c64(np.asarray(x))
        T = xr_h.shape[0]
        if T % (n_snap * S):
            raise ValueError(
                f"T={T} must be divisible by n_snap*S={n_snap * S} on "
                "the wideband EP path")
        x_sh = NamedSharding(mesh, P(SNAP_AXIS, None))
        xr = jax.device_put(xr_h, x_sh)
        xi = jax.device_put(xi_h, x_sh)
        N = xr_h.shape[1]
        if correction is None:
            cr = jnp.ones((N,), jnp.float32)
            ci = jnp.zeros((N,), jnp.float32)
        else:
            c = np.asarray(correction)
            cr = jnp.asarray(c.real.astype(np.float32))
            ci = jnp.asarray(c.imag.astype(np.float32))
        return jitted(xr, xi, cr, ci, Wr_d, Wi_d, Tr_d, Ti_d, Ar_d, Ai_d)

    call.jitted = jitted
    call.mesh = mesh
    return call


def distributed_covariance(mesh: Mesh):
    """→ jitted fn(x) → R: Cpx[N, N] — ONE covariance over the whole
    time-sharded capture: local stacked Grams + `psum` over the snap axis
    (the calibration-at-scale primitive: partial sums cross devices instead of
    gathering GB/s of samples to one host)."""

    def shard_fn(xr, xi):
        N = xr.shape[1]
        Z = jnp.concatenate([xr, xi], axis=-1)
        Gm = jnp.einsum("si,sj->ij", Z, Z,
                        preferred_element_type=jnp.float32)
        Gm = jax.lax.psum(Gm, SNAP_AXIS)
        total = xr.shape[0] * jax.lax.axis_size(SNAP_AXIS)
        Gm = Gm / total
        return (Gm[:N, :N] + Gm[N:, N:], Gm[N:, :N] - Gm[:N, N:])

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(SNAP_AXIS, None), P(SNAP_AXIS, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    jitted = jax.jit(f32_matmuls(mapped))

    def call(x):
        if isinstance(x, Cpx):
            xr_h, xi_h = np.asarray(x.re), np.asarray(x.im)
        else:
            from doa_tpu.io.native import split_c64
            xr_h, xi_h = split_c64(np.asarray(x))
        sh = NamedSharding(mesh, P(SNAP_AXIS, None))
        rr, ri = jitted(jax.device_put(xr_h, sh), jax.device_put(xi_h, sh))
        return Cpx(rr, ri)

    return call
