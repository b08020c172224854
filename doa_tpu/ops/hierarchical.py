"""Hierarchical (coarse → refine) MUSIC scan.

Dense scanning couples angular resolution to grid size: 0.01° over 180°
needs an 18,000-column steering matrix per estimator. Here resolution is
decoupled: a COARSE dense scan (optionally bf16/int8) finds peak basins
— the MUSIC denominator is aperture-smooth, so a ~1°-spaced grid cannot
miss a basin even when the null itself is ultra-sharp — then a REFINE
stage evaluates the exact denominator on a narrow per-peak window whose
steering vectors are synthesized ON DEVICE at data-dependent angles
(a(θ) is analytic; no precomputed matrix), followed by a closed-form
parabolic minimum of the locally-quadratic denominator.

Cost: coarse B·G_c·2N·2K + refine B·k·W·2N·2K, vs dense B·G_fine·2N·2K.
At 0.01° effective resolution with G_c = 256, W = 64: ~50× fewer scan
flops than the equivalent dense grid. No reference analog (upstream
scans one fixed grid); this is the on-device superresolution path.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from doa_tpu.cpx import Cpx
from doa_tpu.ops import cpx_ops
from doa_tpu.ops.peaks import find_local_max


def ula_denominator_at(V_emb, theta_deg, norm_spacing: float):
    """Exact MUSIC denominator at arbitrary (traced) angles for a ULA.

    V_emb: f32[B, 2N, 2K]; theta_deg: f32[B, ...] → den f32[B, ...].
    Steering is built in-graph: phase = −2π·d·cosθ·k, ã = [cos; sin].
    ‖a‖² = N exactly (unit-modulus entries)."""
    n2 = V_emb.shape[-2]
    N = n2 // 2
    theta = jnp.deg2rad(theta_deg)
    k = jnp.arange(N, dtype=jnp.float32)
    phase = (-2.0 * jnp.pi * norm_spacing
             * jnp.cos(theta)[..., None] * k)          # (B, ..., N)
    at = jnp.concatenate([jnp.cos(phase), jnp.sin(phase)], axis=-1)
    # Y[b, ..., m] = Σ_n ã[b, ..., n] V[b, n, m]
    Y = jnp.einsum("b...n,bnm->b...m", at, V_emb,
                   preferred_element_type=jnp.float32)
    return N - jnp.sum(Y * Y, axis=-1)


def refine_peaks_ula(V_emb, coarse_deg, norm_spacing: float,
                     half_width_deg: float = 1.5, num_points: int = 33):
    """Per-peak refinement: dense micro-scan of the exact denominator on
    [θc − hw, θc + hw] + parabolic minimum. coarse_deg: f32[B, k] →
    refined f32[B, k]."""
    offs = jnp.linspace(-half_width_deg, half_width_deg, num_points)
    theta = coarse_deg[..., None] + offs                # (B, k, W)
    den = ula_denominator_at(V_emb, theta, norm_spacing)
    i = jnp.argmin(den, axis=-1)
    W = num_points
    im = jnp.clip(i - 1, 0, W - 1)
    ip = jnp.clip(i + 1, 0, W - 1)
    dm = jnp.take_along_axis(den, im[..., None], -1)[..., 0]
    d0 = jnp.take_along_axis(den, i[..., None], -1)[..., 0]
    dp = jnp.take_along_axis(den, ip[..., None], -1)[..., 0]
    curv = dm - 2.0 * d0 + dp
    delta = jnp.where(jnp.abs(curv) > 0, 0.5 * (dm - dp) / curv, 0.0)
    delta = jnp.where((i > 0) & (i < W - 1),
                      jnp.clip(delta, -1.0, 1.0), 0.0)
    step = 2.0 * half_width_deg / (W - 1)
    t0 = jnp.take_along_axis(theta, i[..., None], -1)[..., 0]
    return t0 + delta * step


def ura_denominator_at(V_emb, az_deg, el_deg, shape, norm_spacing: float):
    """Exact MUSIC denominator at arbitrary (az, el) for a planar array.

    V_emb: f32[B, 2N, 2K]; az_deg/el_deg: f32[B, ...] → den f32[B, ...].
    Same direction-cosine model as ops.steering.ura_steering."""
    nx, ny = shape
    az = jnp.deg2rad(az_deg)
    el = jnp.deg2rad(el_deg)
    ux = jnp.cos(el) * jnp.sin(az)
    uy = jnp.cos(el) * jnp.cos(az)
    ix = jnp.arange(nx, dtype=jnp.float32)[:, None]
    iy = jnp.arange(ny, dtype=jnp.float32)[None, :]
    phase = (-2.0 * jnp.pi * norm_spacing
             * (ux[..., None, None] * ix + uy[..., None, None] * iy))
    phase = phase.reshape(*az.shape, nx * ny)
    at = jnp.concatenate([jnp.cos(phase), jnp.sin(phase)], axis=-1)
    Y = jnp.einsum("b...n,bnm->b...m", at, V_emb,
                   preferred_element_type=jnp.float32)
    return (nx * ny) - jnp.sum(Y * Y, axis=-1)


def refine_peaks_ura(V_emb, az_deg, el_deg, shape, norm_spacing: float,
                     half_width_deg: float = 2.0, num_points: int = 9):
    """Per-peak 2-D refinement: micro-grid of the exact denominator around
    each coarse (az, el) + separable parabolic minima.
    az_deg/el_deg: f32[B, k] → (az f32[B, k], el f32[B, k])."""
    W = num_points
    offs = jnp.linspace(-half_width_deg, half_width_deg, W)
    azg = az_deg[..., None, None] + offs[:, None]       # (B, k, W, 1)
    elg = el_deg[..., None, None] + offs[None, :]       # (B, k, 1, W)
    azg, elg = jnp.broadcast_arrays(azg, elg)           # (B, k, W, W)
    den = ura_denominator_at(V_emb, azg, elg, shape, norm_spacing)
    B, k = az_deg.shape
    den_f = den.reshape(B, k, W * W)
    i = jnp.argmin(den_f, axis=-1)
    ia, ie = i // W, i % W
    step = 2.0 * half_width_deg / (W - 1)

    def parab(d_axis, idx):
        Wn = d_axis.shape[-1]
        im = jnp.clip(idx - 1, 0, Wn - 1)
        ip = jnp.clip(idx + 1, 0, Wn - 1)
        dm = jnp.take_along_axis(d_axis, im[..., None], -1)[..., 0]
        d0 = jnp.take_along_axis(d_axis, idx[..., None], -1)[..., 0]
        dp = jnp.take_along_axis(d_axis, ip[..., None], -1)[..., 0]
        curv = dm - 2.0 * d0 + dp
        delta = jnp.where(jnp.abs(curv) > 0, 0.5 * (dm - dp) / curv, 0.0)
        return jnp.where((idx > 0) & (idx < Wn - 1),
                         jnp.clip(delta, -1.0, 1.0), 0.0)

    # az profile at the winning el column; el profile at the winning row.
    den_az = jnp.take_along_axis(
        den, ie[..., None, None].repeat(W, axis=-2), -1)[..., 0]
    den_el = jnp.take_along_axis(
        den, ia[..., None, None].repeat(W, axis=-1), -2)[..., 0, :]
    da = parab(den_az, ia)
    de = parab(den_el, ie)
    az0 = jnp.take_along_axis(
        azg.reshape(B, k, W * W), i[..., None], -1)[..., 0]
    el0 = jnp.take_along_axis(
        elg.reshape(B, k, W * W), i[..., None], -1)[..., 0]
    return az0 + da * step, el0 + de * step


def music_hierarchical_ura(V_emb, A_coarse: Cpx, num_peaks: int,
                           shape, norm_spacing: float, grid2d,
                           compute_dtype=jnp.float32,
                           half_width_deg: float = 2.0,
                           num_points: int = 9):
    """Coarse→refine MUSIC for a planar array (2-D az/el).

    grid2d: configs.GridSpec2D of the coarse scan.
    → (peak_values f32[B, k], az f32[B, k], el f32[B, k])."""
    from doa_tpu.ops.peaks import find_local_max_2d

    den_c = cpx_ops.music_denominator_subspace(
        V_emb, A_coarse, compute_dtype=compute_dtype)
    den_c = jnp.maximum(den_c, 0.0)
    P = 1.0 / jnp.maximum(den_c, jnp.finfo(jnp.float32).tiny)
    P = P / jnp.max(P, axis=-1, keepdims=True)
    P2 = P.reshape(P.shape[0], grid2d.num_az, grid2d.num_el)
    vals, az_c, el_c = find_local_max_2d(
        P2, num_peaks, (grid2d.az_lo_deg, grid2d.az_hi_deg),
        (grid2d.el_lo_deg, grid2d.el_hi_deg), refine=False)
    az, el = refine_peaks_ura(V_emb, az_c, el_c, shape, norm_spacing,
                              half_width_deg, num_points)
    return vals, az, el


def _capon_chol(R: Cpx, diag_load: float):
    """Diagonal-loaded Cholesky of the 2N real embedding (one factor per
    window, reused for every refinement angle)."""
    from doa_tpu.cpx import embed_hermitian

    N = R.shape[-1]
    if diag_load > 0:
        tr = jnp.trace(R.re, axis1=-2, axis2=-1) / N
        eye = jnp.eye(N, dtype=R.re.dtype)
        R = Cpx(R.re + (diag_load * tr)[..., None, None] * eye, R.im)
    return jax.lax.linalg.cholesky(embed_hermitian(R))


def _capon_den_at(L, at):
    """den = ‖L⁻¹ ã‖² for steering rows ã: f32[B, ..., 2N] against
    per-window Cholesky factors L: f32[B, 2N, 2N]."""
    lead = at.shape[1:-1]
    n2 = at.shape[-1]
    rhs = jnp.moveaxis(at.reshape(at.shape[0], -1, n2), 1, 2)
    X = jax.lax.linalg.triangular_solve(L, rhs, left_side=True,
                                        lower=True)
    den = jnp.sum(X * X, axis=-2)                    # (B, prod(lead))
    return den.reshape((at.shape[0],) + lead)


def _ula_steering_rows(theta_deg, N: int, norm_spacing):
    theta = jnp.deg2rad(theta_deg)
    k = jnp.arange(N, dtype=jnp.float32)
    phase = (-2.0 * jnp.pi * norm_spacing
             * jnp.cos(theta)[..., None] * k)
    return jnp.concatenate([jnp.cos(phase), jnp.sin(phase)], axis=-1)


def _ura_steering_rows(az_deg, el_deg, shape, norm_spacing):
    nx, ny = shape
    az = jnp.deg2rad(az_deg)
    el = jnp.deg2rad(el_deg)
    ux = jnp.cos(el) * jnp.sin(az)
    uy = jnp.cos(el) * jnp.cos(az)
    ix = jnp.arange(nx, dtype=jnp.float32)[:, None]
    iy = jnp.arange(ny, dtype=jnp.float32)[None, :]
    phase = (-2.0 * jnp.pi * norm_spacing
             * (ux[..., None, None] * ix + uy[..., None, None] * iy))
    phase = phase.reshape(*az.shape, nx * ny)
    return jnp.concatenate([jnp.cos(phase), jnp.sin(phase)], axis=-1)


def _parabolic_argmin(den, theta, half_width_deg: float, W: int):
    i = jnp.argmin(den, axis=-1)
    im = jnp.clip(i - 1, 0, W - 1)
    ip = jnp.clip(i + 1, 0, W - 1)
    dm = jnp.take_along_axis(den, im[..., None], -1)[..., 0]
    d0 = jnp.take_along_axis(den, i[..., None], -1)[..., 0]
    dp = jnp.take_along_axis(den, ip[..., None], -1)[..., 0]
    curv = dm - 2.0 * d0 + dp
    delta = jnp.where(jnp.abs(curv) > 0, 0.5 * (dm - dp) / curv, 0.0)
    delta = jnp.where((i > 0) & (i < W - 1),
                      jnp.clip(delta, -1.0, 1.0), 0.0)
    step = 2.0 * half_width_deg / (W - 1)
    t0 = jnp.take_along_axis(theta, i[..., None], -1)[..., 0]
    return t0 + delta * step


def capon_hierarchical_ula(R: Cpx, A_coarse: Cpx, num_peaks: int,
                           norm_spacing: float, diag_load: float = 1e-4,
                           coarse_rng=(0.0, 180.0),
                           half_width_deg: float = 1.5,
                           num_points: int = 33):
    """Coarse→refine Capon-MVDR for a ULA: one Cholesky of the loaded
    2N embedding per window (the coarse scan's factor, reused), then the
    exact Capon denominator ‖L⁻¹ã(θ)‖² on per-peak micro-grids +
    parabolic minimum. → (values f32[B, k], angles f32[B, k])."""
    from doa_tpu.ops.cpx_ops import capon_spectrum_cpx

    N = R.shape[-1]
    P_c = capon_spectrum_cpx(R, A_coarse, diag_load=diag_load)
    vals, coarse = find_local_max(P_c, num_peaks, coarse_rng[0],
                                  coarse_rng[1], refine=False)
    L = _capon_chol(R, diag_load)
    offs = jnp.linspace(-half_width_deg, half_width_deg, num_points)
    theta = coarse[..., None] + offs                 # (B, k, W)
    at = _ula_steering_rows(theta, N, norm_spacing)
    den = _capon_den_at(L, at)
    return vals, _parabolic_argmin(den, theta, half_width_deg,
                                   num_points)


def capon_hierarchical_ura(R: Cpx, A_coarse: Cpx, num_peaks: int,
                           shape, norm_spacing: float, grid2d,
                           diag_load: float = 1e-4,
                           half_width_deg: float = 2.0,
                           num_points: int = 9):
    """Coarse→refine Capon for a planar array (2-D az/el).
    → (values f32[B, k], az f32[B, k], el f32[B, k])."""
    from doa_tpu.ops.cpx_ops import capon_spectrum_cpx
    from doa_tpu.ops.peaks import find_local_max_2d

    P_c = capon_spectrum_cpx(R, A_coarse, diag_load=diag_load)
    P2 = P_c.reshape(P_c.shape[0], grid2d.num_az, grid2d.num_el)
    vals, az_c, el_c = find_local_max_2d(
        P2, num_peaks, (grid2d.az_lo_deg, grid2d.az_hi_deg),
        (grid2d.el_lo_deg, grid2d.el_hi_deg), refine=False)
    L = _capon_chol(R, diag_load)
    Wp = num_points
    offs = jnp.linspace(-half_width_deg, half_width_deg, Wp)
    azg = az_c[..., None, None] + offs[:, None]
    elg = el_c[..., None, None] + offs[None, :]
    azg, elg = jnp.broadcast_arrays(azg, elg)        # (B, k, Wp, Wp)
    at = _ura_steering_rows(azg, elg, shape, norm_spacing)
    den = _capon_den_at(L, at)
    B, k = az_c.shape
    i = jnp.argmin(den.reshape(B, k, Wp * Wp), axis=-1)
    az = jnp.take_along_axis(
        azg.reshape(B, k, Wp * Wp), i[..., None], -1)[..., 0]
    el = jnp.take_along_axis(
        elg.reshape(B, k, Wp * Wp), i[..., None], -1)[..., 0]
    return vals, az, el


def music_hierarchical_ula(V_emb, A_coarse: Cpx, num_peaks: int,
                           norm_spacing: float,
                           coarse_rng=(0.0, 180.0),
                           half_width_deg: float = 1.5,
                           num_points: int = 33,
                           compute_dtype=jnp.float32):
    """Full coarse→refine MUSIC for a ULA.

    → (peak_values f32[B, k] (coarse, max-normalized),
       angles f32[B, k] refined to sub-grid precision)."""
    den_c = cpx_ops.music_denominator_subspace(
        V_emb, A_coarse, compute_dtype=compute_dtype)
    den_c = jnp.maximum(den_c, 0.0)
    P_c = 1.0 / jnp.maximum(den_c, jnp.finfo(jnp.float32).tiny)
    P_c = P_c / jnp.max(P_c, axis=-1, keepdims=True)
    vals, coarse = find_local_max(P_c, num_peaks, coarse_rng[0],
                                  coarse_rng[1], refine=False)
    refined = refine_peaks_ula(V_emb, coarse, norm_spacing,
                               half_width_deg, num_points)
    return vals, refined
