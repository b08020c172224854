"""Wideband DoA via per-subband channelization + incoherent fusion
(BASELINE config 5; no upstream equivalent — gr-doa is narrowband-only).

Pipeline: x[T, N] → F-point DFT channelizer (critically sampled: frames of
F consecutive samples, one DFT each → F subband streams at rate 1/F) →
per-subband covariance + MUSIC with a subband-scaled steering grid →
incoherent fusion (mean of max-normalized subband spectra).

The DFT runs as a planar complex matmul with the (F, F) DFT matrix —
complex-free and matmul-shaped for small F, which is exactly the
subband-count regime (8–64) here.

Steering vs frequency: with array spacing d = norm_spacing wavelengths AT
THE CARRIER, a subband at baseband offset f_norm ∈ [-.5, .5) (fraction of
the sample rate) sees effective spacing d·(1 + f_norm·fractional_bw),
fractional_bw = samp_rate / carrier_freq.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from doa_tpu.configs import DoaConfig
from doa_tpu.cpx import Cpx
from doa_tpu.ops import cpx_ops


def subband_center_freqs(num_subbands: int) -> np.ndarray:
    """Normalized center frequency of each DFT bin, in [-0.5, 0.5)."""
    f = np.fft.fftfreq(num_subbands)
    return f.astype(np.float32)


def dft_matrix(F: int) -> np.ndarray:
    """(F, F) complex64 DFT matrix W[f, t] = exp(-2πj f t / F)."""
    f = np.arange(F)[:, None]
    t = np.arange(F)[None, :]
    return np.exp(-2j * np.pi * f * t / F).astype(np.complex64)


def channelize_cpx(x: Cpx, W: Cpx) -> Cpx:
    """x: Cpx[T, N] → subband streams Cpx[F, T//F, N].

    Frame T into T//F frames of F samples, DFT each frame:
    out[f, m, n] = Σ_t W[f, t] x[m·F + t, n].
    """
    F = W.shape[0]
    T, N = x.shape
    M = T // F
    xf = x[: M * F].reshape(M, F, N)
    # (F,F) × (M,F,N) → (M,F,N) contracting the frame-time axis.
    out = cpx_ops_einsum("ft,mtn->fmn", W, xf)
    return out


def cpx_ops_einsum(sub, a: Cpx, b: Cpx) -> Cpx:
    from doa_tpu.cpx import einsum
    return einsum(sub, a, b)


def wideband_steering_stack(cfg: DoaConfig, A_fn) -> np.ndarray:
    """Per-subband steering matrices A: complex64[F, G, N].

    A_fn(norm_spacing) → (G, N) complex steering matrix at a given
    effective spacing (curried over the config's grid + geometry).
    """
    F = cfg.wideband.num_subbands
    fbw = getattr(cfg.wideband, "fractional_bw", 0.0)
    freqs = subband_center_freqs(F)
    mats = [A_fn(cfg.geometry.norm_spacing * (1.0 + float(fn) * fbw))
            for fn in freqs]
    return np.stack(mats, axis=0)


def subband_covariances(x: Cpx, W: Cpx, cfg: DoaConfig) -> Cpx:
    """x: Cpx[T, N] → per-subband windowed covariances Cpx[F, B, N, N].

    Subband snapshot length = cfg.snapshot_size // F input samples worth
    of subband samples, so one fused output window spans the same
    wall-clock as a narrowband window. Overlap applies in the subband
    domain."""
    F = W.shape[0]
    S = cfg.snapshot_size
    if S % F:
        raise ValueError("snapshot_size must be divisible by num_subbands")
    S_sub = S // F
    hop_sub = max(S_sub - cfg.overlap // F, 1)
    xs = channelize_cpx(x, W)                       # (F, M, N)
    return jax.vmap(lambda sub: cpx_ops.cov_from_stream_cpx(
        sub, S_sub, S_sub - hop_sub, fb_average=False))(xs)


def subband_subspaces(R: Cpx, cfg: DoaConfig, Ebar=None):
    """Per-subband embedded signal subspaces f32[F, B, 2N, 2K]
    (power path). Ebar: optional (F, 2N, 2N) capture-mean override for
    the warm start (sharded callers pass the psum'd GLOBAL mean so the
    init matches the single-device pipeline — at power_iters_warm=2 a
    shard-local mean leaves a visible init residue)."""
    if Ebar is not None or (cfg.subspace_warm_start
                            and R.re.shape[1] >= 32):
        from doa_tpu.cpx import embed_hermitian
        return subband_subspaces_from_E(embed_hermitian(R), cfg,
                                        Ebar=Ebar)
    # subband windows hold S/F samples — the escalation floor scales to
    # that operating point's Wishart noise-bulk edge (escalate_kwargs_for)
    esc = cfg.escalate_kwargs_for(
        cfg.snapshot_size // cfg.wideband.num_subbands)
    return jax.vmap(lambda r: cpx_ops.signal_subspace_embedded(
        r, cfg.num_sources, iters=cfg.power_iters,
        squarings=cfg.power_squarings,
        **(esc if cfg.power_squarings == 0 else {})))(R)


def subband_subspaces_from_E(E_sub, cfg: DoaConfig, Ebar=None):
    """Pre-embedded per-subband covariances f32[F, B, 2N, 2N] → signal
    subspaces
    f32[F, B, 2N, 2K]. Merges the (F, B) axes so the subspace
    iteration runs one large batch instead of a vmap over subbands.

    cfg.subspace_warm_start: initialize every window from its subband's
    CAPTURE-MEAN covariance subspace (full-iters on F tiny matrices)
    and refine with power_iters_warm E-applies per window — cuts the
    stage's dominant cost (passes over the (F·B, 2N, 2N) stack) from
    power_iters to power_iters_warm."""
    F, B, n2, _ = E_sub.shape
    K2 = 2 * cfg.num_sources
    esc = cfg.escalate_kwargs_for(
        cfg.snapshot_size // cfg.wideband.num_subbands, n2=n2)
    # Ebar given ⇒ warm regardless of the LOCAL batch size (sharded
    # callers gate on the GLOBAL window count and pass the pmean'd
    # global mean, so shards match the single-device program exactly)
    if Ebar is not None or (cfg.subspace_warm_start and B >= 32):
        if Ebar is None:
            Ebar = jnp.mean(E_sub, axis=1)
        Vt_bar = cpx_ops.signal_subspace_from_E_T(
            Ebar, cfg.num_sources,
            iters=max(cfg.power_iters, 8),
            **esc)                                   # (F, 2K, 2N)
        init = jnp.broadcast_to(
            Vt_bar[:, None], (F, B, K2, n2)).reshape(F * B, K2, n2)
        Vt = cpx_ops.signal_subspace_from_E_T(
            E_sub.reshape(F * B, n2, n2), cfg.num_sources,
            iters=cfg.power_iters_warm, init=init,
            **esc)
        return jnp.swapaxes(Vt, -1, -2).reshape(F, B, n2, K2)
    V = cpx_ops.signal_subspace_from_E(
        E_sub.reshape(F * B, n2, n2), cfg.num_sources,
        iters=cfg.power_iters, squarings=cfg.power_squarings)
    return V.reshape(F, B, n2, 2 * cfg.num_sources)


def _subband_spectra(x: Cpx, A_stack: Cpx, W: Cpx, cfg: DoaConfig):
    """→ (P_sub f32[F, B, G] max-normalized per subband,
          V f32[F, B, 2N, 2K] | None)."""
    R = subband_covariances(x, W, cfg)
    if cfg.subspace_method == "power":
        V = subband_subspaces(R, cfg)

        def spec_one(v, Af):
            den = jnp.maximum(
                cpx_ops.music_denominator_subspace(
                    v, Af,
                    compute_dtype=jnp.dtype(cfg.compute_dtype)), 0.0)
            P = 1.0 / jnp.maximum(den, jnp.finfo(jnp.float32).tiny)
            return P / jnp.max(P, axis=-1, keepdims=True)

        return jax.vmap(spec_one)(V, A_stack), V
    M_proj = jax.vmap(
        lambda r: cpx_ops.noise_projector_cpx(r, cfg.num_sources))(R)

    def spec_one(mp, Af):
        den = cpx_ops.music_denominator_cpx(
            mp, Af, compute_dtype=jnp.dtype(cfg.compute_dtype))
        P = 1.0 / jnp.maximum(den, jnp.finfo(jnp.float32).tiny)
        return P / jnp.max(P, axis=-1, keepdims=True)

    return jax.vmap(spec_one)(M_proj, A_stack), None


def wideband_music_cpx(x: Cpx, A_stack: Cpx, W: Cpx, cfg: DoaConfig):
    """x: Cpx[T, N], A_stack: Cpx[F, G, N], W: DFT Cpx[F, F] →
    fused spectrum f32[B, G] (mean of max-normalized subband spectra).

    The fusion accumulates with a lax.scan over subbands instead of
    materializing the (F, B, G) per-subband spectrum stack — at the c5
    production shape that stack is 2.2 GB (× passes), the single
    largest wideband intermediate; the scan's live set is one (B, G)
    accumulator + one subband's intermediates."""
    R = subband_covariances(x, W, cfg)               # (F, B, N, N)
    if cfg.subspace_method == "power":
        return fuse_subband_music(subband_subspaces(R, cfg), A_stack,
                                  cfg)                # V (F, B, 2N, 2K)
    return fuse_subband_music(jax.vmap(lambda r: cpx_ops.noise_projector_cpx(
        r, cfg.num_sources))(R), A_stack, cfg)        # M Cpx[F, B, N, N]


def fuse_subband_music(S, A_stack: Cpx, cfg: DoaConfig):
    """Incoherent fusion of per-subband MUSIC spectra, one lax.scan step
    per subband: S is either the signal subspaces f32[F, B, 2N, 2K]
    (power path) or the noise projectors Cpx[F, B, N, N] →
    f32[B, G] = mean_f of the max-normalized subband spectra."""
    dt = jnp.dtype(cfg.compute_dtype)
    if isinstance(S, Cpx):
        den_fn = lambda s, A: cpx_ops.music_denominator_cpx(  # noqa: E731
            s, A, compute_dtype=dt)
        B = S.re.shape[1]
    else:
        den_fn = lambda s, A: jnp.maximum(  # noqa: E731
            cpx_ops.music_denominator_subspace(s, A, compute_dtype=dt), 0.0)
        B = S.shape[1]

    def step(acc, sA):
        s, A = sA
        P = 1.0 / jnp.maximum(den_fn(s, A), jnp.finfo(jnp.float32).tiny)
        return acc + P / jnp.max(P, axis=-1, keepdims=True), None

    F, G = A_stack.shape[0], A_stack.shape[1]
    acc0 = jnp.zeros((B, G), jnp.float32)
    return jax.lax.scan(step, acc0, (S, A_stack))[0] / F


# ---------------------------------------------------------------------
# Coherent fusion: CSSM with unitary RSS focusing (Hung & Kaveh).
# The focusing matrices are CONFIG-STATIC (like steering grids): built
# once per pipeline on the host, passed to jit as device constants. The
# per-window focused sum runs on device as batched complex matmuls.
# ---------------------------------------------------------------------

def focusing_directions(cfg: DoaConfig):
    """J focusing directions spanning the scan field of view.

    CSSM classically focuses at preliminary DoA estimates; the
    estimate-free variant focuses at a fixed direction set covering the
    FOV — with J ≥ N directions the cross-manifold product is full rank
    and the unitary Procrustes solution aligns the WHOLE visible
    manifold, not just a sector (tested to fractional bandwidth 0.4 in
    tests/test_cssm.py). Default J = 2N: measured on the 16-el/fbw-0.4
    scenario, J = N under-samples the manifold (worst subband's grid
    misalignment grows 1.15× after focusing) while J = 2N reduces every
    subband's ≥ 2.1× with no further gain at 4N/8N. Interior sampling
    avoids the degenerate endfire/horizon edges.

    → theta_deg (J,) for ULA; (az_deg, el_deg) each (J,) for URA."""
    J = cfg.wideband.num_focus_angles or 2 * cfg.geometry.num_elements
    if cfg.geometry.kind == "ula":
        return np.linspace(cfg.grid.lo_deg, cfg.grid.hi_deg,
                           J + 2)[1:-1].astype(np.float64)
    g2 = cfg.grid2d
    ja = int(np.ceil(np.sqrt(J)))
    az = np.linspace(g2.az_lo_deg, g2.az_hi_deg, ja + 2)[1:-1]
    el = np.linspace(g2.el_lo_deg, g2.el_hi_deg, ja + 2)[1:-1]
    azg, elg = np.meshgrid(az, el, indexing="ij")
    return azg.ravel(), elg.ravel()


def _focus_steering(cfg: DoaConfig, spacing: float) -> np.ndarray:
    """(N, J) complex128 steering columns at the focusing directions for
    the FULL array (focusing precedes spatial smoothing) at a given
    effective spacing."""
    dirs = focusing_directions(cfg)
    N = cfg.geometry.num_elements
    if cfg.geometry.kind == "ula":
        theta = np.deg2rad(np.asarray(dirs))
        k = np.arange(N)
        A = np.exp(-2j * np.pi * spacing * np.cos(theta)[:, None] * k)
        return A.T                                   # (N, J)
    az, el = dirs
    az = np.deg2rad(az)
    el = np.deg2rad(el)
    ux = np.cos(el) * np.sin(az)
    uy = np.cos(el) * np.cos(az)
    nx, ny = cfg.geometry.shape
    ix = np.arange(nx)[:, None]
    iy = np.arange(ny)[None, :]
    phase = -2 * np.pi * spacing * (ux[:, None, None] * ix
                                    + uy[:, None, None] * iy)
    return np.exp(1j * phase).reshape(len(ux), nx * ny).T


def focusing_matrices(cfg: DoaConfig) -> np.ndarray:
    """Unitary RSS focusing matrices T: complex64[F, N, N].

    Per subband f (effective spacing d_f): T_f is the unitary Procrustes
    solution min_T ‖B₀ − T B_f‖_F over unitary T, with B_f = (N, J)
    steering columns at the focusing directions — T_f = U Vᴴ from the
    SVD  B₀ B_fᴴ = U Σ Vᴴ. Unitarity keeps focused noise white (σ²I →
    σ²I), so the focused covariance feeds any narrowband subspace
    estimator unchanged."""
    B0 = _focus_steering(cfg, cfg.geometry.norm_spacing)
    mats = []
    for d in subband_spacings(cfg):
        Bf = _focus_steering(cfg, float(d))
        M = B0 @ Bf.conj().T                         # (N, N)
        U, _, Vh = np.linalg.svd(M)
        mats.append(U @ Vh)
    return np.stack(mats, axis=0).astype(np.complex64)


def device_ula_steering_cpx(theta_deg, num_elements: int,
                            spacings) -> Cpx:
    """ULA steering at RUNTIME angles, split-complex: theta_deg (J,)
    device degrees × spacings (S,) → Cpx[S, J, N] with
    a[s, j, n] = exp(−j2π·d_s·cosθ_j·n) (the pinned golden sign)."""
    from doa_tpu.cpx import expj
    cs = jnp.cos(jnp.deg2rad(theta_deg))            # (J,)
    n = jnp.arange(num_elements, dtype=jnp.float32)
    ph = (-2.0 * jnp.pi) * (jnp.asarray(spacings)[:, None, None]
                            * cs[None, :, None] * n[None, None, :])
    return expj(ph)


def polar_unitary_cpx(M: Cpx, iters: int = 20, eps: float = 1e-4) -> Cpx:
    """Batched unitary polar factor T = M·(MᴴM + ε·tr̄·I)^{−1/2} via a
    coupled Newton-Schulz inverse-sqrt — matmul-only, the on-device
    replacement for the host SVD in `focusing_matrices` when the
    focusing directions are only known at RUNTIME (two-pass CSSM).
    M: Cpx[..., N, N]; ε regularizes rank-deficient direction sets
    (directions orthogonal to the fit carry no manifold energy).

    Traces under the pipelines' matmul precision (cpx.f32_matmuls) even
    when called standalone: the NS iteration diverges to ~0.12
    unitarity error under single-pass low-precision matmuls (measured
    — PERF.md "Precision")."""
    from doa_tpu import cpx

    N = M.shape[-1]
    cpx_einsum = cpx.einsum
    with jax.default_matmul_precision(cpx.MATMUL_PRECISION):
        G = cpx_einsum("...mn,...mk->...nk", M.conj(), M)  # MᴴM ⪰ 0
        eye = jnp.eye(N, dtype=jnp.float32)
        trbar = jnp.trace(G.re, axis1=-2, axis2=-1)[..., None, None] / N
        G = Cpx(G.re + eps * trbar * eye, G.im)
        # Frobenius scale ≥ λmax puts the spectrum in NS's (0, 1] basin.
        c = jnp.sqrt(jnp.sum(G.re * G.re + G.im * G.im,
                             axis=(-2, -1)))[..., None, None]
        c = jnp.maximum(c, 1e-30)
        Y = Cpx(G.re / c, G.im / c)
        Z = Cpx(jnp.broadcast_to(eye, Y.shape[:-2] + (N, N)),
                jnp.zeros(Y.shape[:-2] + (N, N), jnp.float32))
        mm = lambda a, b: cpx_einsum(  # noqa: E731
            "...ij,...jk->...ik", a, b)
        for _ in range(iters):                             # → Z = Yn^{-1/2}
            ZY = mm(Z, Y)
            Tns = Cpx(0.5 * (3.0 * eye - ZY.re), -0.5 * ZY.im)
            Y = mm(Y, Tns)
            Z = mm(Tns, Z)
        Ginv_h = Cpx(Z.re / jnp.sqrt(c), Z.im / jnp.sqrt(c))
        T = mm(M, Ginv_h)                                  # M (MᴴM)^{-1/2}
        # f32 coupled NS plateaus ~6e-3 off unitary at cond(G) ≈ 1e3
        # (measured, numpy f32 reproduces it); two direct polar-NS
        # polish steps T ← ½T(3I − TᴴT) are quadratic near unitarity
        # (same singular vectors → same polar factor) and land at f32
        # rounding (~1e-6).
        for _ in range(2):
            H = cpx_einsum("...mn,...mk->...nk", T.conj(), T)
            S = Cpx(0.5 * (3.0 * eye - H.re), -0.5 * H.im)
            T = mm(T, S)
        return T


def device_ura_steering_cpx(az_deg, el_deg, shape,
                            spacings) -> Cpx:
    """URA steering at RUNTIME (az, el) pairs, split-complex:
    az/el (J,) device degrees × spacings (S,) → Cpx[S, J, N]
    (x-major flattening, matching ops.steering.ura_steering)."""
    from doa_tpu.cpx import expj
    az = jnp.deg2rad(az_deg)
    el = jnp.deg2rad(el_deg)
    ux = jnp.cos(el) * jnp.sin(az)                  # (J,)
    uy = jnp.cos(el) * jnp.cos(az)
    nx, ny = shape
    ix = jnp.arange(nx, dtype=jnp.float32)[:, None]
    iy = jnp.arange(ny, dtype=jnp.float32)[None, :]
    grid = (ux[:, None, None] * ix + uy[:, None, None] * iy)  # (J,nx,ny)
    ph = (-2.0 * jnp.pi) * (jnp.asarray(spacings)[:, None, None]
                            * grid.reshape(grid.shape[0], -1)[None])
    return expj(ph)


def auto_focused_covariance_cpx(x: Cpx, A_stack: Cpx, W: Cpx,
                                cfg: DoaConfig,
                                sector_halfwidth_deg: float = 2.0,
                                sector_weight: float = 2.0) -> Cpx:
    """Two-pass AUTO-FOCUSED CSSM (fusion="cssm_auto"), fully on device.

    Pass 1: capture-mean subband covariances → incoherent fused MUSIC
    spectrum → K coarse peak angles (the classic Hung–Kaveh
    preliminary-estimate step). Pass 2: focusing directions = the
    estimated sector (θ̂ ± halfwidth, weighted ×sector_weight) plus the
    static FOV set (keeps the Procrustes fit full-rank), per-subband
    steering synthesized at runtime angles, unitary T_f from the
    Newton-Schulz polar factor, R_coh = mean_f T_f R_f T_fᴴ.

    vs the static J=2N set: the fit concentrates where the sources
    actually are, which is what holds the coherent envelope at large
    fractional bandwidths (the FOV-uniform fit dilutes as the manifold
    bends — see tests/test_cssm.py auto-vs-static sweep)."""
    R_sub = subband_covariances(x, W, cfg)               # (F, B, N, N)
    Rbar = Cpx(jnp.mean(R_sub.re, axis=1), jnp.mean(R_sub.im, axis=1))
    V = cpx_ops.signal_subspace_embedded(
        Rbar, cfg.num_sources, iters=max(cfg.power_iters, 16))

    def spec_one(v, Af):
        den = jnp.maximum(
            cpx_ops.music_denominator_subspace(v[None], Af), 0.0)
        P = 1.0 / jnp.maximum(den, jnp.finfo(jnp.float32).tiny)
        return P / jnp.max(P, axis=-1, keepdims=True)

    P = jnp.mean(jax.vmap(spec_one)(V, A_stack), axis=0)  # (1, G)
    spac = np.concatenate(
        [[cfg.geometry.norm_spacing],
         subband_spacings(cfg)]).astype(np.float32)
    T_foc = runtime_focusing_cpx(P, cfg, spac,
                                 sector_halfwidth_deg, sector_weight)
    TR = cpx_ops_einsum("fnm,fbmk->fbnk", T_foc, R_sub)
    R_foc = cpx_ops_einsum("fbnk,fmk->fbnm", TR, T_foc.conj())
    return Cpx(jnp.mean(R_foc.re, axis=0), jnp.mean(R_foc.im, axis=0))


def runtime_focusing_cpx(P, cfg: DoaConfig, spacings,
                         sector_halfwidth_deg: float = 2.0,
                         sector_weight: float = 2.0) -> Cpx:
    """Coarse fused spectrum P: f32[1, G] → unitary focusing matrices
    Cpx[len(spacings)−1, N, N] for spacings[1:] (spacings[0] is the
    reference). The shared pass-2 of the two-pass CSSM: peak the coarse
    spectrum (1-D or 2-D per cfg), build the weighted direction set
    (estimated sector + static FOV fill), synthesize steering at
    runtime angles, Newton-Schulz polar. Also the sharded EP path's
    per-device focusing (each device passes only ITS subband
    spacings)."""
    from doa_tpu.cpx import einsum as cpx_einsum
    from doa_tpu.ops.peaks import find_local_max

    hw = sector_halfwidth_deg
    spac = spacings
    if cfg.geometry.kind == "ura":
        from doa_tpu.ops.peaks import find_local_max_2d
        g2 = cfg.grid2d
        P2 = P.reshape(1, g2.num_az, g2.num_el)
        _, azp, elp = find_local_max_2d(
            P2, cfg.num_sources, (g2.az_lo_deg, g2.az_hi_deg),
            (g2.el_lo_deg, g2.el_hi_deg))
        offs = [(0.0, 0.0), (hw, 0.0), (-hw, 0.0),
                (0.0, hw), (0.0, -hw)]                     # 5 per source
        sec_az = jnp.concatenate([azp[0] + da for da, _ in offs])
        sec_el = jnp.concatenate([elp[0] + de for _, de in offs])
        uni_az, uni_el = focusing_directions(cfg)
        dirs_az = jnp.concatenate(
            [sec_az, jnp.asarray(uni_az.astype(np.float32))])
        dirs_el = jnp.concatenate(
            [sec_el, jnp.asarray(uni_el.astype(np.float32))])
        wts = jnp.concatenate(
            [jnp.full(sec_az.shape, sector_weight, jnp.float32),
             jnp.ones(len(uni_az), jnp.float32)])
        A_all = device_ura_steering_cpx(
            dirs_az, dirs_el, cfg.geometry.shape, spac)   # (F+1, J, N)
    else:
        _, th = find_local_max(P, cfg.num_sources,
                               cfg.grid.lo_deg, cfg.grid.hi_deg)
        offs = jnp.asarray([-hw, 0.0, hw], jnp.float32)
        sector = (th[0][:, None] + offs[None, :]).reshape(-1)  # (3K,)
        uni = jnp.asarray(np.asarray(
            focusing_directions(cfg), np.float32))             # (J0,)
        dirs = jnp.concatenate([sector, uni])
        wts = jnp.concatenate(
            [jnp.full(sector.shape, sector_weight, jnp.float32),
             jnp.ones(uni.shape, jnp.float32)])
        N = cfg.geometry.num_elements
        A_all = device_ula_steering_cpx(dirs, N, spac)    # (F+1, J, N)
    B0w = Cpx(A_all.re[0] * wts[:, None], A_all.im[0] * wts[:, None])
    Bf = Cpx(A_all.re[1:], A_all.im[1:])
    M = cpx_einsum("jn,fjm->fnm", B0w, Bf.conj())         # B₀ diag(w) B_fᴴ
    return polar_unitary_cpx(M)


def cssm_covariance_cpx(x: Cpx, W: Cpx, T_foc: Cpx,
                        cfg: DoaConfig) -> Cpx:
    """x: Cpx[T, N], W: DFT Cpx[F, F], T_foc: Cpx[F, N, N] →
    focused coherent covariance Cpx[B, N, N] = mean_f T_f R_f T_fᴴ."""
    R_sub = subband_covariances(x, W, cfg)           # (F, B, N, N)
    TR = cpx_ops_einsum("fnm,fbmk->fbnk", T_foc, R_sub)
    R_foc = cpx_ops_einsum("fbnk,fmk->fbnm", TR, T_foc.conj())
    return Cpx(jnp.mean(R_foc.re, axis=0), jnp.mean(R_foc.im, axis=0))


def subband_spacings(cfg: DoaConfig) -> np.ndarray:
    """Effective per-subband element spacings d·(1 + f·fractional_bw)."""
    freqs = subband_center_freqs(cfg.wideband.num_subbands)
    fbw = cfg.wideband.fractional_bw
    return (cfg.geometry.norm_spacing
            * (1.0 + freqs * fbw)).astype(np.float32)


def wideband_music_hierarchical_cpx(x: Cpx, A_stack: Cpx, W: Cpx,
                                    cfg: DoaConfig, num_peaks: int,
                                    x_rng=(0.0, 180.0), grid2d=None,
                                    half_width_deg: float = 1.5,
                                    num_points: int = 17):
    """Coarse→refine WIDEBAND MUSIC (power path): fuse the coarse
    subband spectra, find peak basins, then refine each peak on an
    on-device micro-grid of the FUSED metric — every subband's exact
    denominator is evaluated at its own effective spacing (the subband
    steering stretch), normalized by its coarse spectrum max, and
    averaged. Unlocks the wideband × hierarchical config cell.

    → (values f32[B, k], angles f32[B, k] (1-D) or (B, k, 2) az/el)."""
    from doa_tpu.ops.hierarchical import (
        ula_denominator_at, ura_denominator_at)
    from doa_tpu.ops.peaks import find_local_max, find_local_max_2d

    P_sub, V = _subband_spectra(x, A_stack, W, cfg)
    if V is None:
        raise ValueError("wideband hierarchical requires "
                         "subspace_method='power'")
    fused = jnp.mean(P_sub, axis=0)                  # (B, G)
    spac = jnp.asarray(subband_spacings(cfg))        # (F,)
    # Subband normalizers: coarse max of each subband's UNnormalized
    # spectrum is 1 after _subband_spectra's normalization, so the
    # refine metric just averages max-normalized reciprocals — but the
    # normalization constant must come from the same scale: recover it
    # from the coarse denominator minimum instead.
    den_min = jax.vmap(lambda v, Af: jnp.min(jnp.maximum(
        cpx_ops.music_denominator_subspace(v, Af), 0.0), axis=-1))(
            V, A_stack)                              # (F, B)
    den_min = jnp.maximum(den_min, jnp.finfo(jnp.float32).tiny)

    is_2d = grid2d is not None

    def fused_metric(theta=None, az=None, el=None,
                     refine_chunk: int = 128):
        """Mean over subbands of den_min_f / den_f(angle) ∈ (0, 1].

        Chunked over the WINDOW axis (lax.map over B-chunks of
        `refine_chunk`, all F subbands vmapped inside): the micro-grid
        steering sin/cos intermediates are (B, k, Wp², 2N)-sized —
        vmapping F subbands over the full batch materializes them for
        the whole c5 production batch at once (tens of GB), while a
        lax.map PER SUBBAND serializes F tiny steps. Per-chunk live set
        at c5 defaults: F·chunk·k·Wp²·2N·4 B ≈ 0.6 GB, and one big
        parallel program per step."""
        def den_at(v, d, ang):
            if is_2d:
                return ura_denominator_at(v, ang[0], ang[1],
                                          cfg.geometry.shape, d)
            return ula_denominator_at(v, ang, d)

        ang = (az, el) if is_2d else theta
        B_ = V.shape[1]
        CH = max(1, min(B_, refine_chunk))
        nch = -(-B_ // CH)
        pad = nch * CH - B_

        def padB(t, axis):
            if pad == 0:
                return t
            widths = [(0, 0)] * t.ndim
            widths[axis] = (0, pad)
            return jnp.pad(t, widths, mode="edge")

        Vc = padB(V, 1).reshape(
            (V.shape[0], nch, CH) + V.shape[2:])      # (F, nch, CH, ...)
        dmc = padB(den_min, 1).reshape(den_min.shape[0], nch, CH)
        angc = jax.tree_util.tree_map(
            lambda t: padB(t, 0).reshape((nch, CH) + t.shape[1:]), ang)

        def one_chunk(args):
            vc, dc, ac = args                          # chunk slice

            def per_band(v, d, dm):
                den = jnp.maximum(den_at(v, d, ac),
                                  jnp.finfo(jnp.float32).tiny)
                return dm.reshape(
                    dm.shape + (1,) * (den.ndim - 1)) / den

            ratios = jax.vmap(per_band)(vc, spac, dc)  # (F, CH, ...)
            return jnp.mean(ratios, axis=0)            # (CH, ...)

        out = jax.lax.map(one_chunk,
                          (jnp.swapaxes(Vc, 0, 1), jnp.swapaxes(dmc, 0, 1),
                           angc))                      # (nch, CH, ...)
        return out.reshape((nch * CH,) + out.shape[2:])[:B_]

    if is_2d:
        P2 = fused.reshape(fused.shape[0], grid2d.num_az, grid2d.num_el)
        vals, az_c, el_c = find_local_max_2d(
            P2, num_peaks, (grid2d.az_lo_deg, grid2d.az_hi_deg),
            (grid2d.el_lo_deg, grid2d.el_hi_deg), refine=False)
        Wp = num_points
        offs = jnp.linspace(-half_width_deg, half_width_deg, Wp)
        azg = az_c[..., None, None] + offs[:, None]
        elg = el_c[..., None, None] + offs[None, :]
        azg, elg = jnp.broadcast_arrays(azg, elg)    # (B, k, Wp, Wp)
        m = fused_metric(az=azg, el=elg)
        B, k = az_c.shape
        i = jnp.argmax(m.reshape(B, k, Wp * Wp), axis=-1)
        az = jnp.take_along_axis(
            azg.reshape(B, k, Wp * Wp), i[..., None], -1)[..., 0]
        el = jnp.take_along_axis(
            elg.reshape(B, k, Wp * Wp), i[..., None], -1)[..., 0]
        return vals, jnp.stack([az, el], axis=-1)

    vals, coarse = find_local_max(fused, num_peaks, x_rng[0], x_rng[1],
                                  refine=False)
    offs = jnp.linspace(-half_width_deg, half_width_deg, num_points)
    theta = coarse[..., None] + offs                 # (B, k, Wp)
    m = fused_metric(theta=theta)                    # (B, k, Wp)
    i = jnp.argmax(m, axis=-1)
    Wp = num_points
    im = jnp.clip(i - 1, 0, Wp - 1)
    ip = jnp.clip(i + 1, 0, Wp - 1)
    mm_ = jnp.take_along_axis(m, im[..., None], -1)[..., 0]
    m0 = jnp.take_along_axis(m, i[..., None], -1)[..., 0]
    mp = jnp.take_along_axis(m, ip[..., None], -1)[..., 0]
    curv = mm_ - 2.0 * m0 + mp
    delta = jnp.where(jnp.abs(curv) > 0, 0.5 * (mm_ - mp) / curv, 0.0)
    delta = jnp.where((i > 0) & (i < Wp - 1),
                      jnp.clip(delta, -1.0, 1.0), 0.0)
    step = 2.0 * half_width_deg / (Wp - 1)
    t0 = jnp.take_along_axis(theta, i[..., None], -1)[..., 0]
    return vals, t0 + delta * step
