"""TOPS wideband DoA — Test of Orthogonality of Projected Subspaces.

Fourth wideband fusion mode alongside the incoherent spectrum mean
and coherent CSSM / auto-focused CSSM (ops/wideband.py). TOPS needs
NO focusing matrices and no preliminary angle estimates (CSSM's classical weakness) yet still uses
the whole band coherently — through subspace geometry instead of
spectrum averaging. Reference algorithm: Yoon, Kaplan & McClellan,
"TOPS: New DOA Estimator for Wideband Signals", IEEE Trans. SP 54(6),
2006. No upstream equivalent (SURVEY.md §0 — gr-doa is narrowband-
only); this rounds out the wideband family the way ESPRIT rounds out
the narrowband one. Conventions pinned by tests/golden.py::tops_spectrum.

Math (window b, candidate angle θ; reference subband r):

  * S_f: complex signal subspace of subband f (N×K, orthonormal
    columns — ops/esprit.signal_subspace_cpx, the complex-paired
    iteration; the embedded real bases of the production power path
    are deliberately NOT complex-paired).
  * Φ_f(θ) = diag_n exp(−j·2π·(s_f − s_r)·⟨pos_n, u(θ)⟩) carries the
    reference band's manifold to band f's: Φ_f(θ)·a_r(θ) = a_f(θ).
    Every steering entry is a unit phasor, so
        Φ_f(θ) = A_f(θ) ⊙ conj(A_r(θ))
    — exactly the per-subband steering stack the incoherent path
    already ships, which makes the transform geometry-agnostic (ULA
    and URA alike; 1-D and 2-D grids).
  * U_f(θ) = Φ_f(θ)·S_r. At the true DoA U_f falls inside band f's
    signal subspace, so its projection onto band f's NOISE subspace
    vanishes.
  * Projection correction (the paper's error-reduction step):
    U'_f = (I − â_f â_fᴴ)·U_f with â = a/‖a‖ deflates the component
    along the candidate steering vector, which finite-sample subspace
    error otherwise leaks coherently into every band.
  * D(θ) = [W_1ᴴU'_1 | …] stacks the noise-subspace images of all
    non-reference bands (W_f = noise basis). TOPS spectrum
    P(θ) = 1/σ_min(D); D drops rank exactly at source DoAs.

Implementation: σ_min²(D) = λ_min(M) with the K×K Hermitian

    M(θ) = Σ_{f≠r} U'ᴴ_f (I − S_f S_fᴴ) U'_f
         = (F−1)·(I − vᴴv) − Σ_{f≠r} C_fᴴ C_f,

where v = â_rᴴ S_r (per-θ row, f-independent: â_fᴴΦ_f = â_rᴴ because
the phasors cancel) and C_f = S_fᴴU_f − (S_fᴴâ_f)(â_fᴴU_f). Everything
is K² statically-unrolled (G, N)@(N, B) matmuls + elementwise (G, B)
ops per band inside one lax.scan over subbands — a (K, K, G, B)
accumulator (tiny K axes LEADING, the large (G, B) axes minor), no
per-angle control flow, no (F, G, B, N) intermediates. λ_min is
closed-form for K ≤ 2 (pure elementwise math) and falls back to the
batched matmul Jacobi rotor
on the 2K×2K real Hermitian embedding (ops/jacobi.py) for K > 2, so
the whole estimator is complex-free-backend safe and eig-free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from doa_tpu.cpx import Cpx, einsum as cpx_einsum, embed_hermitian
from doa_tpu.ops.jacobi import eigh_jacobi


def tops_leakage_row(A_ref: Cpx, S_ref: Cpx) -> Cpx:
    """v[l, g, b] = (â_rᴴ S_r)_l — the band-independent steering-
    leakage row (â_fᴴΦ_f = â_rᴴ: the unit phasors cancel). A_ref:
    (G, N) UNNORMALIZED reference steering; S_ref: (B, N, K).

    Layout note: every TOPS tensor keeps the tiny K axes LEADING and
    the large (G, B) axes minor, so each elementwise op runs over
    contiguous (G, B) planes."""
    inv_sqrt_n = 1.0 / (A_ref.shape[-1] ** 0.5)
    return cpx_einsum("gn,bnl->lgb", A_ref.conj() * inv_sqrt_n, S_ref)


def tops_accumulate_cc(S_bands: Cpx, A_bands: Cpx, A_ref: Cpx,
                       S_ref: Cpx, v: Cpx, w_bands):
    """Σ_f w_f·C_fᴴC_f over the given bands (a lax.scan; the sharded
    EP path calls this with each device's LOCAL band slice and psums
    the result). S_bands: Cpx[Fl, B, N, K]; A_bands: Cpx[Fl, G, N];
    A_ref: (G, N) unnormalized; v: Cpx (K, G, B) from
    tops_leakage_row; w_bands: f32[Fl] 0/1 mask (0 on the reference
    band itself).
    → (ccr, cci, mus) — CC f32[K, K, G, B] planes plus the incoherent
    MUSIC guard sum f32[G, B] (Σ over ALL local bands of the
    max-normalized per-band signal-subspace MUSIC spectrum — free
    here: its denominator 1 − ‖S_fᴴâ_f‖² reuses the r leakage term)."""
    Fl, B, N, K = S_bands.shape
    G = A_bands.shape[1]
    inv_sqrt_n = 1.0 / (N ** 0.5)
    A_ref_c = A_ref.conj()
    # Static-K unroll: K is tiny (1-4). Expressing the per-band work as
    # batched einsums over a (G·B)-sized batch of K-dimensional
    # matrices issues ~G·B micro-dots per band. Unrolled, each (k, l)
    # pair is ONE full (G, N)@(N, B) matmul plus elementwise (G, B)
    # ops — K²+K large matmuls per band.
    S_ref_cols = [Cpx(S_ref.re[..., c], S_ref.im[..., c])
                  for c in range(K)]                     # (B, N) each
    v_cols = [Cpx(v.re[c], v.im[c]) for c in range(K)]   # (G, B) each

    def step(acc, xs):
        sr, si, ar, ai, w = xs
        S_f = Cpx(sr, si)                                # (B, N, K)
        A_f = Cpx(ar, ai) * inv_sqrt_n                   # â_f: (G, N)
        # Φ_f = A_f ⊙ conj(A_r): entrywise product of unit phasors —
        # itself unit-modulus, so no normalization enters Φ.
        Phi = Cpx(ar, ai) * A_ref_c                      # (G, N)
        Sf_cols_c = [Cpx(S_f.re[..., c], -S_f.im[..., c])
                     for c in range(K)]                  # conj, (B, N)
        # r_k[g, b] = Σ_n conj(S_f[b,n,k])·â_f[g,n]
        r = [cpx_einsum("gn,bn->gb", A_f, Sk) for Sk in Sf_cols_c]
        # C[k][l] = Σ_n Φ[g,n]·conj(S_f)_k·S_r_l − r_k·v_l
        C = [[cpx_einsum("gn,bn->gb", Phi, Sf_cols_c[k] * S_ref_cols[l])
              - r[k] * v_cols[l] for l in range(K)] for k in range(K)]
        # CC[l, m] = Σ_k conj(C[k][l])·C[k][m]
        ccr_s, cci_s = [], []
        for l in range(K):
            for m in range(K):
                s = None
                for k in range(K):
                    t = C[k][l].conj() * C[k][m]
                    s = t if s is None else s + t
                ccr_s.append(s.re)
                cci_s.append(s.im)
        CCr = jnp.stack(ccr_s).reshape(K, K, G, B)
        CCi = jnp.stack(cci_s).reshape(K, K, G, B)
        # incoherent-MUSIC guard term (ALL bands, weight 1):
        # den = ‖(I − S_fS_fᴴ)â_f‖² = 1 − Σ_k |r|².
        den = 1.0
        for rk in r:
            den = den - rk.abs2()
        den = jnp.maximum(den, 0.0)
        Pf = 1.0 / jnp.maximum(den, jnp.finfo(jnp.float32).tiny)
        Pf = Pf / jnp.max(Pf, axis=0, keepdims=True)     # (G, B)
        return (acc[0] + w * CCr, acc[1] + w * CCi,
                acc[2] + Pf), None

    acc0 = (jnp.zeros((K, K, G, B), jnp.float32),
            jnp.zeros((K, K, G, B), jnp.float32),
            jnp.zeros((G, B), jnp.float32))
    xs = (S_bands.re, S_bands.im, A_bands.re, A_bands.im,
          jnp.asarray(w_bands, jnp.float32))
    (ccr, cci, mus), _ = jax.lax.scan(step, acc0, xs)
    return ccr, cci, mus


def tops_finalize(ccr, cci, v: Cpx, num_bands: int,
                  jacobi_sweeps: int = 8, guard=None):
    """(Σ CᴴC planes f32[K, K, G, B], leakage row v (K, G, B), total
    band count F) → max-normalized TOPS spectrum f32[B, G]:
    M = (F−1)·(I − vᴴv) − ΣCᴴC, P = 1/λ_min(M).

    λ_min: closed form for K ≤ 2 (pure elementwise math on (G, B)
    planes, instead of a batched Jacobi on G·B 4×4 embeddings);
    embedded Jacobi rotor for K > 2.

    guard: optional incoherent-MUSIC sum f32[G, B] (from
    tops_accumulate_cc). When given, the returned spectrum is the
    product of the TOPS and incoherent spectra (renormalized) — the
    transform-degeneracy false-peak suppressor (see tops_spectrum_cpx).
    """
    K = ccr.shape[0]
    # vv[l, m, g, b] = conj(v)_l · v_m
    vv = Cpx(v.re[:, None], -v.im[:, None]) * Cpx(
        v.re[None, :], v.im[None, :])
    nb = float(num_bands - 1)
    eyeK = jnp.eye(K, dtype=jnp.float32)[:, :, None, None]
    M = Cpx(nb * (eyeK - vv.re) - ccr, nb * (-vv.im) - cci)
    if K == 1:
        lam_min = M.re[0, 0]
    elif K == 2:
        # Hermitian 2×2 [[a, c], [c̄, d]]: λ_min = (a+d)/2 −
        # √(((a−d)/2)² + |c|²); enforce Hermitianity by averaging the
        # off-diagonal pair (a, d real by construction).
        a, d = M.re[0, 0], M.re[1, 1]
        cr_ = 0.5 * (M.re[0, 1] + M.re[1, 0])
        ci_ = 0.5 * (M.im[0, 1] - M.im[1, 0])
        half = 0.5 * (a - d)
        lam_min = 0.5 * (a + d) - jnp.sqrt(
            half * half + cr_ * cr_ + ci_ * ci_)
    else:
        Mt = Cpx(jnp.moveaxis(M.re, (0, 1), (-2, -1)),
                 jnp.moveaxis(M.im, (0, 1), (-2, -1)))  # (G, B, K, K)
        E = embed_hermitian(Mt)                         # (G, B, 2K, 2K)
        E = 0.5 * (E + jnp.swapaxes(E, -1, -2))
        lam_min = eigh_jacobi(E, sweeps=jacobi_sweeps)[0][..., 0]
    P = 1.0 / jnp.maximum(lam_min, jnp.finfo(jnp.float32).tiny)
    if guard is not None:
        P = P * (guard / float(num_bands))
    P = jnp.swapaxes(P, 0, 1)                            # (B, G)
    return P / jnp.max(P, axis=-1, keepdims=True)


def tops_spectrum_cpx(S_sub: Cpx, A_stack: Cpx, ref_band: int = 0,
                      jacobi_sweeps: int = 8, guard: bool = False):
    """S_sub: Cpx[F, B, N, K] per-subband orthonormal signal subspaces,
    A_stack: Cpx[F, G, N] per-subband steering → TOPS pseudospectrum
    f32[B, G], max-normalized per window.

    ref_band selects the reference subband r (the band whose subspace
    is transported across the band; the classic choice is the
    highest-SNR bin — config-static here so the scan stays loop-free).

    guard: TOPS's canonical artifact is a FALSE PEAK where the manifold
    transform degenerates to identity (broadside on a ULA: cosθ = 0 ⇒
    Φ_f(θ) = I for every band, so D(θ) tests only cross-band subspace
    consistency, which finite-sample subspace error can rank above the
    true-angle nulls — measured: at fbw 0.4 / 10 dB the 90° ridge wins
    in ~25% of windows, docs/ACCURACY.md). guard=True multiplies by the
    incoherent signal-subspace MUSIC spectrum accumulated in the same
    scan (near-free): the product suppresses the ridge (incoherent
    MUSIC has a true null there) without masking genuine broadside
    sources (both factors peak for those). Default False here (the
    textbook estimator, golden-parity); the pipeline default is ON
    (configs.WidebandSpec.tops_guard)."""
    F = S_sub.shape[0]
    A_ref = A_stack[ref_band]                            # (G, N) raw
    S_ref = S_sub[ref_band]                              # (B, N, K)
    v = tops_leakage_row(A_ref, S_ref)
    w_band = (jnp.arange(F) != ref_band).astype(jnp.float32)
    ccr, cci, mus = tops_accumulate_cc(S_sub, A_stack, A_ref, S_ref,
                                       v, w_band)
    return tops_finalize(ccr, cci, v, F, jacobi_sweeps=jacobi_sweeps,
                         guard=mus if guard else None)


def wideband_tops_cpx(x: Cpx, A_stack: Cpx, W: Cpx, cfg):
    """Stream-level TOPS: x Cpx[T, N] → f32[B, G]. Mirrors wideband_music_cpx's calling convention so the
    pipeline dispatch is symmetric across fusion modes.

    Working-set note: the scan accumulators are (K, K, G, B)+(G, B)
    f32 — 8·G·B·(K²+1) bytes live across the subband scan (≈ 24 MB at
    G=361, B=2048, K=2; ≈ 5.4 GB at the c5 2-D grid G=16471). For
    large G·B configs feed the pipeline smaller window blocks (the
    streaming drivers already do) rather than one huge capture."""
    from doa_tpu.ops.esprit import signal_subspace_cpx
    from doa_tpu.ops.wideband import subband_covariances

    R_sub = subband_covariances(x, W, cfg)               # (F, B, N, N)
    F, B, N, _ = R_sub.shape
    K = cfg.num_sources
    S = signal_subspace_cpx(R_sub.reshape(F * B, N, N), K,
                            iters=max(cfg.power_iters, 16))
    S_sub = S.reshape(F, B, N, K)
    return tops_spectrum_cpx(S_sub, A_stack,
                             ref_band=cfg.wideband.tops_ref_band,
                             guard=cfg.wideband.tops_guard)
