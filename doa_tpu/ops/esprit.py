"""ESPRIT for uniform linear arrays (grid-free, shift-invariance based).

Beyond the reference (which ships MUSIC/root-MUSIC only) — rounds out the
subspace-estimator family. Fully batched, complex-free-backend safe, and
eig-free (JAX lowers `eig` only on the CPU):

  1. complex signal subspace E_s: Cpx[B, N, K] by power iteration in
     split-complex arithmetic (Newton-Schulz orthonormalization of the
     K×K Gram — all Cpx matmuls);
  2. LS solution of the shift-invariance equation
         E_s[:-1] Ψ ≈ E_s[1:]
     via the K×K normal equations, inverted with Newton-Schulz;
  3. eigenvalues of the K×K non-Hermitian Ψ from its characteristic
     polynomial (batched Faddeev-LeVerrier: c coefficients from traces of
     powers) rooted with the existing Aberth-Ehrlich iterator;
  4. θ = acos(−arg λ / (2π d)) — λ estimates z = exp(−j2πd cosθ).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from doa_tpu.cpx import Cpx
from doa_tpu.ops.root_music import polynomial_roots_cpx


def _mm(a: Cpx, b: Cpx) -> Cpx:
    """Batched complex matmul on planes (B, m, k) @ (B, k, n)."""
    es = lambda x, y: jnp.einsum(  # noqa: E731
        "bik,bkj->bij", x, y, preferred_element_type=jnp.float32)
    k1 = es(a.re, b.re + b.im)
    k2 = es(a.re + a.im, b.im)
    k3 = es(a.im - a.re, b.re)
    return Cpx(k1 - k2, k1 + k3)


def _herm(a: Cpx) -> Cpx:
    return Cpx(jnp.swapaxes(a.re, -1, -2), -jnp.swapaxes(a.im, -1, -2))


def _gram(a: Cpx) -> Cpx:
    """AᴴA for A: Cpx (B, m, k) → (B, k, k) Hermitian."""
    return _mm(_herm(a), a)


def _eye_like(k: int, batch, dtype=jnp.float32) -> Cpx:
    eye = jnp.broadcast_to(jnp.eye(k, dtype=dtype), batch + (k, k))
    return Cpx(eye, jnp.zeros_like(eye))


def _ns_inverse(G: Cpx, iters: int = 16) -> Cpx:
    """Newton-Schulz inverse of Hermitian PD G: Cpx (B, k, k):
    X ← X(2I − GX), X₀ = I / max row-sum norm."""
    k = G.shape[-1]
    batch = G.shape[:-2]
    mag = jnp.sqrt(G.re * G.re + G.im * G.im)
    norm = jnp.max(jnp.sum(mag, axis=-1), axis=-1)
    X = _eye_like(k, batch) * (1.0 / norm[..., None, None])
    two_eye = _eye_like(k, batch) * 2.0
    for _ in range(iters):
        X = _mm(X, two_eye - _mm(G, X))
    return X


def _mgs_cols_cpx(V: Cpx) -> Cpx:
    """Complex modified Gram-Schmidt over the K columns of
    V: Cpx[B, N, K] — exact sequential deflation (the r2-s4 MGS
    finding applies to the complex iteration too: a Gram-based
    orthonormalizer loses the weak direction when closely spaced /
    imbalanced sources make the iterated columns collinear; measured:
    ESPRIT's resolve probability at sep < 4° went 0.00 → 1.00)."""
    K = V.shape[-1]
    cols = []
    for i in range(K):
        vr, vi = V.re[..., :, i], V.im[..., :, i]
        for ur, ui in cols:
            # <u, v> = Σ conj(u)·v, then v ← v − <u,v>·u
            dre = jnp.sum(ur * vr + ui * vi, axis=-1, keepdims=True)
            dim = jnp.sum(ur * vi - ui * vr, axis=-1, keepdims=True)
            vr = vr - (dre * ur - dim * ui)
            vi = vi - (dre * ui + dim * ur)
        inv = jax.lax.rsqrt(jnp.maximum(
            jnp.sum(vr * vr + vi * vi, axis=-1, keepdims=True), 1e-30))
        cols.append((vr * inv, vi * inv))
    return Cpx(jnp.stack([c[0] for c in cols], axis=-1),
               jnp.stack([c[1] for c in cols], axis=-1))


def signal_subspace_cpx(R: Cpx, num_sources: int, iters: int = 16) -> Cpx:
    """Orthonormal COMPLEX signal basis E_s: Cpx[B, N, K] by subspace
    iteration carried in split-complex arithmetic (no embedding — ESPRIT
    needs a complex-paired basis, which the real embedded basis is not).

    Orthonormalization: per-iteration complex modified Gram-Schmidt
    (see _mgs_cols_cpx; the coupled Newton-Schulz chain it replaced
    could not recover closely-spaced sources' weak directions)."""
    K = num_sources
    V = _mgs_cols_cpx(Cpx(R.re[..., :, :K], R.im[..., :, :K]))
    for _ in range(iters):
        V = _mgs_cols_cpx(_mm(R, V))
    return V


def _char_poly_coeffs(Psi: Cpx):
    """Characteristic polynomial of Ψ: Cpx (B, K, K) by Faddeev-LeVerrier.

    Returns ascending coefficients Cpx (B, K+1) of
    p(λ) = λ^K + c_{K-1} λ^{K-1} + ... + c_0 (monic)."""
    K = Psi.shape[-1]
    batch = Psi.shape[:-2]
    eye = _eye_like(K, batch)
    coeffs = []  # c_{K-1}, c_{K-2}, ... c_0
    Mk = eye
    for k in range(1, K + 1):
        AM = _mm(Psi, Mk)
        tr = Cpx(jnp.trace(AM.re, axis1=-2, axis2=-1),
                 jnp.trace(AM.im, axis1=-2, axis2=-1))
        ck = tr * (-1.0 / k)
        coeffs.append(ck)
        # Mk+1 = Ψ·Mk + c_k I  (eye is real identity)
        Mk = AM + Cpx(eye.re * ck.re[..., None, None],
                      eye.re * ck.im[..., None, None])
    # ascending: [c_0, c_1, ..., c_{K-1}, 1]
    asc = coeffs[::-1]
    ones = Cpx(jnp.ones(batch + (1,)), jnp.zeros(batch + (1,)))
    re = jnp.stack([c.re for c in asc], axis=-1)
    im = jnp.stack([c.im for c in asc], axis=-1)
    return Cpx(jnp.concatenate([re, ones.re], -1),
               jnp.concatenate([im, ones.im], -1))


def esprit_cpx(R: Cpx, num_sources: int, norm_spacing: float,
               subspace_iters: int = 16, root_iters: int = 40):
    """LS-ESPRIT: R: Cpx[B, N, N] → DoA f32[B, K] degrees, ascending."""
    Es = signal_subspace_cpx(R, num_sources, iters=subspace_iters)
    Es1 = Cpx(Es.re[:, :-1, :], Es.im[:, :-1, :])
    Es2 = Cpx(Es.re[:, 1:, :], Es.im[:, 1:, :])
    G = _gram(Es1)                      # (B, K, K) Hermitian PD
    Ginv = _ns_inverse(G)
    Psi = _mm(Ginv, _mm(_herm(Es1), Es2))
    coeffs = _char_poly_coeffs(Psi)
    lam = polynomial_roots_cpx(coeffs, num_iters=root_iters)  # (B, K)
    cos_theta = jnp.clip(-lam.angle() / (2 * jnp.pi * norm_spacing),
                         -1.0, 1.0)
    theta = jnp.rad2deg(jnp.arccos(cos_theta))
    return jnp.sort(theta, axis=-1)


def _eig_small_cpx(Psi: Cpx, root_iters: int = 40):
    """Eigenvalues AND eigenvectors of a small (K ≤ 4) batched complex
    matrix, eig-free (JAX lowers `eig` only on the CPU):

      * eigenvalues: characteristic polynomial (Faddeev-LeVerrier)
        rooted with the batched Aberth-Ehrlich iterator;
      * eigenvectors: Cayley-Hamilton products — for diagonalizable Ψ
        with eigenvalues λ₁..λ_K,  Π_{j≠i}(Ψ − λ_j I)  maps any generic
        vector onto the λ_i eigenspace, so t_i = Π_{j≠i}(Ψ − λ_j I)·𝟙
        (normalized per factor to keep magnitudes bounded).

    → (lam Cpx(B, K), T Cpx(B, K, K) columns = eigenvectors).
    Assumes distinct eigenvalues (sources with distinct first-axis
    direction cosines — the standard 2-D ESPRIT identifiability
    condition)."""
    K = Psi.shape[-1]
    B = Psi.shape[:-2]
    coeffs = _char_poly_coeffs(Psi)
    lam = polynomial_roots_cpx(coeffs, num_iters=root_iters)
    eye = _eye_like(K, B)
    cols = []
    for i in range(K):
        v = Cpx(jnp.ones(B + (K, 1)), jnp.zeros(B + (K, 1)))
        for j in range(K):
            if j == i:
                continue
            lj_re = lam.re[..., j][..., None, None]
            lj_im = lam.im[..., j][..., None, None]
            M = Cpx(Psi.re - eye.re * lj_re, Psi.im - eye.re * lj_im)
            v = _mm(M, v)
            nrm = jnp.sqrt(jnp.sum(v.re * v.re + v.im * v.im,
                                   axis=-2, keepdims=True))
            v = Cpx(v.re / jnp.maximum(nrm, 1e-30),
                    v.im / jnp.maximum(nrm, 1e-30))
        cols.append(v)
    T = Cpx(jnp.concatenate([c.re for c in cols], axis=-1),
            jnp.concatenate([c.im for c in cols], axis=-1))
    return lam, T


def esprit_2d_cpx(R: Cpx, num_sources: int, norm_spacing: float,
                  shape, subspace_iters: int = 16, root_iters: int = 40):
    """2-D LS-ESPRIT for a uniform rectangular array (grid-free az/el —
    beyond the reference, which has no 2-D estimator at all).

    R: Cpx[B, N, N] with N = nx·ny (x-major flattening, matching
    ops.steering.ura_steering) → (az_deg, el_deg) each f32[B, K],
    pairs aligned, sorted by azimuth.

    Two shift invariances of the signal subspace: along x (drop last /
    first element row) and along y (column). Ψx's eigen-decomposition
    (char-poly + Aberth + Cayley-Hamilton eigenvectors — eig-free)
    gives the x direction cosines AND the mixing matrix T; the y
    eigenvalues PAIR automatically as Rayleigh quotients
    μy_i = t_iᴴ(Ψy t_i)/t_iᴴt_i — valid because Ψx and Ψy share
    eigenvectors (both equal T⁻¹·diag·T for the same source mixing T).
    Identifiability needs distinct x-cosines; sources sharing ux are a
    documented limitation of this family (use the hierarchical 2-D
    scan there)."""
    nx, ny = shape
    K = num_sources
    Es = signal_subspace_cpx(R, K, iters=subspace_iters)
    B = Es.shape[0]

    def sel(plane, axis, lo):
        r = plane.reshape(B, nx, ny, K)
        if axis == 0:
            r = r[:, :-1] if lo else r[:, 1:]
            return r.reshape(B, (nx - 1) * ny, K)
        r = r[:, :, :-1] if lo else r[:, :, 1:]
        return r.reshape(B, nx * (ny - 1), K)

    def psi(axis):
        E1 = Cpx(sel(Es.re, axis, True), sel(Es.im, axis, True))
        E2 = Cpx(sel(Es.re, axis, False), sel(Es.im, axis, False))
        Ginv = _ns_inverse(_gram(E1))
        return _mm(Ginv, _mm(_herm(E1), E2))

    Psix = psi(0)
    Psiy = psi(1)
    lamx, T = _eig_small_cpx(Psix, root_iters=root_iters)
    W = _mm(Psiy, T)
    # paired y eigenvalues: per-column Rayleigh quotient ⟨t_i, w_i⟩/⟨t_i, t_i⟩
    nre = jnp.sum(T.re * W.re + T.im * W.im, axis=-2)
    nim = jnp.sum(T.re * W.im - T.im * W.re, axis=-2)
    den = jnp.maximum(jnp.sum(T.re * T.re + T.im * T.im, axis=-2), 1e-30)
    muy = Cpx(nre / den, nim / den)                  # (B, K)

    # steering phase = −2πd(ux·ix + uy·iy) ⇒ shift factor e^{−j2πd·u}
    scale = 2.0 * jnp.pi * norm_spacing
    ux = -lamx.angle() / scale
    uy = -muy.angle() / scale
    az = jnp.rad2deg(jnp.arctan2(ux, uy))
    r = jnp.sqrt(ux * ux + uy * uy)
    el = jnp.rad2deg(jnp.arccos(jnp.clip(r, 0.0, 1.0)))
    order = jnp.argsort(az, axis=-1)
    return (jnp.take_along_axis(az, order, axis=-1),
            jnp.take_along_axis(el, order, axis=-1))


# ---------------------------------------------------------------------
# Unitary (real-valued) ESPRIT — Haardt–Nossek. The most matmul-
# friendly member of the family: after one complex→real transform, EVERYTHING
# (subspace iteration, LS invariance, eigenvalues) is real arithmetic —
# half the matmul planes of complex ESPRIT — and forward-backward
# averaging is IMPLICIT in the transform (one coherent pair
# decorrelates with no explicit FB/smoothing pass).
# Golden conventions pinned by tests/golden.py::unitary_esprit.
# ---------------------------------------------------------------------

def _real_signal_subspace(C, num_sources: int, iters: int = 16):
    """Real symmetric batch C: f32[B, N, N] → orthonormal top-K basis
    f32[B, N, K] by subspace iteration (real twin of
    signal_subspace_cpx).

    Schedule hardening (the docs/PERF.md power-schedule lesson applies
    here too — measured: orth-every-2 with a trace-scaled 6-iter NS
    LOST the λ₂ ≈ λ₁/134 direction of an FB-decorrelated coherent
    pair, the exact case Unitary ESPRIT exists for; after one apply at
    that spread the columns are collinear to ~0.008 rad and NS on the
    near-singular Gram never recovers). Cure: fixed random orthonormal
    INIT (O(1) overlap with every eigendirection) and per-iteration
    MODIFIED GRAM-SCHMIDT — exact sequential deflation keeps the weak
    direction at any spread; K is static and tiny, so the unrolled
    K²/2 batched projections cost ~nothing."""
    import numpy as np

    K = num_sources
    N = C.shape[-1]
    rng = np.random.default_rng(2024)
    V0, _ = np.linalg.qr(rng.standard_normal((N, K)).astype(np.float32))
    V = jnp.broadcast_to(jnp.asarray(V0), C.shape[:-2] + (N, K))

    def mgs(V):
        cols = []
        for i in range(K):
            v = V[..., :, i]
            for u in cols:
                v = v - jnp.sum(u * v, axis=-1, keepdims=True) * u
            v = v / jnp.sqrt(jnp.maximum(
                jnp.sum(v * v, axis=-1, keepdims=True), 1e-30))
            cols.append(v)
        return jnp.stack(cols, axis=-1)

    for _ in range(iters):
        V = mgs(jnp.einsum("bik,bkj->bij", C, V,
                           preferred_element_type=jnp.float32))
    return V


def unitary_esprit_cpx(R: Cpx, num_sources: int, norm_spacing: float,
                       subspace_iters: int = 16, root_iters: int = 40):
    """Unitary ESPRIT: R: Cpx[B, N, N] → DoA f32[B, K] deg, ascending.

    C = Re(Q_Nᴴ R Q_N) (the real FB covariance — Q host-precomputed);
    real subspace iteration; real LS invariance Υ = (K1 Es)⁺(K2 Es);
    eigenvalues via char-poly + Aberth (real parts — exactly real in
    the noiseless model); μ = −2·arctan(ω), θ = acos(μ/(2πd)).

    Traces under the pipelines' matmul precision (cpx.MATMUL_PRECISION)
    even when called standalone."""
    import numpy as np

    from doa_tpu import cpx

    N = R.shape[-1]
    K = num_sources
    QN = _unitary_q_np(N)
    QN1 = _unitary_q_np(N - 1)
    J2 = np.zeros((N - 1, N), np.float32)
    J2[np.arange(N - 1), np.arange(1, N)] = 1.0
    Mk = QN1.conj().T @ J2 @ QN                      # (N-1, N) complex
    K1 = jnp.asarray(2.0 * Mk.real.astype(np.float32))
    K2 = jnp.asarray(2.0 * Mk.imag.astype(np.float32))
    Qr = jnp.asarray(QN.real.astype(np.float32))
    Qi = jnp.asarray(QN.imag.astype(np.float32))

    with jax.default_matmul_precision(cpx.MATMUL_PRECISION):
        # C = Re(Qᴴ R Q) = Qrᵀ(Rr Qr − Ri Qi) + Qiᵀ(Ri Qr + Rr Qi)
        rmm = lambda a, b: jnp.einsum(  # noqa: E731
            "bij,jk->bik", a, b, preferred_element_type=jnp.float32)
        lmm = lambda a, b: jnp.einsum(  # noqa: E731
            "ij,bjk->bik", a, b, preferred_element_type=jnp.float32)
        T1 = rmm(R.re, Qr) - rmm(R.im, Qi)
        T2 = rmm(R.im, Qr) + rmm(R.re, Qi)
        C = lmm(Qr.T, T1) + lmm(Qi.T, T2)            # (B, N, N) real sym
        C = 0.5 * (C + jnp.swapaxes(C, -1, -2))
        Es = _real_signal_subspace(C, K, iters=subspace_iters)
        A1 = lmm(K1, Es)                             # (B, N-1, K)
        A2 = lmm(K2, Es)
        G = jnp.einsum("bnk,bnl->bkl", A1, A1,
                       preferred_element_type=jnp.float32)
        Ginv = _ns_inverse(Cpx(G, jnp.zeros_like(G)))
        AtA2 = jnp.einsum("bnk,bnl->bkl", A1, A2,
                          preferred_element_type=jnp.float32)
        Ups = jnp.einsum("bkl,blm->bkm", Ginv.re, AtA2,
                         preferred_element_type=jnp.float32)
        coeffs = _char_poly_coeffs(Cpx(Ups, jnp.zeros_like(Ups)))
        lam = polynomial_roots_cpx(coeffs, num_iters=root_iters)
    mu = -2.0 * jnp.arctan(lam.re)                   # (B, K) real eigs
    cos_theta = jnp.clip(mu / (2.0 * jnp.pi * norm_spacing), -1.0, 1.0)
    return jnp.sort(jnp.rad2deg(jnp.arccos(cos_theta)), axis=-1)


def _unitary_q_np(N: int):
    """Host Q_N construction (tests/golden.py::unitary_q is the pinned
    twin)."""
    import numpy as np

    m = N // 2
    I = np.eye(m)
    P = I[::-1]
    if N % 2 == 0:
        top = np.concatenate([I, 1j * I], axis=1)
        bot = np.concatenate([P, -1j * P], axis=1)
        return np.concatenate([top, bot], axis=0) / np.sqrt(2)
    z = np.zeros((m, 1))
    top = np.concatenate([I, z, 1j * I], axis=1)
    mid = np.concatenate([z.T, [[np.sqrt(2)]], z.T], axis=1)
    bot = np.concatenate([P, z, -1j * P], axis=1)
    return np.concatenate([top, mid, bot], axis=0) / np.sqrt(2)
