"""Min-Norm (Kumaresan–Tufts) DoA estimation — spectral and root forms.

A classic companion to MUSIC on the same subspace machinery (beyond the
reference's estimator set, like Capon/ESPRIT; golden conventions pinned
by tests/golden.py::min_norm_spectrum): instead of scanning against the
WHOLE noise subspace, Min-Norm scans against the single minimum-norm
vector w that (a) lies in the noise subspace and (b) has first element
1:

    w = Pn e1 / (e1ᴴ Pn e1),   Pn = E_n E_nᴴ = I − E_s E_sᴴ
    P(θ) = 1 / |a(θ)ᴴ w|²

Properties that earn it a slot: its extraneous polynomial zeros are
pulled strictly INSIDE the unit circle (signal zeros sit on it), which
makes the rooted form (`root_min_norm`) well separated, and the spectral
scan is O(B·G·N) — N/(2K)× cheaper than even the signal-subspace MUSIC
scan, since the whole subspace collapses into ONE vector per window.

Split-complex formulation: w comes from the embedded signal basis V (B, 2N, 2K)
of the power/subspace iteration with two tiny batched contractions (no
eigh, no N×N projector): Pn ẽ1 = ẽ1 − V (Vᵀ ẽ1) where Vᵀẽ1 is just
row 0 of V. The scan is two (B, 2N)·(2N, G) matmuls (the real and
imaginary parts of aᴴw via the J-embedding), vs MUSIC's (B·2K, 2N)·
(2N, G).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from doa_tpu.cpx import Cpx
from doa_tpu.ops.music import noise_projector
from doa_tpu.ops.root_music import polynomial_roots


# ---------------------------------------------------------------------
# Complex path (CPU/reference pipeline)
# ---------------------------------------------------------------------

def min_norm_weight(R, num_sources: int):
    """R: (B, N, N) complex → w: (B, N) complex, the minimum-norm
    noise-subspace vector with w[0] = 1."""
    Pn = noise_projector(R, num_sources)             # (B, N, N)
    d = Pn[..., :, 0]                                # Pn e1
    d0 = jnp.maximum(d[..., :1].real, jnp.finfo(jnp.float32).tiny)
    return d / d0


def min_norm_spectrum(R, steering_mat, num_sources: int,
                      normalize: bool = True):
    """R: (B, N, N), steering A: (G, N) → P: f32[B, G].

    P = 1/|aᴴw|², per-window max-normalized like the MUSIC scan."""
    w = min_norm_weight(R, num_sources)
    s = jnp.einsum("gn,bn->bg", steering_mat.conj(), w,
                   preferred_element_type=jnp.complex64)
    den = (s * s.conj()).real
    P = 1.0 / jnp.maximum(den, jnp.finfo(jnp.float32).tiny)
    if normalize:
        P = P / jnp.max(P, axis=-1, keepdims=True)
    return P


def root_min_norm(R, num_sources: int, norm_spacing: float,
                  num_iters: int = 60):
    """Grid-free Min-Norm for a ULA: root W(z) = Σ_n w_n zⁿ (degree
    N−1) and keep the K roots closest to the unit circle (Min-Norm's
    extraneous zeros are strictly inside — Kumaresan–Tufts).
    R: (B, N, N) → angles (B, K) degrees, ascending.

    With the pinned steering convention a_n = exp(−j2πd cosθ·n)
    (tests/golden.py::ula_steering), aᴴw = W(e^{+j2πd cosθ}), so
    cosθ = +arg(z)/(2πd)."""
    w = min_norm_weight(R, num_sources)              # (B, N) ascending
    roots = polynomial_roots(w, num_iters=num_iters)  # (B, N-1)
    score = jnp.abs(1.0 - jnp.abs(roots))
    _, idx = jax.lax.top_k(-score, num_sources)
    sel = jnp.take_along_axis(roots, idx, axis=-1)
    cos_theta = jnp.clip(jnp.angle(sel) / (2 * jnp.pi * norm_spacing),
                         -1.0, 1.0)
    return jnp.sort(jnp.rad2deg(jnp.arccos(cos_theta)), axis=-1)


# ---------------------------------------------------------------------
# Split-complex path (production pipeline — no complex dtype anywhere)
# ---------------------------------------------------------------------

def min_norm_weight_from_signal(V_emb):
    """Embedded signal basis V: f32[B, 2N, 2K] → embedded weight
    w̃: f32[B, 2N] with w̃ = (ẽ1 − V Vᵀẽ1)/(ẽ1ᵀ(I − VVᵀ)ẽ1).

    Vᵀẽ1 is row 0 of V; the denominator e1ᴴPn e1 = 1 − ‖V[0, :]‖² is
    real and ≥ 0 (a projector's diagonal)."""
    v0 = V_emb[..., 0, :]                            # (B, 2K)
    d = -jnp.einsum("bnk,bk->bn", V_emb, v0,
                    preferred_element_type=jnp.float32)
    d = d.at[..., 0].add(1.0)
    d0 = jnp.maximum(d[..., :1], jnp.finfo(jnp.float32).tiny)
    return d / d0


def min_norm_denominator_subspace(V_emb, A: Cpx,
                                  compute_dtype=jnp.float32):
    """den[b, g] = |a_gᴴ w_b|² from the embedded signal basis.

    Re(aᴴw) = ãᵀw̃ and Im(aᴴw) = (J̃ã)ᵀw̃ with ã = [ar; ai],
    J̃ã = [−ai; ar] (the cpx embedding convention) — two (B, 2N)·(2N, G)
    matmuls total."""
    w = min_norm_weight_from_signal(V_emb)           # (B, 2N)
    At = jnp.concatenate([A.re, A.im], axis=-1)      # ã (G, 2N)
    AJt = jnp.concatenate([-A.im, A.re], axis=-1)    # J̃ã (G, 2N)
    if compute_dtype != jnp.float32:
        w = w.astype(compute_dtype)
        At = At.astype(compute_dtype)
        AJt = AJt.astype(compute_dtype)
    s_re = jnp.einsum("bn,gn->bg", w, At,
                      preferred_element_type=jnp.float32)
    s_im = jnp.einsum("bn,gn->bg", w, AJt,
                      preferred_element_type=jnp.float32)
    return s_re * s_re + s_im * s_im


def min_norm_spectrum_subspace(V_emb, A: Cpx, normalize: bool = True,
                               compute_dtype=jnp.float32):
    """Embedded signal basis + Cpx steering → P: f32[B, G]."""
    den = min_norm_denominator_subspace(V_emb, A,
                                        compute_dtype=compute_dtype)
    P = 1.0 / jnp.maximum(den, jnp.finfo(jnp.float32).tiny)
    if normalize:
        P = P / jnp.max(P, axis=-1, keepdims=True)
    return P


def min_norm_weight_cpx(M: Cpx) -> Cpx:
    """Complex noise projector M: Cpx[B, N, N] (eigh path) → w: Cpx[B, N]."""
    d = Cpx(M.re[..., :, 0], M.im[..., :, 0])
    d0 = jnp.maximum(d.re[..., :1], jnp.finfo(jnp.float32).tiny)
    return Cpx(d.re / d0, d.im / d0)


def min_norm_denominator_cpx(M: Cpx, A: Cpx, compute_dtype=jnp.float32):
    """den = |aᴴw|² from the complex noise projector (split planes)."""
    w = min_norm_weight_cpx(M)
    wr, wi, ar, ai = w.re, w.im, A.re, A.im
    if compute_dtype != jnp.float32:
        wr, wi = wr.astype(compute_dtype), wi.astype(compute_dtype)
        ar, ai = ar.astype(compute_dtype), ai.astype(compute_dtype)
    dot = lambda x, y: jnp.einsum(  # noqa: E731
        "bn,gn->bg", x, y, preferred_element_type=jnp.float32)
    s_re = dot(wr, ar) + dot(wi, ai)                 # Re(aᴴw)
    s_im = dot(wi, ar) - dot(wr, ai)                 # Im(aᴴw)
    return s_re * s_re + s_im * s_im
