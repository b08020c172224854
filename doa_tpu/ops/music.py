"""MUSIC pseudospectrum scan (reference `MUSIC_lin_array`, SURVEY §2.1 C2).

P(theta) = 1 / ||E_n^H a(theta)||², scanned over a precomputed steering
matrix A: (G, N), batched over snapshots: P: f32[B, G].

Formulation: form the Hermitian noise projector M = E_n E_n^H once per
snapshot (O(N³), tiny) and evaluate the quadratic form
    den[b, g] = a_g^H M_b a_g = Σ_ij conj(A)[g,i] M[b,i,j] A[g,j]
as two matmuls: T = conj(A) @ M  (G×N · N×N), then row-dot with A.
This keeps the scan's inner shapes (G, N)×(N, N) — matmul-shaped for large G
regardless of how many sources K there are (a bf16 scan follows the
fork's Connex fixed-point scan precedent, SURVEY §2.2 F1).
"""

from __future__ import annotations

import jax.numpy as jnp

from doa_tpu.ops.subspace import noise_subspace


def noise_projector(R, num_sources: int):
    """M = E_n E_n^H: (..., N, N) Hermitian projector onto the noise
    subspace. Equivalently I - E_s E_s^H (used when K << N)."""
    En = noise_subspace(R, num_sources)
    return jnp.einsum(
        "...nm,...km->...nk", En, En.conj(),
        preferred_element_type=jnp.complex64,
    )


def music_spectrum_from_projector(M, steering_mat, normalize: bool = True):
    """M: (B, N, N) noise projector; steering_mat A: (G, N) → P: f32[B, G].

    den = Re(a^H M a) ≥ 0; P = 1/den, optionally per-snapshot
    max-normalized (the reference normalizes the output pseudospectrum to
    its maximum)."""
    T = jnp.einsum(
        "gn,bnm->bgm", steering_mat.conj(), M,
        preferred_element_type=jnp.complex64,
    )
    den = jnp.sum(T * steering_mat[None], axis=-1).real
    # den can only vanish if a lies exactly in the signal subspace; guard
    # against division blowup at machine precision.
    P = 1.0 / jnp.maximum(den, jnp.finfo(jnp.float32).tiny)
    if normalize:
        P = P / jnp.max(P, axis=-1, keepdims=True)
    return P


def music_spectrum(R, steering_mat, num_sources: int, normalize: bool = True):
    """R: (B, N, N), steering A: (G, N) → MUSIC pseudospectrum f32[B, G]."""
    M = noise_projector(R, num_sources)
    return music_spectrum_from_projector(M, steering_mat, normalize)
