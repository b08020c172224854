"""Batched Hermitian eigendecomposition and subspace extraction.

Replaces the reference's per-item `arma::eig_sym` calls inside
MUSIC_lin_array / rootMUSIC / calibrate_lin_array work() loops
(SURVEY §2.1 C2-C4) with one batched eigh over the whole snapshot batch.

On an accelerator, complex Hermitian eigh is latency-bound for small N (4..64); the
batch axis B amortizes it (SURVEY §7.3 hard part 1). `jnp.linalg.eigh` is
the default; `eigh_batched` is the single switch point where a custom
batched-Jacobi kernel can be slotted in if profiling shows eigh
dominating.
"""

from __future__ import annotations

import jax.numpy as jnp


def eigh_batched(R):
    """R: (..., N, N) Hermitian → (eigvals ascending (..., N),
    eigvecs (..., N, N) with columns as eigenvectors)."""
    return jnp.linalg.eigh(R)


def noise_subspace(R, num_sources: int):
    """E_n: (..., N, N-K) — eigenvectors of the N-K smallest eigenvalues."""
    _, v = eigh_batched(R)
    N = R.shape[-1]
    return v[..., :, : N - num_sources]


def signal_subspace(R, num_sources: int):
    """E_s: (..., N, K) — eigenvectors of the K largest eigenvalues
    (ascending order → take the trailing columns)."""
    _, v = eigh_batched(R)
    N = R.shape[-1]
    return v[..., :, N - num_sources :]


def principal_eigvec(R):
    """v1: (..., N) — eigenvector of the largest eigenvalue (used by the
    element-calibration estimator, reference calibrate_lin_array C4)."""
    _, v = eigh_batched(R)
    return v[..., :, -1]
