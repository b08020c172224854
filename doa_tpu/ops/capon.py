"""Capon-MVDR pseudospectrum.

Not present in upstream gr-doa, but required by the BASELINE north-star
("MUSIC / Capon-MVDR pseudospectrum scans", SURVEY §0). Same scan shape as
MUSIC with the noise projector replaced by R⁻¹:

    P(theta) = 1 / Re(a^H R⁻¹ a)

R⁻¹ via batched Cholesky solve (R is Hermitian PSD + diagonal loading),
then the identical two-matmul quadratic-form scan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def capon_spectrum(R, steering_mat, diag_load: float = 1e-4,
                   normalize: bool = True):
    """R: (B, N, N), A: (G, N) → Capon-MVDR spectrum f32[B, G].

    diag_load is relative: R + diag_load * (tr(R)/N) * I, stabilizing the
    inverse for snapshot-starved or rank-deficient R."""
    N = R.shape[-1]
    if diag_load > 0:
        tr = jnp.trace(R, axis1=-2, axis2=-1).real / N
        R = R + (diag_load * tr)[..., None, None] * jnp.eye(N, dtype=R.dtype)
    # R = L L^H → a^H R⁻¹ a = ||L⁻¹ a||²: solve L X = A^T (columns a_g).
    cho = jax.lax.linalg.cholesky(R)
    At = jnp.swapaxes(steering_mat, -1, -2)  # (N, G), column g = a_g
    Atb = jnp.broadcast_to(At, R.shape[:-2] + At.shape)
    X = jax.lax.linalg.triangular_solve(
        cho, Atb, left_side=True, lower=True, conjugate_a=False
    )
    den = jnp.sum(jnp.abs(X) ** 2, axis=-2)
    P = 1.0 / jnp.maximum(den, jnp.finfo(jnp.float32).tiny)
    if normalize:
        P = P / jnp.max(P, axis=-1, keepdims=True)
    return P
