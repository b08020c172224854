"""Bartlett (conventional delay-and-sum) beamformer spectrum.

The classic non-adaptive scan P(θ) = Re(aᴴ R a) — the baseline every
DoA toolbox carries next to Capon/MUSIC (upstream gr-doa users get it
from stock GNU Radio beamforming blocks; SURVEY §2's estimator family).
No inverse, no subspace: robust at any snapshot count and the natural
sanity-check spectrum when MUSIC's model order is wrong.

Complex path here; the split-complex form is
`cpx_ops.bartlett_spectrum_cpx` (one flattened matmul).
"""

from __future__ import annotations

import jax.numpy as jnp


def bartlett_spectrum(R, steering_mat, normalize: bool = True):
    """R: (B, N, N) complex, steering_mat: (G, N) → f32[B, G].

    Quadratic form per grid angle; per-snapshot max-normalized like the
    reference's MUSIC output (unit-modulus steering makes the classic
    1/‖a‖⁴ factor a grid constant)."""
    T = jnp.einsum("bnm,gm->bgn", R, steering_mat)
    P = jnp.einsum("gn,bgn->bg", steering_mat.conj(), T).real
    if normalize:
        P = P / jnp.max(P, axis=-1, keepdims=True)
    return P
