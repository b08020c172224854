"""Root-MUSIC for uniform linear arrays (reference `rootMUSIC_linear_array`,
SURVEY §2.1 C3).

The reference roots the noise-subspace polynomial with Armadillo's
companion-matrix eigensolver — a non-Hermitian eig that JAX lowers
only on the CPU (SURVEY §7.3 hard part 2). Instead the polynomial is rooted on-device
with a batched Aberth-Ehrlich simultaneous-root iteration in pure jnp:
fixed iteration count (jit-static), all-root parallel updates, vectorized
over the snapshot batch. Converges super-linearly for the well-separated
conjugate-reciprocal root sets root-MUSIC produces under noise.

Math (pinned by tests/golden.py::root_music):
  C = E_n E_n^H; c_l = Σ_i C[i, i+l] (l-th diagonal sum);
  D(z) = Σ_{l=-(N-1)}^{N-1} c_l z^{l+N-1}, degree 2N-2;
  keep the K roots strictly inside the unit circle closest to it;
  theta = acos(-arg(z) / (2π d)) with a_k = z^k, z = exp(-j 2π d cosθ).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from doa_tpu.ops.music import noise_projector


def _poly_and_deriv(coeffs, z):
    """Evaluate p(z) and p'(z) by Horner. coeffs: (..., D+1) ascending
    powers; z: (..., R). Returns (p, dp) each (..., R)."""
    D = coeffs.shape[-1] - 1
    p = jnp.broadcast_to(coeffs[..., D : D + 1], z.shape).astype(z.dtype)
    dp = jnp.zeros_like(z)
    for m in range(D - 1, -1, -1):  # static unroll: D is config-static
        dp = dp * z + p
        p = p * z + coeffs[..., m : m + 1]
    return p, dp


def polynomial_roots(coeffs, num_iters: int = 60):
    """Batched Aberth-Ehrlich. coeffs: (B, D+1) complex ascending powers
    with nonzero leading coefficient → roots (B, D) complex64.
    """
    D = coeffs.shape[-1] - 1
    # Normalize to monic for numerical range.
    lead = coeffs[..., -1:]
    coeffs = coeffs / lead
    B = coeffs.shape[:-1]
    # Init: slightly-off-circle spiral breaks conjugate symmetry so
    # symmetric root pairs don't stall each other.
    k = jnp.arange(D)
    radius = 0.92 + 0.05 * (k % 3).astype(jnp.float32)
    ang = 2 * jnp.pi * (k + 0.25) / D + 0.1
    z0 = (radius * jnp.exp(1j * ang)).astype(jnp.complex64)
    z0 = jnp.broadcast_to(z0, B + (D,))

    def body(_, z):
        p, dp = _poly_and_deriv(coeffs, z)
        # Newton step; guard p'(z)=0.
        w = p / jnp.where(dp == 0, jnp.ones_like(dp), dp)
        # Pairwise repulsion Σ_{j≠k} 1/(z_k - z_j).
        diff = z[..., :, None] - z[..., None, :]
        eye = jnp.eye(D, dtype=bool)
        inv = jnp.where(eye, 0.0 + 0.0j, 1.0 / jnp.where(eye, 1.0, diff))
        s = jnp.sum(inv, axis=-1)
        denom = 1.0 - w * s
        step = w / jnp.where(denom == 0, jnp.ones_like(denom), denom)
        return z - step

    return jax.lax.fori_loop(0, num_iters, body, z0)


def root_music_coeffs(R, num_sources: int):
    """R: (B, N, N) → polynomial coefficients (B, 2N-1), ascending powers:
    coeffs[.., l+N-1] = Σ diag_l(E_n E_n^H)."""
    N = R.shape[-1]
    C = noise_projector(R, num_sources)
    cols = [
        jnp.trace(C, offset=l, axis1=-2, axis2=-1)
        for l in range(-(N - 1), N)
    ]
    return jnp.stack(cols, axis=-1)


def select_signal_roots(roots, num_sources: int):
    """Keep the K roots strictly inside the unit circle with |z| closest
    to 1 (reference root-selection rule). roots: (B, D) → (B, K)."""
    mag = jnp.abs(roots)
    score = jnp.where(mag < 1.0, 1.0 - mag, jnp.inf)
    _, idx = jax.lax.top_k(-score, num_sources)
    return jnp.take_along_axis(roots, idx, axis=-1)


def root_music(R, num_sources: int, norm_spacing: float,
               num_iters: int = 60):
    """R: (B, N, N) → DoA estimates (B, K) in degrees, ascending."""
    coeffs = root_music_coeffs(R, num_sources)
    roots = polynomial_roots(coeffs, num_iters=num_iters)
    sel = select_signal_roots(roots, num_sources)
    cos_theta = jnp.clip(
        -jnp.angle(sel) / (2 * jnp.pi * norm_spacing), -1.0, 1.0
    )
    theta = jnp.rad2deg(jnp.arccos(cos_theta))
    return jnp.sort(theta, axis=-1)


# ---------------------------------------------------------------------
# Split-complex (Cpx) variant — the production pipeline's path. Same math,
# Aberth-Ehrlich carried on (re, im) planes.
# ---------------------------------------------------------------------

def _poly_and_deriv_cpx(coeffs, z):
    """coeffs: Cpx(..., D+1) ascending; z: Cpx(..., R) → (p, dp)."""
    from doa_tpu.cpx import Cpx

    D = coeffs.shape[-1] - 1
    p = Cpx(jnp.broadcast_to(coeffs.re[..., D : D + 1], z.shape),
            jnp.broadcast_to(coeffs.im[..., D : D + 1], z.shape))
    dp = Cpx(jnp.zeros_like(z.re), jnp.zeros_like(z.im))
    for m in range(D - 1, -1, -1):
        dp = dp * z + p
        p = p * z + coeffs[..., m : m + 1]
    return p, dp


def polynomial_roots_cpx(coeffs, num_iters: int = 60):
    """Batched Aberth-Ehrlich on split-complex planes.
    coeffs: Cpx(B, D+1) → roots Cpx(B, D)."""
    from doa_tpu.cpx import Cpx

    D = coeffs.shape[-1] - 1
    lead = coeffs[..., -1:]
    coeffs = coeffs / lead
    B = coeffs.shape[:-1]
    k = jnp.arange(D, dtype=jnp.float32)
    radius = 0.92 + 0.05 * (k % 3)
    ang = 2 * jnp.pi * (k + 0.25) / D + 0.1
    z0 = Cpx(jnp.broadcast_to(radius * jnp.cos(ang), B + (D,)),
             jnp.broadcast_to(radius * jnp.sin(ang), B + (D,)))

    def body(_, z):
        p, dp = _poly_and_deriv_cpx(coeffs, z)
        dp_ok = dp.abs2() > 0
        dp = Cpx(jnp.where(dp_ok, dp.re, 1.0), jnp.where(dp_ok, dp.im, 0.0))
        w = p / dp
        dr = z.re[..., :, None] - z.re[..., None, :]
        di = z.im[..., :, None] - z.im[..., None, :]
        eye = jnp.eye(D, dtype=bool)
        d2 = dr * dr + di * di
        d2 = jnp.where(eye, 1.0, d2)
        inv = Cpx(jnp.where(eye, 0.0, dr / d2), jnp.where(eye, 0.0, -di / d2))
        s = Cpx(jnp.sum(inv.re, axis=-1), jnp.sum(inv.im, axis=-1))
        ws = w * s
        denom = Cpx(1.0 - ws.re, -ws.im)
        ok = denom.abs2() > 0
        denom = Cpx(jnp.where(ok, denom.re, 1.0), jnp.where(ok, denom.im, 0.0))
        step = w / denom
        return z - step

    return jax.lax.fori_loop(0, num_iters, body, z0)


def root_music_cpx(R, num_sources: int, norm_spacing: float,
                   num_iters: int = 60, noise_proj=None):
    """Cpx[B, N, N] covariance → DoA (B, K) degrees ascending — complex-free.

    `noise_proj` (Cpx[B, N, N]) reuses a projector computed elsewhere
    (e.g. from the power-iteration signal subspace); None → eigh path."""
    from doa_tpu.cpx import Cpx
    from doa_tpu.ops.cpx_ops import noise_projector_cpx

    N = R.shape[-1]
    M = noise_proj if noise_proj is not None else noise_projector_cpx(
        R, num_sources)
    cols_r = [jnp.trace(M.re, offset=l, axis1=-2, axis2=-1)
              for l in range(-(N - 1), N)]
    cols_i = [jnp.trace(M.im, offset=l, axis1=-2, axis2=-1)
              for l in range(-(N - 1), N)]
    coeffs = Cpx(jnp.stack(cols_r, -1), jnp.stack(cols_i, -1))
    roots = polynomial_roots_cpx(coeffs, num_iters=num_iters)
    mag = jnp.sqrt(roots.abs2())
    score = jnp.where(mag < 1.0, 1.0 - mag, jnp.inf)
    _, idx = jax.lax.top_k(-score, num_sources)
    sel = Cpx(jnp.take_along_axis(roots.re, idx, axis=-1),
              jnp.take_along_axis(roots.im, idx, axis=-1))
    cos_theta = jnp.clip(
        -sel.angle() / (2 * jnp.pi * norm_spacing), -1.0, 1.0)
    theta = jnp.rad2deg(jnp.arccos(cos_theta))
    return jnp.sort(theta, axis=-1)
