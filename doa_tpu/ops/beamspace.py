"""DFT beamspace preprocessing (beyond the reference's estimator set).

Projects the N-element space onto Nb < N orthonormal DFT beams covering
a sector before the subspace scan:

    R_b = Bᴴ R B,   ǎ(θ) = Bᴴa(θ) / ‖Bᴴa(θ)‖,
    MUSIC_b: den(θ) = ‖P_n ǎ‖²  (noise-subspace energy fraction ∈ [0,1])

B's columns are Nb columns of the unitary N-point DFT whose spatial
frequencies lie closest to the sector center, so BᴴB = I: beamspace
noise stays white and every narrowband subspace estimator runs
unchanged on (R_b, ǎ) — just in dimension Nb.

Why it earns a slot: the subspace iteration and scans shrink
from N to Nb (the (B, 2N, 2N) covariance tensors and the G×2N scan
matmuls scale down), while in-sector resolution and low-SNR behavior
match element space — the classic thinning for wide-aperture arrays
scanning a known sector. The steering normalization (unit beamspace
norm) is what keeps out-of-sector angles from fake-peaking: an
out-of-sector ǎ is an arbitrary unit vector whose noise-subspace
fraction is O((Nb−K)/Nb), never ≈ 0.

The beam projection happens AFTER the covariance stage (the
element-space covariance is shared with the plain path); root-MUSIC/ESPRIT/Min-Norm keep
element-space semantics and are config-rejected under beamspace.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from doa_tpu.cpx import Cpx


def dft_beam_matrix(num_elements: int, num_beams: int,
                    center_deg: float, norm_spacing: float) -> np.ndarray:
    """Orthonormal DFT beam matrix B: complex64 (N, Nb).

    Beam k (integer DFT index) has spatial frequency k/N (wrapped to
    [−½, ½)); the ULA steering a_n(θ) = exp(−j2πd·cosθ·n) peaks
    b_kᴴa at k/N ≡ −d·cosθ (mod 1), so the Nb beams with wrapped
    frequency closest to −d·cos(center) cover the sector."""
    N, Nb = num_elements, num_beams
    if not (0 < Nb < N):
        raise ValueError("need 0 < num_beams < num_elements")
    u0 = -norm_spacing * np.cos(np.deg2rad(center_deg))
    k = np.arange(N)
    f = ((k / N) + 0.5) % 1.0 - 0.5                      # wrapped to [-1/2, 1/2)
    dist = np.abs(((f - u0) + 0.5) % 1.0 - 0.5)          # circular distance
    sel = np.sort(np.argsort(dist)[:Nb])
    n = np.arange(N)[:, None]
    B = np.exp(-2j * np.pi * n * (k[sel][None, :] / N)) / np.sqrt(N)
    return B.astype(np.complex64)


def beamspace_steering(A: np.ndarray, Bm: np.ndarray,
                       eps: float = 1e-6) -> np.ndarray:
    """Element steering A: (G, N) → UNIT-NORM beamspace steering
    ǎ: (G, Nb). The normalization is load-bearing (see module doc)."""
    Ab = A @ Bm.conj()
    nrm = np.linalg.norm(Ab, axis=-1, keepdims=True)
    return (Ab / np.maximum(nrm, eps)).astype(np.complex64)


def beamspace_covariance(R, Bm):
    """Complex path: R (B, N, N), Bm (N, Nb) → R_b (B, Nb, Nb)."""
    Bj = jnp.asarray(Bm)
    T = jnp.einsum("nk,bnm->bkm", Bj.conj(), R,
                   preferred_element_type=jnp.complex64)
    return jnp.einsum("bkm,ml->bkl", T, Bj,
                      preferred_element_type=jnp.complex64)


def beamspace_cov_cpx(R: Cpx, Bm: np.ndarray) -> Cpx:
    """Split-plane path: R Cpx[B, N, N] → Cpx[B, Nb, Nb] = BᴴRB."""
    from doa_tpu.ops.wideband import cpx_ops_einsum
    Bc = Cpx(jnp.asarray(np.ascontiguousarray(Bm.real, np.float32)),
             jnp.asarray(np.ascontiguousarray(Bm.imag, np.float32)))
    T = cpx_ops_einsum("nk,bnm->bkm", Bc.conj(), R)
    return cpx_ops_einsum("bkm,ml->bkl", T, Bc)


def embed_beam_matrix(Bm: np.ndarray) -> np.ndarray:
    """Real 2N×2Nb embedding B̃ = [[Br, −Bi], [Bi, Br]] matching
    cpx.embed_hermitian's convention, so Ẽ_b = B̃ᵀ Ẽ B̃."""
    Br = Bm.real.astype(np.float32)
    Bi = Bm.imag.astype(np.float32)
    top = np.concatenate([Br, -Bi], axis=1)
    bot = np.concatenate([Bi, Br], axis=1)
    return np.concatenate([top, bot], axis=0)


def beamspace_embedded(E, Bt):
    """Embedded covariance windows E: f32[B, 2N, 2N], B̃: (2N, 2Nb) →
    E_b: f32[B, 2Nb, 2Nb] = B̃ᵀ E B̃ (two batched einsums; shrinks every
    downstream subspace/scan tensor from N to Nb)."""
    Btj = jnp.asarray(Bt)
    T = jnp.einsum("bnm,mk->bnk", E, Btj,
                   preferred_element_type=jnp.float32)
    return jnp.einsum("nk,bnl->bkl", Btj, T,
                      preferred_element_type=jnp.float32)
