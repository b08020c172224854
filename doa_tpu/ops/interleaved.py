"""Interleaved-ingest covariance: raw IQ rows → embedded E(R), plain XLA.

A C-ordered complex64 capture (T, N) is, byte for byte, the f32
sequence [t0c0.re, t0c0.im, t0c1.re, …]. The ingest buffer is that
capture viewed as f32[T/TPACK, 2N·TPACK] (TPACK time steps per row): a
free reshape on the host and on the device, so the pipeline reads the
receiver's buffer as it is, with no re/im deinterleave pass.

Per gcd(S, hop)-sample chunk the covariance stage is one Gram of the
interleaved real sample vectors u_t = [re₀, im₀, re₁, im₁, …]:

    U_c = Σ_t u_t u_tᵀ        (2N, 2N), a strided-batched GEMM

windows are sliding sums of chunk Grams (exact for any 0 ≤ overlap < S),
and the complex covariance planes are strided slices of U:

    Rr = U[re, re] + U[im, im],    Ri = U[im, re] − U[re, im].

Correction ((c cᴴ) ∘ R), forward-backward averaging and the real
embedding then run on the (B, N, N) window stack.

Reference semantics: autocorrelate (SURVEY §2.1 C1) — snapshot windows,
overlap via hop-aligned chunks, optional FB averaging; antenna_correction
(C5) folded per the covariance identity cov(diag(c)x) = (c cᴴ) ∘ cov(x).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from doa_tpu.cpx import Cpx, embed_hermitian
from doa_tpu.ops import cpx_ops


def interleave_factor(N: int) -> int:
    """Time steps per ingest row: rows hold 128 floats while 2N ≤ 128
    (the buffer shape the ingest entry points accept), one time step
    otherwise."""
    return max(1, 128 // (2 * N))


def to_interleaved(re, im):
    """Split planes f32[T, N] → interleaved rows f32[T/TPACK, 2N·TPACK]
    (what a raw c64 capture already is; library-path converter)."""
    T, N = re.shape
    tp = interleave_factor(N)
    return jnp.stack([re, im], axis=-1).reshape(T // tp, 2 * N * tp)


def deinterleave(xil, N: int) -> Cpx:
    """Interleaved rows → split planes Cpx f32[T, N]."""
    x = xil.reshape(-1, N, 2).astype(jnp.float32)
    return Cpx(x[..., 0], x[..., 1])


def cov_embedded(xil, cr, ci, *, N: int, snapshot_size: int,
                 overlap: int = 0, fb: bool = False,
                 compute_dtype=jnp.float32):
    """xil: [T/TPACK, 2N·TPACK] interleaved rows (f32, bf16 or int8);
    cr/ci: f32[N] correction → (R Cpx[B, N, N], E(R) f32[B, 2N, 2N]),
    normalized by S, correction and optional FB folded in.

    compute_dtype: float32 (Gram at the pipeline's matmul precision),
    bfloat16 (bf16 operands, f32 accumulation) or int8 (the ingest-
    quantized mode: a pre-quantized int8 buffer, int8×int8→int32 Gram,
    exact; R then carries the quantization scale², which every
    downstream consumer is invariant to)."""
    S = snapshot_size
    hop = S - overlap
    g = math.gcd(S, hop)
    compute_dtype = jnp.dtype(compute_dtype)
    if compute_dtype == jnp.int8:
        if xil.dtype != jnp.int8:
            raise ValueError(
                "cov_dtype='int8' is the INGEST-quantized mode: feed a "
                "pre-quantized int8 buffer "
                "(io.native.quantize_interleaved_int8)")
        acc = jnp.int32
    else:
        xil = xil.astype(compute_dtype)
        acc = jnp.float32
    x = xil.reshape(-1, 2 * N)                       # (T, 2N) free
    T = x.shape[0]
    n = T // g
    B = 0 if T < S else (T - S) // hop + 1
    z = x[: n * g].reshape(n, g, 2 * N)
    U = jnp.einsum("csi,csj->cij", z, z,
                   preferred_element_type=acc).astype(jnp.float32)
    U = cpx_ops.window_sums(U, S // g, hop // g, B)  # (B, 2N, 2N)
    R = Cpx(U[:, 0::2, 0::2] + U[:, 1::2, 1::2],
            U[:, 1::2, 0::2] - U[:, 0::2, 1::2]) * (1.0 / S)
    R = cpx_ops.apply_correction_to_cov(R, Cpx(cr, ci))
    if fb:
        R = cpx_ops.forward_backward_cpx(R)
    return R, embed_hermitian(R)
