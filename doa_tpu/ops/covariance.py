"""Snapshot covariance estimation (reference `autocorrelate`, SURVEY §2.1 C1).

The reference consumes N coherent streams and, per output item, forms a
(snapshot_size × N) matrix X and emits the sample covariance R = E[x x^H]
(R_ij = (1/S) Σ_s x_si conj(x_sj)), with `overlap_size`
sliding windows and optional forward-backward averaging. Here the stream
becomes an array `x: c64[T, N]` and ALL windows are produced at once as
`R: c64[B, N, N]` — one batched Gram matmul instead of a
per-item hot loop.

Two formulations:

  * `frame_samples` + `sample_covariance`: materialize frames (B, S, N) and
    batch the Gram products. Simple; duplicates data by S/hop when
    overlapping.
  * `cov_from_stream`: when hop | S, computes per-hop-chunk Grams
    C_j = X_j^H X_j once (zero duplication) and combines each window's
    R_b = Σ_{j=b}^{b+S/hop-1} C_j by a sliding sum over chunk index — the
    overlap-save trick. This is the formulation the streaming and
    time-sharded paths build on: chunk Grams are associative partial sums,
    so sharding the time axis only needs a `psum`/segment reduction over
    chunks (SURVEY §2.5 SP row).
"""

from __future__ import annotations

import jax.numpy as jnp


def frame_samples(x, snapshot_size: int, overlap: int):
    """x: (T, N) → frames (B, S, N); window b covers [b*hop, b*hop+S).

    Trailing samples that don't fill a window are dropped (reference
    decimator semantics)."""
    S = snapshot_size
    hop = S - overlap
    T = x.shape[0]
    B = 0 if T < S else (T - S) // hop + 1
    idx = jnp.arange(B)[:, None] * hop + jnp.arange(S)[None, :]
    return x[idx]


def sample_covariance(frames, fb_average: bool = False):
    """frames: (B, S, N) → R: (B, N, N), R_ij = (1/S) Σ_s x_si conj(x_sj)."""
    S = frames.shape[-2]
    R = jnp.einsum(
        "bsi,bsj->bij", frames, frames.conj(),
        preferred_element_type=jnp.complex64,
    ) / S
    if fb_average:
        R = forward_backward(R)
    return R


def cov_from_stream(x, snapshot_size: int, overlap: int,
                    fb_average: bool = False):
    """x: (T, N) → R: (B, N, N) without materializing overlapped frames.

    Requires hop = S - overlap to divide S. Computes one Gram per hop-chunk
    and sliding-sums n_chunks = S/hop consecutive chunk Grams per window.
    """
    S = snapshot_size
    hop = S - overlap
    if S % hop != 0:
        # Irregular overlap: fall back to explicit framing.
        return sample_covariance(frame_samples(x, S, overlap), fb_average)
    n_chunks_per_win = S // hop
    T, N = x.shape
    num_chunks = T // hop
    B = 0 if T < S else (T - S) // hop + 1
    xc = x[: num_chunks * hop].reshape(num_chunks, hop, N)
    C = jnp.einsum(
        "csi,csj->cij", xc, xc.conj(), preferred_element_type=jnp.complex64
    )  # (num_chunks, N, N) chunk Grams
    # Sliding sum of n_chunks_per_win consecutive Grams via prefix sums.
    csum = jnp.concatenate(
        [jnp.zeros((1, N, N), C.dtype), jnp.cumsum(C, axis=0)], axis=0
    )
    R = (csum[n_chunks_per_win : n_chunks_per_win + B] - csum[:B]) / S
    if fb_average:
        R = forward_backward(R)
    return R


def forward_backward(R):
    """R_fb = (R + J conj(R) J)/2 — reference autocorrelate avg_method=1."""
    Rb = jnp.conj(R[..., ::-1, ::-1])
    return 0.5 * (R + Rb)


def spatial_smooth(R, subarray_size: int):
    """Forward spatial smoothing for correlated sources (BASELINE config 3):
    average the N-L+1 principal L×L submatrices. R: (..., N, N) → (..., L, L).

    L and N are static, so the shift loop unrolls at trace time into M
    strided adds XLA fuses into one pass.
    """
    N = R.shape[-1]
    L = subarray_size
    M = N - L + 1
    acc = R[..., 0:L, 0:L]
    for m in range(1, M):
        acc = acc + R[..., m : m + L, m : m + L]
    return acc / M


def streaming_covariance(carry_csum, x_chunk, snapshot_size: int, hop: int):
    """One streaming covariance update step (config 4 sliding-window path).

    carry_csum: (n_win_chunks, N, N) ring of the last S/hop chunk Grams.
    x_chunk: (hop, N) new samples. Returns (new_carry, R) where R is the
    covariance of the latest full window (sum of the ring) / S.

    Functional and jit/scan-friendly: the GNU Radio "history" state becomes
    an explicit carry. hop must divide snapshot_size.
    """
    if snapshot_size % hop != 0:
        raise ValueError("hop must divide snapshot_size for streaming mode")
    C = jnp.einsum(
        "si,sj->ij", x_chunk, x_chunk.conj(),
        preferred_element_type=jnp.complex64,
    )
    new_carry = jnp.concatenate([carry_csum[1:], C[None]], axis=0)
    R = jnp.sum(new_carry, axis=0) / snapshot_size
    return new_carry, R


def init_streaming_carry(num_elements: int, snapshot_size: int, hop: int,
                         dtype=jnp.complex64):
    """Zero-initialized ring of chunk Grams for `streaming_covariance`."""
    return jnp.zeros(
        (snapshot_size // hop, num_elements, num_elements), dtype=dtype
    )
