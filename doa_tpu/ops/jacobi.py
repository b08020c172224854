"""Batched symmetric eigendecomposition via matmul-only parallel Jacobi.

Why: the covariance matrices here are small (embedded size 2N = 8..128)
but come in large batches (one per snapshot window). LAPACK-style
tridiagonal/QR eigensolvers (what XLA lowers `eigh` to) are sequential and
latency-bound — the known throughput hazard of this workload (SURVEY §7.3
hard part 1). Parallel-ordered cyclic Jacobi instead:

  * each round rotates n/2 DISJOINT pivot pairs simultaneously;
  * the n/2 Givens rotations compose into ONE orthogonal matrix
    Q_round = Σ_k [c_k (E_pp + E_qq) + s_k (E_pq − E_qp)]
    built from static one-hot bases (round-robin tournament schedule);
  * the update A ← Qᵀ A Q and accumulation V ← V Q are batched n×n
    matmuls — all matrix-unit work, no scatters, no per-pair control flow;
  * sweeps have quadratic convergence; `sweeps=10` reaches f32
    machine-precision off-diagonals for n ≤ 128.

Everything is real f32 — used on the 2N real embedding of Hermitian
matrices (doa_tpu.cpx.embed_hermitian), so it runs on the split-complex
path with no complex dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def _round_robin_schedule(n: int) -> np.ndarray:
    """Tournament schedule: (n-1) rounds × (n/2) disjoint pairs covering
    all C(n,2) pairs. Standard circle method; n must be even."""
    assert n % 2 == 0
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        pairs = [(players[i], players[n - 1 - i]) for i in range(n // 2)]
        rounds.append([(min(p, q), max(p, q)) for p, q in pairs])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds)  # (n-1, n/2, 2)


@functools.lru_cache(maxsize=None)
def _schedule_bases(n: int):
    """Static per-round rotation bases:
    CE[r]: (n/2, n, n) with E_pp + E_qq per pair,
    SE[r]: (n/2, n, n) with E_pq − E_qp per pair,
    P_idx[r]: (n/2, 2) pivot indices."""
    sched = _round_robin_schedule(n)
    R = sched.shape[0]
    CE = np.zeros((R, n // 2, n, n), np.float32)
    SE = np.zeros((R, n // 2, n, n), np.float32)
    for r in range(R):
        for k, (p, q) in enumerate(sched[r]):
            CE[r, k, p, p] = 1.0
            CE[r, k, q, q] = 1.0
            SE[r, k, p, q] = 1.0
            SE[r, k, q, p] = -1.0
    return sched, CE, SE


def eigh_jacobi(A, sweeps: int = 10):
    """A: f32[..., n, n] symmetric (n even, ≤ ~256) →
    (eigvals f32[..., n] ASCENDING, eigvecs f32[..., n, n] columns).

    Matches jnp.linalg.eigh's convention (ascending, column eigenvectors).
    """
    diag, V = _jacobi_raw(A, sweeps)
    order = jnp.argsort(diag, axis=-1)
    w = jnp.take_along_axis(diag, order, axis=-1)
    V = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return w, V


def subspace_projector_jacobi(A, subspace_dim: int, smallest: bool = True,
                              sweeps: int = 10):
    """Projector onto the span of the `subspace_dim` smallest- (or
    largest-) eigenvalue eigenvectors of symmetric A: f32[..., n, n],
    WITHOUT sorting/gathering eigenvectors: P = V·diag(w)·Vᵀ with a 0/1
    weight from a top_k rank — stays fully batched and fusion-friendly.
    """
    n = A.shape[-1]
    sched, CE_np, SE_np = _schedule_bases(n)
    # run Jacobi without the final sort (cheaper fusion path)
    w, V = _jacobi_raw(A, sweeps)
    sel = -w if smallest else w
    kth = jax.lax.top_k(sel, subspace_dim)[0][..., -1:]
    weight = (sel >= kth).astype(A.dtype)
    # Guard ties: normalize count to exactly subspace_dim is unnecessary —
    # eigenvalue pairs are either both in or both out for embedded
    # Hermitian inputs (doubled spectrum).
    return jnp.einsum("...mk,...k,...nk->...mn", V, weight, V,
                      preferred_element_type=jnp.float32)


def _jacobi_raw(A, sweeps: int):
    """Jacobi iterations without eigen-sorting: returns (diag, V)."""
    n = A.shape[-1]
    sched, CE_np, SE_np = _schedule_bases(n)
    R = sched.shape[0]
    p_idx = jnp.asarray(sched[..., 0])
    q_idx = jnp.asarray(sched[..., 1])
    CE = jnp.asarray(CE_np)
    SE = jnp.asarray(SE_np)
    batch = A.shape[:-2]
    A0 = A.reshape((-1, n, n))
    B = A0.shape[0]
    V0 = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), (B, n, n))

    def round_step(r, AV):
        Acur, Vcur = AV
        p = p_idx[r]
        q = q_idx[r]
        app = Acur[:, p, p]
        aqq = Acur[:, q, q]
        apq = Acur[:, p, q]
        small = jnp.abs(apq) <= 1e-30
        tau = (aqq - app) / jnp.where(small, 1.0, 2.0 * apq)
        t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(small, 0.0, t)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        s = t * c
        Q = (jnp.einsum("bk,kmn->bmn", c, CE[r],
                        preferred_element_type=jnp.float32)
             + jnp.einsum("bk,kmn->bmn", s, SE[r],
                          preferred_element_type=jnp.float32))
        QT = jnp.swapaxes(Q, -1, -2)
        Anew = jnp.einsum("bmn,bnk,bkl->bml", QT, Acur, Q,
                          preferred_element_type=jnp.float32)
        Anew = 0.5 * (Anew + jnp.swapaxes(Anew, -1, -2))
        Vnew = jnp.einsum("bmn,bnk->bmk", Vcur, Q,
                          preferred_element_type=jnp.float32)
        return (Anew, Vnew)

    def sweep(_, AV):
        return jax.lax.fori_loop(0, R, round_step, AV)

    Af, Vf = jax.lax.fori_loop(0, sweeps, sweep, (A0, V0))
    diag = jnp.diagonal(Af, axis1=-2, axis2=-1)
    return (diag.reshape(*batch, n),
            Vf.reshape(*batch, n, n))
