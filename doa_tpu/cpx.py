"""Split-complex arithmetic: complex tensors as (re, im) float pairs.

Why it exists (SURVEY §7.3 hard part 3): complex matmuls decompose into
real matmuls anyway; doing the split explicitly lets us use the
3-multiplication Gauss/Karatsuba form (25% fewer multiply flops than the
4-matmul lowering) and pick bf16/f32 per plane. Whether complex64 XLA
would serve as well on the GPU is ROADMAP design debt 3.

The production path (pipeline_tpu) runs entirely on `Cpx` pairs; the
jnp-complex modules in doa_tpu.ops remain the reference path. `Cpx` is
a pytree, so it passes through jit, shard_map, scan, etc.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Cpx(NamedTuple):
    """A complex tensor as two same-shape real tensors."""

    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    # -- constructors -------------------------------------------------
    @staticmethod
    def from_complex(x) -> "Cpx":
        """Host-side split (numpy input) or device-side (jnp complex)."""
        if isinstance(x, np.ndarray) or np.isscalar(x):
            x = np.asarray(x)
            return Cpx(jnp.asarray(x.real.astype(np.float32)),
                       jnp.asarray(x.imag.astype(np.float32)))
        return Cpx(jnp.real(x).astype(jnp.float32),
                   jnp.imag(x).astype(jnp.float32))

    def to_complex(self):
        """→ jnp complex64 (only call on CPU/complex-capable backends)."""
        return self.re.astype(jnp.complex64) + 1j * self.im.astype(
            jnp.complex64)

    def to_numpy(self) -> np.ndarray:
        return (np.asarray(self.re).astype(np.complex64)
                + 1j * np.asarray(self.im).astype(np.complex64))

    # -- elementwise --------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Cpx):
            return Cpx(self.re + o.re, self.im + o.im)
        return Cpx(self.re + o, self.im)

    def __sub__(self, o):
        if isinstance(o, Cpx):
            return Cpx(self.re - o.re, self.im - o.im)
        return Cpx(self.re - o, self.im)

    def __mul__(self, o):
        if isinstance(o, Cpx):
            return Cpx(self.re * o.re - self.im * o.im,
                       self.re * o.im + self.im * o.re)
        return Cpx(self.re * o, self.im * o)

    def __truediv__(self, o):
        if isinstance(o, Cpx):
            d = o.re * o.re + o.im * o.im
            return Cpx((self.re * o.re + self.im * o.im) / d,
                       (self.im * o.re - self.re * o.im) / d)
        return Cpx(self.re / o, self.im / o)

    def conj(self) -> "Cpx":
        return Cpx(self.re, -self.im)

    def neg(self) -> "Cpx":
        return Cpx(-self.re, -self.im)

    def abs2(self):
        """|z|² (real array)."""
        return self.re * self.re + self.im * self.im

    def abs(self):
        return jnp.sqrt(self.abs2())

    def angle(self):
        return jnp.arctan2(self.im, self.re)

    # -- shape ops ----------------------------------------------------
    def __getitem__(self, idx):
        return Cpx(self.re[idx], self.im[idx])

    def reshape(self, *s):
        return Cpx(self.re.reshape(*s), self.im.reshape(*s))

    def transpose(self, *axes):
        ax = axes if axes else None
        return Cpx(jnp.transpose(self.re, ax), jnp.transpose(self.im, ax))

    def swapaxes(self, a, b):
        return Cpx(jnp.swapaxes(self.re, a, b), jnp.swapaxes(self.im, a, b))

    def astype(self, dt):
        return Cpx(self.re.astype(dt), self.im.astype(dt))


def expj(phase) -> Cpx:
    """exp(j·phase) for a real phase array."""
    return Cpx(jnp.cos(phase), jnp.sin(phase))


def matmul(a: Cpx, b: Cpx, *, gauss: bool = True,
           preferred_element_type=jnp.float32) -> Cpx:
    """Complex matmul on real planes.

    gauss=True uses the 3-multiplication form
        k1 = ar·(br + bi);  k2 = bi·(ar + ai);  k3 = br·(ai − ar)
        re = k1 − k2;       im = k1 + k3
    (3 matmuls instead of 4; the extra adds are elementwise).
    """
    mm = lambda x, y: jnp.matmul(  # noqa: E731
        x, y, preferred_element_type=preferred_element_type)
    if gauss:
        k1 = mm(a.re, b.re + b.im)
        k2 = mm(a.re + a.im, b.im)
        k3 = mm(a.im - a.re, b.re)
        return Cpx(k1 - k2, k1 + k3)
    return Cpx(mm(a.re, b.re) - mm(a.im, b.im),
               mm(a.re, b.im) + mm(a.im, b.re))


def einsum(subscripts: str, a: Cpx, b: Cpx, *, gauss: bool = True,
           preferred_element_type=jnp.float32) -> Cpx:
    """Complex einsum (two operands) via the same 3-mult decomposition."""
    es = lambda x, y: jnp.einsum(  # noqa: E731
        subscripts, x, y, preferred_element_type=preferred_element_type)
    if gauss:
        k1 = es(a.re, b.re + b.im)
        k2 = es(a.re + a.im, b.im)
        k3 = es(a.im - a.re, b.re)
        return Cpx(k1 - k2, k1 + k3)
    return Cpx(es(a.re, b.re) - es(a.im, b.im),
               es(a.re, b.im) + es(a.im, b.re))


# ---------------------------------------------------------------------
# Hermitian real embedding: C = Cr + j·Ci (Hermitian: Cr sym, Ci antisym)
# ↦ E(C) = [[Cr, -Ci], [Ci, Cr]]  (2N×2N real symmetric).
# E is a *-algebra homomorphism: E(AB) = E(A)E(B), E(A^H) = E(A)^T,
# E(A⁻¹) = E(A)⁻¹, and spectral projectors of E(C) onto eigenvalue
# subsets are embeddings of C's projectors. This is how all Hermitian
# factorizations (eigh, cholesky, inverse) run on real arrays.
# ---------------------------------------------------------------------

def embed_hermitian(c: Cpx):
    """(..., N, N) Cpx → (..., 2N, 2N) real symmetric embedding."""
    top = jnp.concatenate([c.re, -c.im], axis=-1)
    bot = jnp.concatenate([c.im, c.re], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def unembed_hermitian(m) -> Cpx:
    """(..., 2N, 2N) real embedding → (..., N, N) Cpx. Averages the two
    redundant copies for numerical symmetry."""
    N = m.shape[-1] // 2
    re = 0.5 * (m[..., :N, :N] + m[..., N:, N:])
    im = 0.5 * (m[..., N:, :N] - m[..., :N, N:])
    return Cpx(re, im)


def embed_vector(v: Cpx):
    """(..., N) Cpx → (..., 2N) real: [re; im] stacking matching
    embed_hermitian's convention (E(C)·ṽ = embed of C·v)."""
    return jnp.concatenate([v.re, v.im], axis=-1)


def f32_matmuls(fn):
    """Trace `fn` under jax.default_matmul_precision(MATMUL_PRECISION).

    On the GPU a float32 matmul at JAX's DEFAULT precision may run as
    one TF32 tensor-core pass (10-bit mantissa, ~3 decimal digits).
    That is too coarse for the value-carrying stages: a Gram rounded at
    that level biases R by ~0.1-1% relative, and the subspace iteration
    then converges to wrong subspaces on structured signals (the same
    failure class was measured on an earlier accelerator with a
    single-pass bf16 matmul — PERF.md "Precision"). CPU tests compute
    in exact f32 and cannot see it. Every compiled pipeline body in
    this package traces under this scope; explicit bf16/int8 operands
    (compute_dtype / cov_dtype) keep their own precision."""
    import functools
    import jax as _jax

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _jax.default_matmul_precision(MATMUL_PRECISION):
            return fn(*args, **kwargs)

    return wrapped


# The one precision setting for the pipelines' float32 matmuls. "highest"
# is true f32 (CUDA-core FMA on the GPU): the stages are small-matrix
# and bandwidth-bound (a 32×32 Gram over 1024 rows is ~16 flop/byte), so
# it costs little. "tensorfloat32" (one TF32 pass) is the cheaper
# alternative; chip_smoke.py's precision phase times both and reports
# the angle error of each.
MATMUL_PRECISION = "highest"
