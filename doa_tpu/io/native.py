"""ctypes bridge to the native ingest framer (native/framer.cpp).

Builds the shared library on first use (g++ -O3, cached next to the
source); falls back to numpy transparently if no toolchain is available,
so the package works everywhere and is merely faster where it can be.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_LIB_LOCK = threading.Lock()
_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "framer.cpp")
_DEFAULT_THREADS = min(8, os.cpu_count() or 1)


def _build_and_load():
    # The .so is never committed (gitignored): it is always built locally.
    # A sidecar stamp records that THIS machine built it — a binary that
    # appeared any other way (copied checkout, container image) is rebuilt
    # rather than trusted, so a foreign-microarch binary can't SIGILL the
    # hot ingest path. -march=native is safe under that invariant.
    so_path = os.path.join(os.path.dirname(_SRC), "libdoaframer.so")
    stamp = so_path + ".stamp"
    stamp_want = f"{os.uname().machine}:{os.uname().nodename}"
    fresh = (os.path.exists(so_path) and os.path.exists(stamp)
             and os.path.getmtime(so_path) >= os.path.getmtime(_SRC))
    if fresh:
        with open(stamp) as f:
            fresh = f.read().strip() == stamp_want
    if not fresh:
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-o", so_path, _SRC, "-lpthread"]
        subprocess.run(cmd, check=True, capture_output=True)
        with open(stamp, "w") as f:
            f.write(stamp_want)
    lib = ctypes.CDLL(so_path)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.doa_split_c64.argtypes = [fp, fp, fp, ctypes.c_int64, ctypes.c_int]
    lib.doa_merge_c64.argtypes = [fp, fp, fp, ctypes.c_int64, ctypes.c_int]
    lib.doa_frame_block.argtypes = [fp, ctypes.c_int64, fp, ctypes.c_int64,
                                    ctypes.c_int64, fp, fp, ctypes.c_int]
    lib.doa_frame_block.restype = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.doa_udp_drain.argtypes = [ctypes.c_int, u8p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int, i64p]
    lib.doa_udp_drain.restype = ctypes.c_int64
    lib.doa_udp_send.argtypes = [ctypes.c_int, u8p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64]
    lib.doa_udp_send.restype = ctypes.c_int64
    return lib


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                try:
                    _LIB = _build_and_load()
                except Exception:
                    _LIB = False
    return _LIB or None


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def split_c64(x: np.ndarray, threads: int = 0):
    """x: complex64 array (any shape, C-contiguous) → (re, im) f32 arrays.

    One native pass when the library is available; numpy fallback
    otherwise."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    lib = get_lib()
    if lib is None:
        return (np.ascontiguousarray(x.real, dtype=np.float32),
                np.ascontiguousarray(x.imag, dtype=np.float32))
    re = np.empty(x.shape, np.float32)
    im = np.empty(x.shape, np.float32)
    lib.doa_split_c64(
        _fp(x.view(np.float32)), _fp(re), _fp(im), x.size,
        threads or _DEFAULT_THREADS)
    return re, im


def merge_c64(re: np.ndarray, im: np.ndarray, threads: int = 0):
    """(re, im) f32 planes → interleaved complex64 array."""
    re = np.ascontiguousarray(re, dtype=np.float32)
    im = np.ascontiguousarray(im, dtype=np.float32)
    lib = get_lib()
    if lib is None:
        return (re + 1j * im).astype(np.complex64)
    out = np.empty(re.shape, np.complex64)
    lib.doa_merge_c64(_fp(re), _fp(im), _fp(out.view(np.float32)), re.size,
                      threads or _DEFAULT_THREADS)
    return out


def frame_block(tail: np.ndarray | None, block: np.ndarray,
                threads: int = 0):
    """Assemble [tail; block] (both (t, N) complex64) directly into split
    planes — the streaming driver's per-block hot call."""
    block = np.ascontiguousarray(block, dtype=np.complex64)
    T, N = block.shape
    overlap = 0 if tail is None else tail.shape[0]
    lib = get_lib()
    if lib is None:
        x = block if tail is None else np.concatenate([tail, block], 0)
        return split_c64(x, threads)
    re = np.empty((overlap + T, N), np.float32)
    im = np.empty((overlap + T, N), np.float32)
    tail_c = (np.ascontiguousarray(tail, np.complex64) if overlap
              else np.empty((0, N), np.complex64))
    lib.doa_frame_block(
        _fp(tail_c.view(np.float32)), overlap,
        _fp(block.view(np.float32)), T, N,
        _fp(re), _fp(im), threads or _DEFAULT_THREADS)
    return re, im


def quantize_interleaved_int8(xil, clip_sigma: float = 6.0):
    """Interleaved f32 sample rows → (int8 rows, scale) for the int8
    ingest mode (`cov_dtype="int8"`, interleaved path).

    q = round(clip(x, ±A)·127/A), A = clip_sigma·RMS — a symmetric
    mid-tread quantizer matching a real int8 ADC driven at
    `clip_sigma` sigmas of headroom. The returned scale (127/A) is
    informational only: the quantized covariance is scale²·R and every
    downstream consumer is scale-invariant (docs/ACCURACY.md r5).
    Accepts numpy or jax arrays; computes on whichever device the
    input lives on."""
    import jax.numpy as jnp

    rms = jnp.sqrt(jnp.mean(jnp.square(xil)))
    A = clip_sigma * jnp.maximum(rms, 1e-30)
    s = 127.0 / A
    q = jnp.clip(jnp.round(xil * s), -127, 127).astype(jnp.int8)
    return q, s
