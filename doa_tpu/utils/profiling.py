"""Profiling & timing utilities (SURVEY §5 tracing/profiling: the
reference relied on unused GNU Radio perf counters; here tracing is
first-class).

* `trace_to(dir)`: context manager around `jax.profiler` — produces a
  TensorBoard-loadable device trace of the pipeline.
* `Timer`: wall-clock timing with a completion fence. JAX dispatch
  returns before the device finishes; `Timer.fence(x)` blocks until the
  device has produced `x` (`jax.block_until_ready` — on a locally
  attached GPU that is a real fence).
* `throughput_report`: snapshots/s + samples/s from timed runs.
* `use_compile_cache`: the one place scripts set up JAX's persistent
  compilation cache.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import jax

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_compile_cache() -> str:
    """Persistent compilation cache for a script's process. When
    JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set here; otherwise the cache lives in <checkout>/.jax_cache.
    → the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


@contextlib.contextmanager
def trace_to(log_dir: str):
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_summary() -> str:
    """JAX's view of the devices plus the card's name and power limit
    from nvidia-smi (the power limit bounds the clocks under load, so it
    belongs beside every device number)."""
    import subprocess

    d = jax.devices()
    line = (f"platform={d[0].platform} kind={d[0].device_kind} "
            f"count={len(d)}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = ""
    return line + "\n" + (smi or "nvidia-smi: not available")


class Timer:
    def __init__(self):
        self.laps = []
        self._t0 = None

    @staticmethod
    def fence(x) -> None:
        """Completion fence: block until every leaf of `x` is ready."""
        jax.block_until_ready(x)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.laps.append(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        return float(np.mean(self.laps)) if self.laps else float("nan")

    @property
    def best(self) -> float:
        return float(np.min(self.laps)) if self.laps else float("nan")


def throughput_report(seconds_per_call: float, snapshots_per_call: int,
                      snapshot_size: int, num_channels: int,
                      samp_rate: Optional[float] = None,
                      hop: Optional[int] = None) -> dict:
    """samples/s counts each INPUT sample once: with overlapped windows a
    snapshot advances the stream by `hop` samples (hop = S − overlap), not
    by snapshot_size — pass `hop` for overlapped configs or samples/s,
    ingest bytes/s and x_realtime over-count by S/hop."""
    snaps_s = snapshots_per_call / seconds_per_call
    samples_s = snaps_s * (hop if hop is not None else snapshot_size)
    rep = {
        "snapshots_per_s": snaps_s,
        "samples_per_s_per_channel": samples_s,
        "aggregate_samples_per_s": samples_s * num_channels,
        "ingest_bytes_per_s": samples_s * num_channels * 8.0,
    }
    if samp_rate:
        rep["x_realtime"] = samples_s / samp_rate
    return rep
