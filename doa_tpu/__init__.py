"""doa_tpu — a batched direction-of-arrival (DoA) estimation framework
in JAX, run on a GPU (CPU for tests).

A from-scratch JAX/XLA re-design of the capability set of the
`lauraflu/gr-doa` GNU Radio out-of-tree module (see SURVEY.md for the
component map; parity targets are pinned by SURVEY.md + BASELINE.json
and the golden tests in `tests/golden.py`).

Design stance (SURVEY.md §7.1):
  * pure-functional kernel library over arrays with a leading snapshot-batch
    axis — the reference's "matrix as stream item" becomes `R: c64[B, N, N]`;
  * one fused, jit-compiled pipeline per configuration instead of a
    thread-per-block runtime;
  * sharding via a named mesh (snapshot/time DP + steering-grid TP) under
    `jax.shard_map`;
  * calibration is data (a complex correction vector), not blocks.

Component map (reference → here):
  autocorrelate            → doa_tpu.ops.covariance
  MUSIC_lin_array          → doa_tpu.ops.music (+ doa_tpu.ops.steering)
  rootMUSIC_linear_array   → doa_tpu.ops.root_music
  calibrate_lin_array      → doa_tpu.calib.element_cal
  antenna_correction       → doa_tpu.calib.apply
  find_local_max           → doa_tpu.ops.peaks
  phase_offset_est         → doa_tpu.calib.phase_offset
  twinrx_usrp_source       → doa_tpu.io (recorded IQ + synthetic; no UHD here)
  save_antenna_calib       → doa_tpu.calib.artifacts
  *_cnx accelerator blocks → doa_tpu.ops.interleaved + pipeline_tpu
                             (bf16/int8 ingest, batched device stages)
  apps/*.grc flowgraphs    → doa_tpu.pipeline + doa_tpu.configs presets
"""

from doa_tpu import configs
from doa_tpu.configs import (
    ArrayGeometry,
    DoaConfig,
    Estimator,
    PRESETS,
)


def build_pipeline_tpu(*args, **kwargs):
    """Lazy re-export of doa_tpu.pipeline_tpu.build_pipeline_tpu
    (the production split-complex pipeline)."""
    from doa_tpu.pipeline_tpu import build_pipeline_tpu as f

    return f(*args, **kwargs)


def estimate_doa(*args, **kwargs):
    """Lazy re-export of doa_tpu.pipeline.estimate_doa (one-shot
    convenience on the complex/CPU path)."""
    from doa_tpu.pipeline import estimate_doa as f

    return f(*args, **kwargs)


__version__ = "0.1.0"

__all__ = [
    "configs",
    "ArrayGeometry",
    "DoaConfig",
    "Estimator",
    "PRESETS",
    "build_pipeline_tpu",
    "estimate_doa",
    "__version__",
]
