"""Core DoA ops: pure-functional JAX over snapshot-batched arrays.

Every op takes/returns arrays with a leading snapshot-batch axis B —
the batched form of the reference's "one covariance matrix per stream
item" idiom (SURVEY.md §1).
"""

from doa_tpu.ops.steering import (
    ula_steering,
    ura_steering,
    ula_grid,
    ura_grid,
)
from doa_tpu.ops.covariance import (
    frame_samples,
    sample_covariance,
    forward_backward,
    spatial_smooth,
    streaming_covariance,
)
from doa_tpu.ops.subspace import noise_subspace, signal_subspace, eigh_batched
from doa_tpu.ops.music import music_spectrum, noise_projector
from doa_tpu.ops.capon import capon_spectrum
from doa_tpu.ops.min_norm import min_norm_spectrum, root_min_norm
from doa_tpu.ops.root_music import root_music
from doa_tpu.ops.peaks import find_local_max
from doa_tpu.ops.crb import crb_ula_deg, crb_ura_deg

__all__ = [
    "ula_steering",
    "ura_steering",
    "ula_grid",
    "ura_grid",
    "frame_samples",
    "sample_covariance",
    "forward_backward",
    "spatial_smooth",
    "streaming_covariance",
    "noise_subspace",
    "signal_subspace",
    "eigh_batched",
    "music_spectrum",
    "min_norm_spectrum",
    "root_min_norm",
    "noise_projector",
    "capon_spectrum",
    "root_music",
    "find_local_max",
    "crb_ula_deg",
    "crb_ura_deg",
]
