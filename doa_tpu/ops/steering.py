"""Steering vectors and scan grids.

Replaces the reference's per-block private `amv(...)` steering builders
(SURVEY.md §2.1 C2 `MUSIC_lin_array::amv`) with a shared, batched, jittable
module. Conventions (pinned by tests/golden.py):

  * ULA element positions p_k = k * d wavelengths, k = 0..N-1 (uncentered;
    phase referenced to element 0).
  * theta measured from the array axis (endfire): theta ∈ [0°, 180°],
    broadside = 90°.
  * a(theta)_k = exp(-1j * 2π * d * k * cos(theta)).

Steering matrices are precomputed constants for a config (closed over by the
jitted pipeline) — XLA hoists them; they live in device memory and stream
through the spectrum scan.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from doa_tpu.configs import ArrayGeometry, GridSpec1D, GridSpec2D


def ula_steering(theta_deg, num_elements: int, norm_spacing: float,
                 dtype=jnp.complex64):
    """a(theta): (..., N) steering vectors for a ULA. theta_deg may be any
    shape; result appends the element axis."""
    theta = jnp.deg2rad(jnp.asarray(theta_deg, dtype=jnp.float32))
    k = jnp.arange(num_elements, dtype=jnp.float32)
    phase = -2.0 * jnp.pi * norm_spacing * jnp.cos(theta)[..., None] * k
    return jnp.exp(1j * phase).astype(dtype)


def ura_steering(az_deg, el_deg, shape, norm_spacing: float,
                 dtype=jnp.complex64):
    """Planar-array steering for (az, el), elements on an (nx, ny) grid in
    the x-y plane; u = (cos el sin az, cos el cos az); x-major flattening.
    Returns (..., nx*ny)."""
    az = jnp.deg2rad(jnp.asarray(az_deg, dtype=jnp.float32))
    el = jnp.deg2rad(jnp.asarray(el_deg, dtype=jnp.float32))
    ux = jnp.cos(el) * jnp.sin(az)
    uy = jnp.cos(el) * jnp.cos(az)
    nx, ny = shape
    ix = jnp.arange(nx, dtype=jnp.float32)[:, None]
    iy = jnp.arange(ny, dtype=jnp.float32)[None, :]
    phase = -2.0 * jnp.pi * norm_spacing * (
        ux[..., None, None] * ix + uy[..., None, None] * iy
    )
    return jnp.exp(1j * phase).reshape(*az.shape, nx * ny).astype(dtype)


def grid_angles_1d(grid: GridSpec1D) -> np.ndarray:
    """The G scan angles (degrees) for a 1-D grid, as host numpy (static)."""
    return np.linspace(grid.lo_deg, grid.hi_deg, grid.num_points)


def _ula_steering_np(theta_deg, num_elements: int, norm_spacing: float):
    """Host-numpy ULA steering (for config-static scan matrices: these are
    built once per pipeline and passed to jit as ordinary device buffers —
    never computed eagerly on-device nor baked in as HLO constants)."""
    theta = np.deg2rad(np.asarray(theta_deg, dtype=np.float64))
    k = np.arange(num_elements)
    phase = -2.0 * np.pi * norm_spacing * np.cos(theta)[..., None] * k
    return np.exp(1j * phase).astype(np.complex64)


def ula_grid(geometry: ArrayGeometry, grid: GridSpec1D,
             num_elements: int | None = None) -> np.ndarray:
    """Steering matrix A: (G, N) over the scan grid (host numpy, c64).

    `num_elements` overrides the geometry's count (used for the spatial-
    smoothing subarray scan, where the effective array is L elements).
    """
    n = num_elements if num_elements is not None else geometry.num_elements
    theta = grid_angles_1d(grid)
    return _ula_steering_np(theta, n, geometry.norm_spacing)


def grid_angles_2d(grid: GridSpec2D):
    """(az, el) meshgrid (degrees) flattened to (G,) each, G = num_az*num_el."""
    az = np.linspace(grid.az_lo_deg, grid.az_hi_deg, grid.num_az)
    el = np.linspace(grid.el_lo_deg, grid.el_hi_deg, grid.num_el)
    azg, elg = np.meshgrid(az, el, indexing="ij")
    return azg.ravel(), elg.ravel()


def ura_grid(geometry: ArrayGeometry, grid: GridSpec2D) -> np.ndarray:
    """Steering matrix A: (num_az*num_el, N) over the az/el scan grid
    (host numpy, c64)."""
    azg, elg = grid_angles_2d(grid)
    az = np.deg2rad(azg)
    el = np.deg2rad(elg)
    ux = np.cos(el) * np.sin(az)
    uy = np.cos(el) * np.cos(az)
    nx, ny = geometry.shape
    ix = np.arange(nx)[:, None]
    iy = np.arange(ny)[None, :]
    phase = -2.0 * np.pi * geometry.norm_spacing * (
        ux[..., None, None] * ix + uy[..., None, None] * iy
    )
    return np.exp(1j * phase).reshape(len(az), nx * ny).astype(np.complex64)


def wideband_steering_scale(norm_spacing: float, subband_norm_freq,
                            fractional_bw: float):
    """Effective normalized spacing for a subband at normalized baseband
    frequency f ∈ [-0.5, 0.5): d/λ = norm_spacing·(1 + f·fractional_bw),
    where fractional_bw = samp_rate / carrier_freq — the same model as
    ops.wideband.wideband_steering_stack and io.synthetic wideband synth.
    """
    return norm_spacing * (
        1.0 + jnp.asarray(subband_norm_freq) * fractional_bw)
