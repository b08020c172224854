"""Every built program is plain XLA: no preset's jitted program (nor the
sharded builders') holds a pallas_call, and no module of the package,
the tests or the root scripts imports jax.experimental.pallas."""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from doa_tpu import PRESETS
from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                             GridSpec1D, WidebandSpec)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOPS = DoaConfig(
    geometry=ArrayGeometry(kind="ula", num_elements=16, norm_spacing=0.5),
    snapshot_size=1024, num_sources=2, estimators=(Estimator.MUSIC,),
    grid=GridSpec1D(num_points=361),
    wideband=WidebandSpec(num_subbands=8, fractional_bw=0.4,
                          fusion="tops"),
    num_max_vals=2)

CASES = {**{k: PRESETS[k] for k in (
    "c1_ula4_tone", "c2_ula8_2src", "c3_ula16_calib_smooth",
    "c4_ula16_streaming", "c5_ura64_wideband", "fast_bf16",
    "fast_int8")}, "tops": TOPS}


def _sds(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _assert_plain(jaxpr):
    assert "pallas_call" not in str(jaxpr)


@pytest.mark.parametrize("name", sorted(CASES))
def test_preset_program_has_no_pallas_call(name):
    from doa_tpu.ops.interleaved import interleave_factor
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    cfg = CASES[name]
    pipe = build_pipeline_tpu(cfg)
    N = cfg.geometry.num_elements
    T = 2 * cfg.snapshot_size
    Ar, Ai = pipe.steering_planes
    extra = tuple(pipe.wb_args or ())
    args = (_sds((N,)), _sds((N,)), Ar, Ai) + extra
    if pipe.jitted_ilv is not None:
        tp = interleave_factor(N)
        dt = jnp.int8 if cfg.cov_dtype == "int8" else jnp.float32
        jaxpr = jax.make_jaxpr(pipe.jitted_ilv)(
            _sds((T // tp, 2 * N * tp), dt), *args)
    else:
        jaxpr = jax.make_jaxpr(pipe.jitted)(
            _sds((T, N)), _sds((T, N)), *args)
    _assert_plain(jaxpr)


@pytest.mark.parametrize("name,spec", [("c4_ula16_streaming", (4, 1)),
                                       ("c5_ura64_wideband", (2, 2))])
def test_sharded_program_has_no_pallas_call(name, spec):
    from doa_tpu.ops.interleaved import interleave_factor
    from doa_tpu.parallel import MeshSpec, build_sharded_pipeline, make_mesh

    cfg = PRESETS[name]
    mesh = make_mesh(MeshSpec(*spec), jax.devices()[:4])
    pipe = build_sharded_pipeline(cfg, mesh)
    assert pipe.fast
    N = cfg.geometry.num_elements
    tp = interleave_factor(N)
    T = spec[0] * 2 * cfg.snapshot_size
    xil = _sds((T // tp, 2 * N * tp))
    c = (_sds((N,)), _sds((N,)))
    if cfg.wideband.enabled:
        from doa_tpu.ops.wideband import wideband_steering_stack
        from doa_tpu.pipeline import _steering_fn
        F = cfg.wideband.num_subbands
        A = wideband_steering_stack(cfg, _steering_fn(cfg))
        args = (xil,) + c + (_sds((F, F)), _sds((F, F)),
                             _sds(A.shape), _sds(A.shape))
    else:
        Ar, Ai = pipe.steering_planes
        args = (xil,) + c + (Ar, Ai)
    _assert_plain(jax.make_jaxpr(pipe.jitted)(*args))


def _py_files(group):
    base = os.path.join(ROOT, group) if group != "root" else ROOT
    if group == "root":
        return [os.path.join(ROOT, f) for f in os.listdir(ROOT)
                if f.endswith(".py")]
    out = []
    for d, _, files in os.walk(base):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


@pytest.mark.parametrize("group", ["doa_tpu", "tests", "root"])
def test_no_module_imports_pallas(group):
    files = _py_files(group)
    assert files
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [
                    f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for n in names:
                assert "pallas" not in n, (path, n)


def test_interleaved_gate_has_no_platform_branch():
    """The interleaved path is chosen by the config alone: the same
    preset builds the same paths whatever the backend."""
    from doa_tpu.pipeline_tpu import build_pipeline_tpu

    for name in ("c1_ula4_tone", "c4_ula16_streaming", "fast_int8"):
        assert build_pipeline_tpu(PRESETS[name]).fast_path
    assert not build_pipeline_tpu(PRESETS["c3_ula16_calib_smooth"]).fast_path
    assert build_pipeline_tpu(PRESETS["c5_ura64_wideband"]).wb_fast
    pipe = build_pipeline_tpu(dataclasses.replace(
        PRESETS["c2_ula8_2src"], subspace_method="eigh"))
    assert not pipe.fast_path and pipe.jitted_ilv is None
    assert np.asarray(pipe.steering_planes[0]).shape == (181, 8)
