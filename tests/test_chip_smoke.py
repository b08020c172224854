"""chip_smoke.py's phases at tiny window counts on the CPU backend: the
control flow, the entry points each phase drives and the checks it
makes. Timings printed here are CPU numbers and mean nothing; the
platform check itself stays in main (exercised below)."""

import json

import jax
import pytest

import chip_smoke


def test_presets_phase_small():
    res = chip_smoke.phase_presets(scale=8, bench_T=1 << 16)
    assert {"c1/music", "c2/capon", "c3/music", "c4/music", "c5/music",
            "tops", "fast_bf16", "fast_int8"} <= set(res)


def test_parity_phase_small():
    res = chip_smoke.phase_parity(windows=4, grid=1024, c5_windows=4)
    assert len([k for k in res if k.startswith("cov/")]) == 4


def test_headline_phase_small():
    res = chip_smoke.phase_headline(T=1 << 16, iters=2, c5_windows=16)
    assert set(res["stages"]) == {"ingest_gram", "subspace", "scan",
                                  "peaks"}
    assert {"front_end", "subspace", "scan_fusion",
            "peaks_2d"} <= set(res["c5"])


def test_precision_phase_small():
    res = chip_smoke.phase_precision(T=1 << 16, iters=2)
    assert set(res) == {"highest", "tensorfloat32"}
    from doa_tpu import cpx
    assert cpx.MATMUL_PRECISION == "highest"      # restored


def test_streaming_phase_small():
    res = chip_smoke.phase_streaming(block=1 << 13, n_blocks=8)
    assert res["driver"] <= 1e-3 and res["scan"] <= 1e-3


def test_four_phase_small():
    """The four-device phase on four of the virtual CPU devices."""
    res = chip_smoke.phase_four(devices=jax.devices()[:4], T_nb=1 << 15,
                                c5_windows=8, iters=2)
    assert set(res) == {"c4/4x1", "c4/2x2", "c5/2x2"}


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_gpu(argv, capsys):
    """On the CPU, main exits non-zero and prints no result line."""
    assert chip_smoke.main(argv) != 0
    for line in capsys.readouterr().out.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.mark.gpu
def test_headline_on_gpu(gpu):
    """The headline phase at its real size (T = 2^24) — card only."""
    res = chip_smoke.phase_headline()
    assert res["snapshots_per_s"] > 0
