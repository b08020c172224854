"""CLI app tests (reference apps B3-B5 as automated checks): the full
simulate → calibrate → estimate → track workflow in-process."""

import json

import numpy as np
import pytest

from doa_tpu.cli import main


def _run(capsys, *argv):
    main(list(argv))
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)


def test_simulate_estimate_roundtrip(tmp_path, capsys):
    cap = str(tmp_path / "cap.npz")
    r = _run(capsys, "simulate", "--preset", "c2_ula8_2src",
             "--angles", "60,110", "--samples", "32768", "--out", cap)
    assert r["shape"] == [32768, 8]
    r = _run(capsys, "estimate", "--preset", "c2_ula8_2src",
             "--input", cap)
    med = r["music"]["median_angles_deg"]
    assert abs(med[0] - 60.0) < 1.0 and abs(med[1] - 110.0) < 1.0, med
    assert "capon" in r


def test_calibration_workflow(tmp_path, capsys):
    common = str(tmp_path / "common.npz")
    pilot = str(tmp_path / "pilot.npz")
    cal1 = str(tmp_path / "cal1.npz")
    cal2 = str(tmp_path / "cal2.npz")
    _run(capsys, "simulate", "--preset", "c1_ula4_tone", "--elements",
         "8", "--angles", "90", "--samples", "16384", "--snr", "30",
         "--out", common)
    r = _run(capsys, "calibrate-phase", "--input", common, "--out", cal1)
    assert len(r["phase_offsets_rad"]) == 8
    _run(capsys, "simulate", "--preset", "c1_ula4_tone", "--elements",
         "8", "--angles", "68", "--samples", "16384", "--snr", "25",
         "--out", pilot)
    r = _run(capsys, "calibrate-elements", "--input", pilot, "--pilot",
             "68", "--phase-calib", cal1, "--out", cal2)
    assert len(r["gains"]) == 8
    cap = str(tmp_path / "cap.npz")
    _run(capsys, "simulate", "--preset", "c2_ula8_2src", "--angles",
         "60,110", "--samples", "32768", "--out", cap)
    r = _run(capsys, "estimate", "--preset", "c2_ula8_2src", "--input",
             cap, "--calib", cal2)
    med = r["music"]["median_angles_deg"]
    assert abs(med[0] - 60.0) < 1.5 and abs(med[1] - 110.0) < 1.5, med


def test_track_command(tmp_path, capsys):
    cap = str(tmp_path / "track.npz")
    _run(capsys, "simulate", "--preset", "c4_ula16_streaming",
         "--angles", "55,125", "--samples", "16384", "--out", cap)
    r = _run(capsys, "track", "--preset", "c4_ula16_streaming",
             "--input", cap)
    assert r["active_tracks"] >= 2
    finals = [a for a in r["final_track_angles_deg"] if a is not None]
    assert any(abs(a - 55.0) < 2 for a in finals), finals
    assert any(abs(a - 125.0) < 2 for a in finals), finals


def test_estimate_report(tmp_path, capsys):
    cap = str(tmp_path / "cap.npz")
    rep = str(tmp_path / "report.html")
    _run(capsys, "simulate", "--preset", "c1_ula4_tone", "--angles",
         "72", "--samples", "16384", "--out", cap)
    r = _run(capsys, "estimate", "--preset", "c1_ula4_tone", "--input",
             cap, "--report", rep)
    assert r["report_written"] == rep
    data = open(rep).read()
    assert "base64" in data and "music" in data


def test_config_validation_errors():
    import dataclasses

    import pytest

    from doa_tpu.configs import DoaConfig

    with pytest.raises(ValueError, match="subspace_method"):
        DoaConfig(subspace_method="qr")
    with pytest.raises(ValueError, match="scan_mode"):
        DoaConfig(scan_mode="fine")
    with pytest.raises(ValueError, match="compute_dtype"):
        DoaConfig(compute_dtype="fp8")
    with pytest.raises(ValueError, match="overlap"):
        DoaConfig(snapshot_size=256, overlap=256)
    with pytest.raises(ValueError, match="num_sources"):
        DoaConfig(num_sources=4)
    # irregular overlap is legal at config level (complex path frames it)
    DoaConfig(snapshot_size=256, overlap=100)


def test_cli_mode_overrides(tmp_path, capsys):
    """--scan-mode/--subspace/--subspace-check reach the
    config (the new round-2 knobs are user-switchable, not just API)."""
    cap = str(tmp_path / "cap.npz")
    _run(capsys, "simulate", "--preset", "c2_ula8_2src",
         "--angles", "60,110", "--samples", str(8 * 2048), "--out", cap)
    res = _run(capsys, "estimate", "--preset", "c2_ula8_2src",
               "--input", cap, "--scan-mode", "hierarchical",
               "--subspace-check")
    a = sorted(res["music"]["median_angles_deg"])
    assert abs(a[0] - 60) < 1.0 and abs(a[1] - 110) < 1.0


def test_cli_auto_num_sources(tmp_path, capsys):
    """--num-sources auto: MDL on the capture's leading windows picks
    K (here 3 against a 2-source preset) before the pipeline builds."""
    cap = str(tmp_path / "cap3.npz")
    _run(capsys, "simulate", "--preset", "c2_ula8_2src",
         "--angles", "50,90,130", "--samples", str(16 * 2048),
         "--out", cap)
    res = _run(capsys, "estimate", "--preset", "c2_ula8_2src",
               "--input", cap, "--num-sources", "auto")
    assert res["num_sources_auto"] == 3
    a = sorted(res["music"]["median_angles_deg"])
    assert len(a) == 2  # num_max_vals unchanged — peaks list length
    # explicit integer override composes too
    res2 = _run(capsys, "estimate", "--preset", "c2_ula8_2src",
                "--input", cap, "--num-sources", "3")
    assert "num_sources_auto" not in res2
