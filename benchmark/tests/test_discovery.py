"""A configuration, a traffic mix, a cell's limits and a per-layer metric
are found by their names: the tiny cell of `tiny_root` was added by new
files and manifest entries alone, and no file the benchmark had changed."""

import filecmp

from benchmark import cell as cells
from benchmark.tests.conftest import ROOT, STEREO, TINY


def test_new_cell_found_by_name(tiny_root):
    c = cells.load(TINY, root=tiny_root)
    assert c.config["name"] == "tiny_mono" and c.traffic["session_frames"] == 12
    assert c.limits["kp_bad"] == 0
    assert "frames_traced" in [m["name"] for m in c.per_layer]
    assert [m["name"] for m in c.end_to_end] == ["frames_per_s", "device_peak_gib", "setup_s"]
    reader = cells.metric_reader("frames_traced", root=tiny_root)
    assert callable(reader.read)


def test_existing_files_untouched(tiny_root):
    for sub in ("configs", "traffic", "limits", "metrics", "reference"):
        cmp = filecmp.dircmp(ROOT / "benchmark" / sub, tiny_root / "benchmark" / sub,
                             ignore=["__pycache__"])
        assert not cmp.diff_files and not cmp.left_only, sub


def test_every_manifest_cell_has_its_files():
    import json

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in manifest["workloads"]:
        cells.load(w["name"])
    for m in manifest["per_layer"]:
        assert callable(cells.metric_reader(m["name"]).read)


def test_stereo_cell_with_a_kidnap_runs_from_files_alone(tiny_root):
    """A rectified pair (`track_stereo`) and a kidnap, both from data files."""
    import numpy as np
    import torch

    from benchmark import judge, synth
    from benchmark.replay import Replay

    c = cells.load(STEREO, root=tiny_root)
    r = Replay(c, 2**31 + 5, torch.device("cpu"))
    assert r.stereo and r.rec.imgs.shape == (16, 2, 240, 376)
    at, src = c.traffic["kidnap"]
    assert np.array_equal(r.rec.centres[at], synth.pose_at(src / synth.CAM_HZ, 8.0)[1])
    r.window(20.0)
    r.free()
    assert "OK" in r.sessions[0].states
    checks = judge.judge(r, c)
    assert checks["kp_bad"][0] == 0 and checks["b1_bad"][0] == 0, checks
    assert checks["ate_m"][0] < float("inf"), checks
