"""The port's dataset runner (`python -m orbslam3_tpu_torch.run_sequence`) on
the CPU: `main` with `--device cpu` on a 10-frame EuRoC directory written
here (the first 10 frames of the 12-frame scene of `tests/test_e2e_mono.py`,
320x240, 400 features on 3 levels, with ground truth), asynchronous and with `--sync-mapping`, with and
without place recognition. It prints the JAX runner's progress and summary
lines, writes the trajectory files in each format, and its Sim3 ATE is under
0.05 m. (On `camera_path(10)`, whose frames are 1.2 times further apart, the
JAX package's asynchronous System itself ends at 0.103 m: its mapper is busy
when the monocular policy wants keyframes, so it makes 4 instead of 6.)
Without a card and without `--device cpu` it raises.
"""

import re

import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu_torch import run_sequence
from orbslam3_tpu_torch.io import datasets
import test_e2e_mono as scene
from test_runners import SETTINGS

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

N_FRAMES = 10


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner_seq")
    params = cam_j.make_pinhole(scene.FOCAL, scene.FOCAL, scene.W / 2, scene.H / 2)
    pts, shades = scene.make_world(np.random.default_rng(0))
    poses = scene.camera_path(12)[:N_FRAMES]
    imgs = [np.clip(np.round(scene.render(params, R, t, pts, shades)), 0, 255).astype(np.uint8)
            for R, t in poses]
    centres = np.stack([-R.T @ t for R, t in poses])
    quats = np.tile([1.0, 0.0, 0.0, 0.0], (N_FRAMES, 1))  # the ATE reads positions only
    ns = [1_000_000_000 + 100_000_000 * k for k in range(N_FRAMES)]
    datasets.write_euroc(str(root), ns, imgs, SETTINGS, groundtruth=(centres, quats))
    return root


RUNS = {
    "async_tum": ([], "tum"),
    "sync_kitti": (["--sync-mapping"], "kitti"),
    "async_noloop_euroc": (["--no-loop"], "euroc"),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_runner_on_a_euroc_directory(sequence, tmp_path, capsys, name):
    flags, fmt = RUNS[name]
    out, kf_out = tmp_path / "traj.txt", tmp_path / "kf.txt"
    res = run_sequence.main([str(sequence / "settings.yaml"), str(sequence), "--dataset", "euroc",
                             "--mode", "mono", "--device", "cpu", "--kmax", "32", "--pmax",
                             "4096", "--traj-format", fmt, "--out", str(out),
                             "--kf-out", str(kf_out)] + flags)
    text = capsys.readouterr().out
    assert f"euroc/mono: {N_FRAMES} frames, camera model 0" in text
    assert re.search(r"^\[0/10\] state=NOT_INITIALIZED kfs=0 mps=0$", text, re.M)
    assert re.search(r"^\[9/10\] state=OK kfs=\d+ mps=\d+$", text, re.M)
    assert re.search(r"^done: 10 frames in [0-9.]+s \([0-9.]+ fps incl. mapping\)$", text, re.M)
    assert ("loops_closed=0 merges=0" in text) == ("--no-loop" not in flags)
    assert ("vocabulary: 97272 words" in text) == ("--no-loop" not in flags)
    assert re.search(r"^frame ms: median [0-9.]+ p95 [0-9.]+ max [0-9.]+", text, re.M)
    assert f"trajectories -> {out}, {kf_out}" in text
    ate = float(re.search(r"^ATE RMSE: ([0-9.]+) m$", text, re.M).group(1))
    assert ate < 0.05 and abs(ate - res["ate"]) < 1e-4
    assert res["mapper_idle"] and res["states"][-1] == "OK"
    rows = np.loadtxt(out, ndmin=2)
    n_ok = len(res["system"].get_trajectory()[0])
    assert rows.shape == (n_ok, {"tum": 8, "kitti": 12, "euroc": 8}[fmt])
    kf_rows = np.loadtxt(kf_out, ndmin=2)
    assert kf_rows.shape[0] == res["n_kf"] and kf_rows.shape[1] == 8
    assert np.isfinite(rows).all()


def test_runner_takes_the_card_unless_asked_for_the_cpu(sequence, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sequence.main([str(sequence / "settings.yaml"), str(sequence), "--no-loop"])
