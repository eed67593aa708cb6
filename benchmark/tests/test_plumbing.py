"""A run of the harness end to end on the CPU at a tiny size, through
`benchmark/run.py` in a checkout of its own (`tiny_root`), and its exits
where it may print no result."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import TINY, make_root

END_TO_END = {"frames_per_s", "device_peak_gib", "setup_s"}


def _run(root, *args, seed=2**31 + 11):
    p = subprocess.run([sys.executable, str(root / "benchmark" / "run.py"), "--workload", TINY,
                        "--seed", str(seed), *args], capture_output=True, text=True,
                       timeout=600, cwd=root)
    return p


def _result(p):
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["attempted"] > 0
    for name, c in line["checks"].items():
        assert f"check {name} " in p.stderr
    return line


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run(tiny_root, trace):
    line = _result(_run(tiny_root, "--seconds", "30", "--trace", str(trace), "--device", "cpu"))
    assert line["correct"] is True, line["checks"]
    if trace:
        assert "frames_traced" in line["metrics"]  # the metric added by a new file
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["metrics"]["host_syncs_per_frame"]["value"] == 0.0  # no card, no sync
    else:
        assert set(line["metrics"]) == END_TO_END


def test_no_card_no_result(tiny_root):
    p = _run(tiny_root, "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and not p.stdout.strip()


def test_benchmark_files_alone_no_result(tmp_path):
    root = make_root(tmp_path, with_port=False)
    p = subprocess.run([sys.executable, str(root / "benchmark" / "run.py"), "--workload",
                        "mono.explore", "--seed", "1", "--seconds", "1", "--trace", "0",
                        "--device", "cpu"], capture_output=True, text=True, timeout=300,
                       cwd=root)
    assert p.returncode != 0 and not p.stdout.strip()
