"""The judge catches what breaks the timed path: the tiny cell's run with
each fault of `benchmark/faults.py` planted comes out not correct, and the
same run without one comes out correct."""

import pytest
import torch

from benchmark import cell as cells
from benchmark import faults, judge
from benchmark.replay import Replay
from benchmark.tests.conftest import TINY


def _checks(root, seed=2**31 + 3):
    c = cells.load(TINY, root=root)
    r = Replay(c, seed, torch.device("cpu"))
    r.warm()
    r.window(30.0)
    r.free()
    return judge.judge(r, c)


def _correct(checks):
    return all(v <= lim for v, lim in checks.values())


def test_sound_run_is_correct(tiny_root):
    checks = _checks(tiny_root)
    assert _correct(checks), checks


@pytest.mark.parametrize("fault", [f for f in faults.NAMES if f not in faults.INERTIAL])
def test_fault_is_caught(tiny_root, fault):
    undo = faults.plant(fault)
    try:
        checks = _checks(tiny_root)
    finally:
        undo()
    assert not _correct(checks), checks
