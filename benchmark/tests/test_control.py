"""The precision control on the card: the program with TF32 switched on for
its float32 matmuls (the configuration states TF32 off) comes out not
correct, and the program as configured comes out correct, on the cell's
own shapes with a short window. Needs a CUDA card; skips without one."""

import pytest
import torch

from benchmark import cell as cells
from benchmark import judge
from benchmark.replay import Replay


def _checks(tf32: bool, seed: int):
    import orbslam3_tpu_torch  # noqa: F401

    c = cells.load("mono.explore")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        r = Replay(c, seed, torch.device("cuda"))
        r.window(8.0)
        r.free()
        return judge.judge(r, c)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
def test_tf32_control_fails_and_float32_passes():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    sound = _checks(False, 2**31 + 21)
    assert all(v <= lim for v, lim in sound.values()), sound
    control = _checks(True, 2**31 + 21)
    assert not all(v <= lim for v, lim in control.values()), control
