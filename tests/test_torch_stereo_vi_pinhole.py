"""Port parity: the stereo-inertial `System` on a rectified pinhole pair
(`Sensor.IMU_STEREO` with `bf`, config 2 with an IMU) against the JAX
package on the CPU, on the pinhole pair of `tests/stereo_vi_scene.py`
(320x240, focal 200 px, 0.11 m apart; config 4's room and path, 400
features on 3 levels, 10 Hz camera, 200 Hz ideal IMU): the scanline match's
stereo rows in the pose solves, the pose-inertial solves and the local
inertial BA, the IMU initialization with the scale held fixed. The runs,
the repairs patched into the reference (C13, C14) and the gates are those
of `tests/test_torch_stereo_vi_system.py`.
"""

import torch

from test_torch_stereo_vi_system import assert_runs_agree, port_run, reference_run

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers


def test_stereo_vi_pinhole_system_matches_reference():
    ref = reference_run(fisheye=False)
    port = port_run(ref, fisheye=False)
    assert_runs_agree(ref, port)
    s = port["slam"].store.state
    kf = s.kf_valid
    assert (s.kf_ur[kf] >= 0).sum() > 200  # the keyframes carry stereo rows
    last = port["slam"].tracker.last_frame
    assert last.uv_r is None and (last.ur >= 0).sum() > 50
