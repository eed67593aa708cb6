"""Config 4's TUM-VI stereo-inertial fisheye rig through the port's runner at
its defaults on the CPU, against the JAX runner and a direct drive of an
asynchronous `System`: the scene, the three runs and the gates of
`tests/test_torch_async_inertial.py` (its `tumvi_stereo_vi_fisheye` scene:
16 frames, in which neither package initializes the IMU)."""

from test_torch_async_inertial import check_direct_drive, check_jax_runner, runs  # noqa: F401

SCENE = "tumvi_stereo_vi_fisheye"


def test_async_inertial_rig_equals_a_direct_drive(runs):  # noqa: F811
    check_direct_drive(runs(SCENE), SCENE)


def test_async_inertial_rig_agrees_with_the_jax_runner(runs):  # noqa: F811
    check_jax_runner(runs(SCENE), SCENE)
