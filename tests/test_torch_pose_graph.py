"""Port parity: the Sim3 pose graph (`orbslam3_tpu_torch/optim/pose_graph.py`,
the essential graph of loop closing) and the point correction, against the
JAX package on the CPU, on the drifted loop of `tests/test_pose_graph.py`.
Tolerance: R, t and s within 1e-4 (the 7x7 blocks are summed in another
order, and the Jacobians come from reverse- instead of forward-mode
autodiff); both close the loop (the end error falls below a third)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import lie as lie_j
from orbslam3_tpu.optim import pose_graph as pg_j
from orbslam3_tpu_torch.optim import pose_graph as pg_t
from test_pose_graph import drifted_loop

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers


def _graph(rng, K, extra_hop: bool, loop_s: float):
    R_true, t_true, R_est, t_est = drifted_loop(rng, K)
    ei, ej, eR, et, es, ew = [], [], [], [], [], []
    for hop in (1, 2) if extra_hop else (1,):
        for k in range(hop, K):
            Rba = R_est[k] @ R_est[k - hop].T
            ei.append(k - hop), ej.append(k), eR.append(Rba)
            et.append(t_est[k] - Rba @ t_est[k - hop]), es.append(1.0), ew.append(1.0)
    Rba = R_true[0] @ R_true[K - 1].T
    ei.append(K - 1), ej.append(0), eR.append(Rba)
    et.append(loop_s * (t_true[0] - Rba @ t_true[K - 1])), es.append(loop_s), ew.append(5.0)
    fixed = np.arange(K + 2) == 0
    fixed[K:] = True  # two unused slots, as in the loop closer's Kmax padding
    pad = lambda x, v: np.concatenate([x, np.repeat(v[None], 2, 0)])  # noqa: E731
    arrays = dict(R=pad(R_est, np.eye(3, dtype=np.float32)), t=pad(t_est, np.zeros(3, np.float32)),
                  s=np.ones(K + 2, np.float32), fixed=fixed, edge_i=np.asarray(ei, np.int32),
                  edge_j=np.asarray(ej, np.int32), edge_R=np.stack(eR).astype(np.float32),
                  edge_t=np.stack(et).astype(np.float32), edge_s=np.asarray(es, np.float32),
                  edge_valid=np.arange(len(ei)) != 3, edge_weight=np.asarray(ew, np.float32))
    return arrays, (R_true, t_true, R_est, t_est)


@pytest.mark.parametrize("extra_hop,loop_s", [(False, 1.0), (True, 1.0), (True, 0.8)])
def test_solve_pose_graph_matches_reference(extra_hop, loop_s):
    K = 20
    arrays, (R_true, t_true, R_est, t_est) = _graph(np.random.default_rng(0), K, extra_hop, loop_s)
    ref = pg_j.solve_pose_graph(pg_j.PoseGraph(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                                iters=12)
    got = pg_t.solve_pose_graph(pg_t.PoseGraph(**{k: torch.from_numpy(np.array(v))
                                                  for k, v in arrays.items()}), iters=12)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)

    def end_err(Rs, ts):
        return np.linalg.norm(-Rs[K - 1].T @ ts[K - 1] + R_true[K - 1].T @ t_true[K - 1])

    if loop_s == 1.0:
        assert end_err(got[0].numpy(), got[1].numpy() / got[2].numpy()[:, None]) < \
            end_err(R_est, t_est) / 3


def test_correct_points_and_se3_to_sim3_match():
    rng = np.random.default_rng(1)
    n = 50
    R_old = np.asarray(lie_j.exp_so3(jnp.asarray(rng.normal(0, 0.5, (n, 3)), jnp.float32)))
    R_new = np.asarray(lie_j.exp_so3(jnp.asarray(rng.normal(0, 0.5, (n, 3)), jnp.float32)))
    t_old, t_new = (rng.normal(0, 1, (2, n, 3))).astype(np.float32)
    s_old = np.ones(n, np.float32)
    s_new = rng.uniform(0.7, 1.4, n).astype(np.float32)
    pts = rng.normal(0, 2, (n, 3)).astype(np.float32)
    args = (pts, R_old, t_old, s_old, R_new, t_new, s_new)
    got = pg_t.correct_points(*(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(pg_j.correct_points(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    for a, b in zip(pg_t.se3_to_sim3(torch.from_numpy(R_old), torch.from_numpy(t_old)),
                    pg_j.se3_to_sim3(jnp.asarray(R_old), jnp.asarray(t_old))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
