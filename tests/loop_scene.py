"""A map with loop drift set by construction, in numpy, for the loop-closing
and global-BA parity tests of the port (`test_torch_loop.py`,
`test_torch_gba.py`).

The camera walks a circle of radius 2.5 m in a 12 x 12 x 4 m room, heading
along the circle, and its last keyframe returns to the first one's place.
Points lie on the walls; each keyframe observes its 256 highest-priority
visible points, each observation a copy of the point's descriptor with a
few bits flipped, at the true projection plus 0.3 px of noise. A point
seen in the first half of the circle and again in the second half is two
map points (the map has not closed the loop), each placed by its first
observer. Keypoint 0 of every keyframe and map-point slot 0 stay empty,
which keeps ROADMAP fault C6 (a valid write into index 0 lost by the
reference's padded scatters) out of the parity gates.

Drift: keyframe k of K has the world-side similarity D_k (yaw, translation
and scale, growing linearly to `yaw`, `shift` and `scale` at the last
keyframe); its estimated pose is P_k(Y) = R_k R_d^T (Y - t_d) + s_d t_k,
chosen so that P_k(D_k X) = s_d T_k(X) (the same pixels as the truth), and
a point's estimate is D_f(X) for its first observer f. So each keyframe is
consistent with the points it created, the drift accumulates along the
chain, and the closure at the last keyframe has a known error to remove
(the C5 regime of ROADMAP, set by construction, not by a threshold
calibrated on one machine's numerics).
"""

from __future__ import annotations

import numpy as np

W, H = 320, 240
FX = FY = 300.0
PARAMS = np.asarray([FX, FY, W / 2, H / 2, 0, 0, 0, 0], np.float32)
ROOM_LO = np.asarray([-6.0, -6.0, 0.0])
ROOM_HI = np.asarray([6.0, 6.0, 4.0])


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def true_pose(theta):
    """(R_cw, t_cw) on the circle at angle theta, looking along it."""
    p = np.asarray([2.5 * np.cos(theta), 2.5 * np.sin(theta), 1.5])
    z = np.asarray([-np.sin(theta), np.cos(theta), 0.0])
    y = np.asarray([0.0, 0.0, -1.0])
    x = np.cross(y, z)
    R_wc = np.stack([x, y, z], axis=1)
    return R_wc.T, -R_wc.T @ p


def _wall_points(rng, n):
    """n points on the four walls, uniformly by area."""
    wall = rng.integers(0, 4, n)
    u = rng.uniform(-6, 6, n)
    z = rng.uniform(0.2, 3.8, n)
    pts = np.zeros((n, 3))
    pts[:, 2] = z
    for w, (ax, val) in enumerate(((0, -6.0), (0, 6.0), (1, -6.0), (1, 6.0))):
        m = wall == w
        pts[m, ax] = val
        pts[m, 1 - ax] = u[m]
    return pts


def make_loop_map(seed=0, K=24, Kmax=32, Nf=256, Pmax=4096, yaw=0.06, shift=(0.15, -0.1, 0.05),
                  scale=1.08, n_phys=6000, end_gap=0.03):
    """(arrays of a `MapState` in numpy, dict(n_kf, n_mp, kf_ts, centres_true,
    loop_kf, cur_kf)). Keyframe K-1 sits `end_gap` rad before keyframe 0's
    place."""
    rng = np.random.default_rng(seed)
    phys = _wall_points(rng, n_phys)
    prio = rng.permutation(n_phys)
    pdesc = rng.integers(0, 256, (n_phys, 32), dtype=np.uint8)
    thetas = np.linspace(0.0, 2 * np.pi - end_gap, K)

    def drift(k):
        a = k / max(K - 1, 1)
        return _rz(yaw * a), np.asarray(shift) * a, scale ** a

    mp_id = {}  # (physical point, half) -> map point id - 1
    first = []
    kf = dict(R=np.tile(np.eye(3, dtype=np.float32), (Kmax, 1, 1)), t=np.zeros((Kmax, 3), np.float32),
              uv=np.zeros((Kmax, Nf, 2), np.float32), desc=np.zeros((Kmax, Nf, 32), np.uint8),
              valid=np.zeros((Kmax, Nf), bool), mp=np.full((Kmax, Nf), -1, np.int32))
    centres = []
    for k, th in enumerate(thetas):
        R, t = true_pose(th)
        centres.append(-R.T @ t)
        Xc = phys @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * FX + [W / 2, H / 2]
        vis = (Xc[:, 2] > 0.5) & (uv[:, 0] > 4) & (uv[:, 0] < W - 4) & (uv[:, 1] > 4) & \
              (uv[:, 1] < H - 4)
        ids = np.flatnonzero(vis)
        ids = ids[np.argsort(prio[ids])][:Nf - 1]
        half = int(k >= K // 2)
        for j, p in enumerate(ids):
            key = (int(p), half)
            if key not in mp_id:
                mp_id[key] = len(first)
                first.append((int(p), k))
            kf["mp"][k, j + 1] = mp_id[key] + 1
        n = len(ids)
        kf["uv"][k, 1:n + 1] = uv[ids] + rng.normal(0, 0.3, (n, 2))
        flips = (rng.random((n, 32, 8)) < 0.01).astype(np.uint8)
        kf["desc"][k, 1:n + 1] = pdesc[ids] ^ np.packbits(flips, axis=-1, bitorder="little")[..., 0]
        kf["valid"][k, 1:n + 1] = True
        Rd, td, sd = drift(k)
        kf["R"][k] = R @ Rd.T
        kf["t"][k] = sd * t - R @ Rd.T @ td
    n_mp = len(first) + 1  # slot 0 stays empty
    assert n_mp < Pmax - 1
    mp_pos = np.zeros((Pmax, 3), np.float32)
    mp_desc = np.zeros((Pmax, 32), np.uint8)
    mp_normal = np.zeros((Pmax, 3), np.float32)
    mp_min = np.zeros(Pmax, np.float32)
    mp_max = np.zeros(Pmax, np.float32)
    mp_first = np.full(Pmax, -1, np.int32)
    mp_valid = np.zeros(Pmax, bool)
    for i, (p, k) in enumerate(first, start=1):
        Rd, td, sd = drift(k)
        X = sd * Rd @ phys[p] + td
        O = -kf["R"][k].T @ kf["t"][k]
        d = np.linalg.norm(X - O)
        mp_pos[i], mp_desc[i], mp_normal[i] = X, pdesc[p], (X - O) / d
        mp_max[i] = d * 1.1
        mp_min[i] = mp_max[i] / 1.2 ** 7
        mp_first[i], mp_valid[i] = k, True
    kf_valid = np.zeros(Kmax, bool)
    kf_valid[:K] = True
    kf_prev = np.full(Kmax, -1, np.int32)
    kf_prev[1:K] = np.arange(K - 1)
    arrays = dict(
        kf_R=kf["R"], kf_t=kf["t"], kf_valid=kf_valid, kf_uv=kf["uv"],
        kf_ur=np.full((Kmax, Nf), -1.0, np.float32), kf_octave=np.zeros((Kmax, Nf), np.int32),
        kf_angle=np.zeros((Kmax, Nf), np.float32), kf_desc=kf["desc"],
        kf_feat_valid=kf["valid"], kf_mp=kf["mp"], kf_vel=np.zeros((Kmax, 3), np.float32),
        kf_bias_g=np.zeros((Kmax, 3), np.float32), kf_bias_a=np.zeros((Kmax, 3), np.float32),
        kf_prev=kf_prev, mp_pos=mp_pos, mp_valid=mp_valid, mp_desc=mp_desc,
        mp_normal=mp_normal, mp_min_dist=mp_min, mp_max_dist=mp_max, mp_first_kf=mp_first,
        mp_found=mp_valid.astype(np.int32), mp_visible=mp_valid.astype(np.int32),
    )
    kf_ts = np.zeros(Kmax)
    kf_ts[:K] = np.arange(K) * 0.5
    return arrays, dict(n_kf=K, n_mp=n_mp, kf_ts=kf_ts, centres_true=np.asarray(centres),
                        loop_kf=0, cur_kf=K - 1)


def keyframe_ate(kf_R, kf_t, centres_true):
    """Sim3-aligned RMSE of the keyframe centres against the truth."""
    est = np.stack([-R.T @ t for R, t in zip(kf_R, kf_t)]).astype(np.float64)
    gt = np.asarray(centres_true, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    xe, xg = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(xg.T @ xe / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / ((xe ** 2).sum() / len(est))
    err = (s * (R @ est.T)).T + (mu_g - s * R @ mu_e) - gt
    return float(np.sqrt((err ** 2).sum(1).mean()))


def make_ba_map(seed=0, K=12, Kmax=16, Nf=256, Pmax=1024, n_pts=255, noise_px=0.3,
                stereo=(1, 4, 7, 10), bf=30.0):
    """(arrays of a `MapState` in numpy, dict(n_kf, n_mp, kf_ts)): K
    keyframes along a 1.5 m arc, all looking at one cloud of `n_pts`
    points 3-8 m ahead that each of them observes (keypoint 0 and slot 0
    empty); the keyframes in `stereo` also carry right-u rows for a
    baseline of bf / FX. A well-conditioned whole-map BA: keyframe 0 and the
    stereo rows fix the gauge, every point has K observations."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2.5, 2.5, n_pts), rng.uniform(-1.8, 1.8, n_pts),
                    rng.uniform(3.0, 8.0, n_pts)], -1)
    desc = rng.integers(0, 256, (n_pts, 32), dtype=np.uint8)
    arrays = {}
    kf_R = np.tile(np.eye(3, dtype=np.float32), (Kmax, 1, 1))
    kf_t = np.zeros((Kmax, 3), np.float32)
    kf_uv = np.zeros((Kmax, Nf, 2), np.float32)
    kf_ur = np.full((Kmax, Nf), -1.0, np.float32)
    kf_desc = np.zeros((Kmax, Nf, 32), np.uint8)
    kf_mp = np.full((Kmax, Nf), -1, np.int32)
    for k in range(K):
        a = -0.15 + 0.3 * k / max(K - 1, 1)
        R = _rz(0.0) @ np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        c = np.asarray([1.5 * k / max(K - 1, 1) - 0.75, 0.05 * np.sin(k), 0.0])
        t = -R @ c
        kf_R[k], kf_t[k] = R, t
        Xc = pts @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * FX + [W / 2, H / 2]
        kf_uv[k, 1:n_pts + 1] = uv + rng.normal(0, noise_px, uv.shape)
        if k in stereo:
            kf_ur[k, 1:n_pts + 1] = kf_uv[k, 1:n_pts + 1, 0] - bf / Xc[:, 2]
        kf_desc[k, 1:n_pts + 1] = desc
        kf_mp[k, 1:n_pts + 1] = np.arange(1, n_pts + 1)
    mp_pos = np.zeros((Pmax, 3), np.float32)
    mp_pos[1:n_pts + 1] = pts
    mp_valid = np.zeros(Pmax, bool)
    mp_valid[1:n_pts + 1] = True
    kf_valid = np.zeros(Kmax, bool)
    kf_valid[:K] = True
    d = np.linalg.norm(pts, axis=1)
    arrays = dict(
        kf_R=kf_R, kf_t=kf_t, kf_valid=kf_valid, kf_uv=kf_uv, kf_ur=kf_ur,
        kf_octave=np.zeros((Kmax, Nf), np.int32), kf_angle=np.zeros((Kmax, Nf), np.float32),
        kf_desc=kf_desc, kf_feat_valid=kf_mp >= 0, kf_mp=kf_mp,
        kf_vel=np.zeros((Kmax, 3), np.float32), kf_bias_g=np.zeros((Kmax, 3), np.float32),
        kf_bias_a=np.zeros((Kmax, 3), np.float32),
        kf_prev=np.r_[-1, np.arange(Kmax - 1)].astype(np.int32), mp_pos=mp_pos,
        mp_valid=mp_valid, mp_desc=np.pad(desc, ((1, Pmax - n_pts - 1), (0, 0))),
        mp_normal=np.pad(pts / d[:, None], ((1, Pmax - n_pts - 1), (0, 0))).astype(np.float32),
        mp_min_dist=np.pad(d * 0.2, (1, Pmax - n_pts - 1)).astype(np.float32),
        mp_max_dist=np.pad(d * 2.0, (1, Pmax - n_pts - 1)).astype(np.float32),
        mp_first_kf=np.where(mp_valid, 0, -1).astype(np.int32),
        mp_found=mp_valid.astype(np.int32), mp_visible=mp_valid.astype(np.int32),
    )
    kf_ts = np.zeros(Kmax)
    kf_ts[:K] = np.arange(K) * 0.5
    return arrays, dict(n_kf=K, n_mp=n_pts + 1, kf_ts=kf_ts)
