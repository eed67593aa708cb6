"""Whether what the timed path produced is correct: each compared number
beside its limit (`benchmark/limits/<workload>.json`).

Run once the window has closed and the device's peak has been read. The
program's answers are read from what the window kept (`replay.Session`,
`replay.Sample`); the reference (`benchmark/reference/`) works everything
else out again from the recording the seed made.

- `kp_bad`: keypoint slots of the sampled frames whose position, octave,
  angle, response, descriptor or validity differ from the reference's
  extraction of the same image. Exact.
- `b1_bad`: query rows of the B1 calls made while a sampled frame ran whose
  best, second best or argbest differ from the plain Hamming top-2 on the
  call's inputs. Exact. The inputs are the program's state (the map's
  descriptors and projections); `kp_bad` checks the frame's side of them.
- `ate_m`: the worst session's trajectory error after a Sim3 alignment to
  the generator's camera centres.
- `kf_ate_m`: the same over the keyframes of the session's map.
- `map_point_m`: the worst session's median distance of its map points,
  carried by the trajectory's alignment, to the room's walls.
- `lost_frames`: the most frames of one session, after its first tracked
  frame, that were not tracked or left no pose in the trajectory.
- inertial traffic, sessions whose VIBA1 has run (the IMU state is not
  due before: right after the IMU initialization its gravity reads 3-6
  degrees off until VIBA1 refines it, against under 2 after): `ate_se3_m` (after
  an SE3 alignment), `scale_err` (|1 - the Sim3 scale|), `gravity_deg` (the
  tilt of the alignment's rotation: the map's z axis against gravity's),
  `vel_err_mps` (RMS of the keyframes' velocities after the IMU
  initialization against the trajectory's), `bias_g_err` (RMS over the
  same keyframes of their gyro bias against the generator's). The
  accelerometer's bias is not compared: a 10 s session leaves it
  unobserved (estimates near 0).
- loop traffic: `sessions_without_loop`, the sessions replayed to their end
  in which no loop closed.

A session still open when the window closed is judged as it stands, when
its trajectory holds `MIN_JUDGE_FRAMES` frames or more; its IMU state only
once its VIBA1 has run. Where no session ran to its end and the open one
has not come so far (a traced run's window holds ~150 frames, VIBA1 comes
at ~112), the IMU state is not due and not compared; a session that ran to
its end without VIBA1 reads inf on every IMU-state number. A pair's extraction
is judged on its left image.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from benchmark import synth
from benchmark.reference import match, orb
from benchmark.reference import trajectory as tj

MIN_JUDGE_FRAMES = 40
IMU_STATE = ("ate_se3_m", "scale_err", "gravity_deg", "vel_err_mps", "bias_g_err")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _main_map(session):
    counts: Dict[int, int] = {}
    for e in session.trajectory:
        counts[e[1]] = counts.get(e[1], 0) + 1
    return max(counts, key=counts.get) if counts else None


def _trajectory(session, key):
    """(frame indices, camera centres) of the session's entries in map `key`."""
    m = session.maps[key]
    kf_R, kf_t = _np(m["kf_R"]).astype(np.float64), _np(m["kf_t"]).astype(np.float64)
    ks, cs = [], []
    for ts, store, ref, R_cr, t_cr in session.trajectory:
        if store != key:
            continue
        if ref >= 0:
            R_cw, t_cw = R_cr @ kf_R[ref], R_cr @ kf_t[ref] + t_cr
        else:
            R_cw, t_cw = R_cr, t_cr
        ks.append(int(round(ts * synth.CAM_HZ)))
        cs.append(-np.asarray(R_cw).T @ np.asarray(t_cw))
    return np.asarray(ks, int), np.asarray(cs, np.float64).reshape(-1, 3)


def judge_session(session, rec, traffic, inertial: bool, ended: bool) -> Dict[str, float]:
    """The session's numbers; `ended`: it ran to its end (its IMU state is due)."""
    out: Dict[str, float] = {}
    ok = [j for j, s in enumerate(session.states) if s == "OK"]
    posed = {int(round(e[0] * synth.CAM_HZ)) for e in session.trajectory}
    out["lost_frames"] = float(sum(s != "OK" or j not in posed
                                   for j, s in enumerate(session.states) if j >= ok[0])) \
        if ok else float(len(session.states))
    key = _main_map(session)
    if key is None:
        out["ate_m"] = float("inf")
        return out
    ks, est = _trajectory(session, key)
    gt = rec.centres[ks]
    out["ate_m"], fit = tj.ate(est, gt, with_scale=True)
    m = session.maps[key]
    kv = _np(m["kf_valid"])[: m["n_kf"]]
    ids = np.flatnonzero(kv)
    kf_R = _np(m["kf_R"]).astype(np.float64)[ids]
    kf_t = _np(m["kf_t"]).astype(np.float64)[ids]
    kf_c = -np.einsum("nji,nj->ni", kf_R, kf_t)
    kf_k = np.rint(m["kf_ts"][ids] * synth.CAM_HZ).astype(int)
    out["kf_ate_m"] = tj.ate(kf_c, rec.centres[kf_k], with_scale=True)[0] if len(ids) >= 3 \
        else float("inf")
    if fit is not None:
        s, R, t = fit
        pts = _np(m["mp_pos"])[_np(m["mp_valid"])].astype(np.float64)
        if len(pts):
            d = tj.wall_distance((s * (R @ pts.T)).T + t, synth.BOX_LO, synth.BOX_HI)
            out["map_point_m"] = float(np.median(d))
        else:
            out["map_point_m"] = float("inf")
    if inertial and ended and not (session.viba1 and fit is not None):
        out.update({name: float("inf") for name in IMU_STATE})
    if inertial and session.viba1 and fit is not None:
        out["scale_err"] = abs(1.0 - fit[0])
        out["ate_se3_m"], fit3 = tj.ate(est, gt, with_scale=False)
        R3 = fit3[1]
        out["gravity_deg"] = tj.tilt_deg(R3)
        t_loop = float(traffic["lap_seconds"])
        after = kf_k >= (session.imu_init_frame or 0)
        vel = _np(m["kf_vel"]).astype(np.float64)[ids][after]
        ts = m["kf_ts"][ids][after]
        if len(ts):
            v_gt = np.stack([synth.velocity_at(t, t_loop) for t in ts])
            err = np.linalg.norm((R3 @ vel.T).T - v_gt, axis=1)
            out["vel_err_mps"] = float(np.sqrt((err**2).mean()))
            bg = _np(m["kf_bias_g"]).astype(np.float64)[ids][after]
            out["bias_g_err"] = float(np.sqrt(((bg - synth.BIAS_G)**2).sum(1).mean()))
    return out


def kp_mismatch(samples, rec, config) -> int:
    o = config["orb"]
    p = orb.Orb(o["n_features"], o["n_levels"], o["scale_factor"], float(o["ini_th_fast"]),
                float(o["min_th_fast"]))
    bad = 0
    for s in samples:
        f = s.features
        img = rec.imgs[s.frame]
        img = torch.from_numpy(img[0] if img.ndim == 3 else img).to(f.uv.device, torch.float32)
        r = orb.extract(img, p)
        same = (f.valid == r.valid)
        both = f.valid & r.valid
        for a, b in ((f.uv, r.uv), (f.response, r.response), (f.angle, r.angle)):
            eq = (a == b) if a.dim() == 1 else (a == b).all(-1)
            same &= eq | ~both
        same &= (f.octave == r.octave) | ~both
        same &= (f.desc == r.desc).all(-1) | ~both
        bad += int((~same).sum())
    return bad


def b1_mismatch(samples) -> int:
    """Query rows whose (best, second, argbest) differ from the reference's."""
    bad = 0
    for s in samples:
        for c in s.b1:
            d1, d2, j = match.top2(c.desc_a, c.desc_b, c.valid_b, c.window)
            e1, e2, k = c.out
            bad += int(((d1 != e1) | (d2 != e2) | (j != k)).sum())
    return bad


def judge(replay, cell) -> "Dict[str, Tuple[float, float]]":
    """{name: (value, limit)} of the run, in a fixed order."""
    limits, traffic = cell.limits, cell.traffic
    inertial = bool(traffic["imu"])
    per = []
    for s in replay.sessions:
        if s.n_frames < replay.n and len(s.trajectory) < MIN_JUDGE_FRAMES:
            continue
        per.append(judge_session(s, replay.rec, traffic, inertial, s.n_frames == replay.n))
    vals: Dict[str, float] = {}
    vals["kp_bad"] = float(kp_mismatch(replay.samples, replay.rec, cell.config))
    vals["b1_bad"] = float(b1_mismatch(replay.samples))
    for name in ("ate_m", "kf_ate_m", "map_point_m", "lost_frames") + IMU_STATE:
        xs = [p[name] for p in per if name in p]
        if xs:
            vals[name] = float(max(xs))
    if traffic.get("loop"):
        vals["sessions_without_loop"] = float(sum(
            1 for s in replay.sessions if s.n_frames == replay.n and not s.loop_frames))
    # The IMU state is due from a session whose VIBA1 has run, or that ran to its
    # end: where the open one alone was judged and has not come so far, it is
    # not compared.
    ended = any(s.n_frames == replay.n for s in replay.sessions)
    return {name: (vals.get(name, float("inf")), float(limit)) for name, limit in limits.items()
            if name in vals or name not in IMU_STATE or ended}
