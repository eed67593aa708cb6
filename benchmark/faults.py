"""Faults planted in the timed path, to show that the judge catches them
(`tests/test_faults.py` on the CPU, `control.py --fault` on the card).

Each `plant(name)` patches the port where its modules look the function up
and returns a function that undoes the patch:

- "unchanged": every other frame's step returns the previous frame's
  result without tracking it (a step that leaves its state unchanged);
- "half": extraction leaves out half of each frame's keypoints;
- "altered": B1 returns a wrong best key for one query of each call (an
  answer altered where it is produced);
- "pose": every other tracked frame's pose is moved by 1 map unit (the
  initial map's median depth) as it is logged (an answer altered where it
  is produced);
- "keyframe": each new keyframe's stored position is moved by 1 map unit
  as the tracker inserts it (an answer altered where it is produced);
- "inertial": every visual-inertial BA (the local inertial BA and the
  full VI-BA of the IMU initialization's refinements) returns its
  keyframes' velocities 0.1 m/s and gyro biases 0.005 rad/s off on each
  axis (an answer altered where it is produced).

The System's track entries (`track_monocular`, `track_stereo`) are wrapped
alike. The cells run on one chip: no exchange between chips can be left out.
"""

from __future__ import annotations

import torch

NAMES = ("unchanged", "half", "altered", "pose", "keyframe", "inertial")
INERTIAL = ("inertial",)  # faults only an inertial cell can have
TRACK = ("track_monocular", "track_stereo")


def _wrap_track(make):
    """Wraps each of System's track entries by `make(orig)`; returns the undo."""
    from orbslam3_tpu_torch.system import System

    origs = {name: getattr(System, name) for name in TRACK}
    for name, orig in origs.items():
        setattr(System, name, make(orig))
    return lambda: [setattr(System, name, orig) for name, orig in origs.items()]


def plant(name: str):
    if name == "unchanged":
        state = {"n": 0, "last": None}

        def make(orig):
            def track(self, *args, **kw):
                state["n"] += 1
                if state["last"] is not None and state["n"] % 2 == 0:
                    return state["last"]
                state["last"] = orig(self, *args, **kw)
                return state["last"]
            return track
        return _wrap_track(make)
    if name == "half":
        from orbslam3_tpu_torch.ops import features as feat

        orig = feat.extract

        def extract(image, params=feat.OrbParams()):
            f = orig(image, params)
            keep = torch.ones_like(f.valid)
            keep[1::2] = False
            return f._replace(valid=f.valid & keep)

        feat.extract = extract
        return lambda: setattr(feat, "extract", orig)
    if name == "altered":
        from orbslam3_tpu_torch.ops import cuda_match

        orig = cuda_match.hamming_top2

        def hamming_top2(desc_a, desc_b, valid_b=None, window=None):
            d1, d2, j = orig(desc_a, desc_b, valid_b, window)
            j = j.clone()
            if j.numel():
                j[0] = (j[0] + 1) % desc_b.shape[0]
            return d1, d2, j

        cuda_match.hamming_top2 = hamming_top2
        return lambda: setattr(cuda_match, "hamming_top2", orig)
    if name == "pose":
        def make(orig):
            def track(self, *args, **kw):
                n = len(self.tracker.trajectory)
                out = orig(self, *args, **kw)
                traj = self.tracker.trajectory
                if len(traj) > n and len(traj) % 2:
                    ts, store, ref, R_cr, t_cr = traj[-1]
                    traj[-1] = (ts, store, ref, R_cr, t_cr + 1.0)
                return out
            return track
        return _wrap_track(make)
    if name == "keyframe":
        def make(orig):
            def track(self, *args, **kw):
                n_kf = self.store.n_kf
                out = orig(self, *args, **kw)
                if self.store.n_kf > n_kf:
                    self.store.state.kf_t[self.store.n_kf - 1] += 1.0
                return out
            return track
        return _wrap_track(make)
    if name == "inertial":
        from orbslam3_tpu_torch.optim import inertial as vi

        orig = vi.solve_vi_ba

        def solve_vi_ba(*args, **kw):
            res = orig(*args, **kw)
            st = res.state
            return res._replace(state=st._replace(v=st.v + 0.1, bg=st.bg + 0.005))

        vi.solve_vi_ba = solve_vi_ba
        return lambda: setattr(vi, "solve_vi_ba", orig)
    raise ValueError(f"no fault {name!r}; have {NAMES}")
