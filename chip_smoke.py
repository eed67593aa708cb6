"""Smoke test of the PyTorch + CUDA port (`orbslam3_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `orbslam3_tpu_torch/csrc/`, checks
each against its plain PyTorch version at the shapes of the main path
(EuRoC: 752x480 image, 8 levels, 1024 features, 16384 map points), drives
the tracking entry points for a run of frames and checks what comes out, and
compares one whole frame run through the kernels with the same frame run
through the plain versions (phases 1-4). Phase 5 does the same for the
per-keyframe mapping pass (triangulate, fuse, local BA at full width), on
the reference's scene and on a variant where triangulation and fuse find
planted points, counts its host syncs, and times an amortized loop of
tracked frames with a mapping pass every 14th. Phase 6 drives the
monocular `System` end to end (`entry.mono_replay`: two-view
initialization, tracking, keyframes and their mapping passes) over 60
frames of the synthetic EuRoC sequence at 752x480 / 1000 features, checks
the map, the states and the Sim3 ATE against its gate, the kernels'
launches and the host syncs per frame, compares a 20-frame prefix through
the kernels with the same through the plain versions, and times B1 at the
fuse-into-keyframe shape (4096 candidates). Phase 1 holds B2 to its plain
version over the whole atlas and on its small and plateau images
(`kernel_bench.b2_cases`); phase 2 holds B1 to its plain version on its
edge cases (`kernel_bench.b1_edge_cases`). Phase 8 holds B1 to its plain
version above one 1024-key tile (`kernel_bench.b1_tile_cases`: 1025, 2000
and 4097 keys, and ties across the tile edge) and drives a 2000-feature
`System` over 20 frames through the kernels and through the plain
versions (ORB-SLAM3's KITTI settings use 2000 features). Phase 7
times both kernels at the main path's calls (B2 on the atlas; B1 at the
motion model, the local map, the cross-check, the fuse into a neighbour
and the fuse into the keyframe): device-only time by CUDA-graph replay,
the time of one wrapper call, the profiler's device time, the plain
version's time and the bound (`orbslam3_tpu_torch/kernel_bench.py`).

Phase 9 loads the 97k-word vocabulary (`assets/ORBvoc_synth_100k.bin`)
onto the card and holds `bow.transform` and the keyframe database's queries
over phase 6's keyframes equal on the card and on the CPU, and B1 with an
open octave band exact against its plain version. Phase 10 drives
`System.enable_place_recognition` at the reference's defaults through
`entry.mono_replay` at full width over a lap of the synthetic sequence
shortened to 8 s (260 frames) with a kidnap at frame 240 back to frame 40:
at least one loop closed in the JAX `System`'s region, the ATE lowered by
the essential graph, a GBA finished, no point twice in a keyframe row,
LOST and relocalized within 5 frames, the ATE within max(2 x the JAX
`System`'s on the same frames, 0.01 m); at the closing pair `_verify_sim3`
and at the relocalizing frame `_relocalize` run again through the kernels
and through the plain versions (equal counts and associations, Sim3 and
pose within 1e-4); it prints the ms of each verification, correction,
SearchAndFuse, GBA chunk and of the relocalizing frame, the host syncs per
frame kind, B1's launches per call site, and times B1 at place
recognition's five calls.

Phase 11 drives the stereo `System` (config 2: `entry.replay(cuda, "stereo",
120)`, the rectified pair at a 0.11 m baseline, bf 50.38) over 120 frames:
initialization from frame 0 alone, no frame lost, the SE3 (unscaled) ATE
within max(2 x the JAX `System`'s on the same frames, 0.01 m) and the Sim3
scale within 2% of 1; 3 host syncs per tracked frame; B2 on both atlases of
every frame, the right atlas's output exact against the plain version and
timed; B1 launches and device times at its calls; the stereo match's ms per
frame; the local BA's dense-Schur bytes with every observation kept; and
its first 30 frames (initialization and the JAX System's second keyframe)
equal through the kernels and through the plain versions (states,
associations, `kf_ur` and `kf_mp` rows, map points; poses and points within
1e-4). Phase 12 drives RGB-D (`track_rgbd` on the left image and its
ray-cast depth, 60 frames, the same gates against the JAX `System(RGBD)`,
its first 12 frames kernels vs plain) and raw stereo
(`enable_rectification`, 30 frames: the remap on the card within 1e-4 of
the CPU's, every frame OK, the SE3 ATE under phase 11's gate).

Phase 13 drives the mono-inertial `System` (config 3: `entry.replay(cuda,
"mono_vi", N_VI)`, IMU_MONOCULAR at full width with the synthetic sequence's
200 Hz IMU) long enough to pass the IMU initialization and VIBA1: the IMU
initialized within 2 keyframes of the JAX `System`'s keyframe count at its
initialization, VIBA1 run, no frame lost after the map's initialization,
the SE3 and Sim3 ATE each under max(2 x the JAX `System`'s on the same
frames, 0.01 m) and the Sim3 scale within max(2 x |1 - JAX's|, 0.02) of 1,
the pose-inertial result taken on at least 80% of the tracked frames after
the IMU initialization (the exact share printed), the host syncs per
tracked frame 2 before the IMU initialization and
`Tracker.HOST_SYNCS_PER_INERTIAL_FRAME` after it, and a prefix through the
IMU initialization and 10 frames after it equal through the kernels and
through the plain versions (states, associations, keyframe rows; poses,
velocities and points within 1e-4). It prints the median ms per frame
kind, the ms of each inertial call (the preintegration, both pose-inertial
solves, `try_initialize`, the init-time full VI-BA, VIBA1, each local
inertial BA) by CUDA events and the host clock, B1 and B2 launches per
frame and the full-map VI-BA's coupling-tensor bytes.

Phase 14 drives config 4, the stereo-inertial two-camera Kannala-Brandt 8
rig (`entry.replay(cuda, "stereo_vi_fisheye", N_FE)`: `System(IMU_STEREO,
KB8, camera2=...)` on the 512x512 pair of `make_synth_euroc.py --fisheye`,
1000 features on 8 levels, Kmax 256, Pmax 16384, 200 Hz IMU) past the IMU
initialization and VIBA1, with phase 13's gates (every frame OK from frame
0's single-frame initialization, SE3 ATE, scale, the IMU initialized within
2 keyframes of the JAX `System`'s, VIBA1 run, the pose-inertial result on
>= 80% of the frames after it), host syncs per tracked frame 3 before the
IMU initialization and 5 after, B2 twice a frame, and its prefix through
the IMU initialization and 10 frames after it kernels vs plain. It prints
the median ms and syncs per frame kind, the ms of the fisheye match, of the
pose solves with the right-camera rows and of the pose-inertial solves,
B1's launches by call and B2's; then B2 on the 512x512 right atlas and B1
at the fisheye match's call, each exact against its plain version and
timed. Every run prints the wall time of each phase and of the whole
script.

Every phase prints its lines; any failure ends the run with a non-zero
exit. Without a CUDA device it exits non-zero and prints no result.

    python3 chip_smoke.py --save-inputs FILE

also writes the kernels' inputs of phases 7 and 10 to FILE, for `python -m
orbslam3_tpu_torch.kernel_bench FILE` to time another checkout's kernels on
the same inputs.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

N_FRAMES = 24  # frames of the slice driven in phase 3
# Of the 600 keypoints back-projected into the map, the final solve kept
# 564-569 per noisy frame on the H100 (150 of 150 in the CPU parity test's
# small scene); 500 leaves room for noise without hiding a broken stage.
MIN_INLIERS = 500
N_HIDDEN = 100  # points only the local-map stage can find in phase 4
N_PASSES = 5  # timed mapping passes in phase 5
KF_EVERY = 14  # a mapping pass every 14th frame (bench.py's amortized cadence)
N_AMORTIZED = 2 * KF_EVERY  # frames of the amortized loop
# Frames of the monocular replay in phase 6 (3 s of camera; cut from 120 for
# the time limit: phase 10 drives the mono path over 260 frames).
N_REPLAY = 60
N_PREFIX = 20  # frames of its kernels-vs-plain prefix
# Sim3 ATE gate of the replay: max(2 x the JAX System's ATE on the same 60
# frames on a CPU, 0.01 m): 0.008386 m from `python tests/jax_stereo_replay.py
# --mode mono --frames 60`.
ATE_GATE = max(2 * 0.008386, 0.01)


N_WIDE = 20  # frames of the 2000-feature System in phase 8
N_WIDE_FEATURES = 2000

# The main path's B1 calls, by the function that makes them.
B1_SITES = {"_track_last_frame": "motion model", "_track_local_map_match": "local map",
            "_track_reference_kf": "cross-check", "_fuse_batch": "fuse into a neighbour",
            "_fuse_neighbors": "fuse into the keyframe"}
# The two-camera rig's B1 call (phase 14).
B1_RIG_SITES = {"match_stereo_fisheye": "fisheye match"}
# Place recognition's B1 calls (phase 10); a call is named by the first of
# these functions on its stack, before those of B1_SITES (relocalization's
# reference-keyframe match goes through `_track_reference_kf`).
B1_PR_SITES = {"_projection_rescue_match": "reloc rescue",
               "_relocalize": "reloc reference-keyframe match",
               "_sim3_projection_matches": "Sim3 projection",
               "_verify_sim3_impl": "loop verify match",
               "_search_and_fuse": "SearchAndFuse"}

# Phase 10: the loop-and-kidnap lap. The JAX `System` on the same frames on a
# CPU (`python tests/jax_loop_lap.py --t-loop 8 --frames 260 --kidnap-at 240
# --kidnap-src 40`): the shortest lap in 8-20 s with which it closes a loop
# (keyframe 67 onto keyframe 5, at frame 156, ATE 0.0332 -> 0.0212 m at the
# closure), finishes a GBA, relocalizes at frame 241 after the kidnap at 240,
# and ends at a Sim3 ATE of 0.012894 m over 259 poses.
VOC_100K = "assets/ORBvoc_synth_100k.bin"
LAP_T_LOOP = 8.0
LAP_FRAMES = 260
LAP_KIDNAP = (240, 40)  # from frame 240 on, the images of frames 40, 41, ...
JAX_LAP_LOOP = (67, 5)  # the JAX System's closing keyframe pair
JAX_LAP_ATE = 0.012894
LAP_ATE_GATE = max(2 * JAX_LAP_ATE, 0.01)


# Phases 11-12: the JAX `System` on the same frames on a CPU
# (`python tests/jax_stereo_replay.py --mode stereo --frames 120`, `--mode rgbd
# --frames 60`, `--mode raw --frames 30`): stereo initialized at frame 0,
# keyframes at frames 28, 52, 106 and 114, SE3 ATE 0.011602 m, Sim3 scale
# 1.0061; RGB-D SE3 ATE 0.005120 m, scale 1.0000; raw stereo 0.011558 m.
N_STEREO = 120
N_STEREO_PREFIX = 30  # frame 0's initialization and the JAX System's second keyframe (28)
JAX_STEREO_ATE_SE3 = 0.011602
STEREO_ATE_GATE = max(2 * JAX_STEREO_ATE_SE3, 0.01)
N_RGBD = 60
N_RGBD_PREFIX = 12
JAX_RGBD_ATE_SE3 = 0.005120
RGBD_ATE_GATE = max(2 * JAX_RGBD_ATE_SE3, 0.01)
N_RAW = 30
SCALE_TOL = 0.02  # |scale - 1|, the gate of tests/test_stereo_at_scale.py

# Phase 13: the mono-inertial System (config 3). The JAX `System` on the same
# frames on a CPU, with fault C13 repaired in its Tracker as in the port
# (`python tests/jax_vi_replay.py --frames 160 --c13`): the IMU initialized at
# frame 44 with 10 keyframes, VIBA1 at frame 104 (5.2 s), every frame OK after
# the map's initialization (frame 3), 22 keyframes and 1620 points at the
# end, SE3 ATE 0.018918 m, Sim3 ATE 0.017981 m, Sim3 scale 1.009804 over 158
# poses. Unrepaired, it loses track on the frame after each IMU initialization
# and never reaches VIBA1. N_VI = 160 (8 s): at least 140 and VIBA1's frame
# plus 20.
N_VI = 160
JAX_VI_INIT_FRAME = 44
JAX_VI_INIT_KFS = 10
JAX_VI_VIBA1_FRAME = 104
JAX_VI_ATE_SE3 = 0.018918
JAX_VI_ATE_SIM3 = 0.017981
JAX_VI_SCALE = 1.009804
VI_ATE_SE3_GATE = max(2 * JAX_VI_ATE_SE3, 0.01)
VI_ATE_SIM3_GATE = max(2 * JAX_VI_ATE_SIM3, 0.01)
VI_SCALE_TOL = max(2 * abs(1 - JAX_VI_SCALE), 0.02)
VI_PREFIX_AFTER_INIT = 10  # frames after the IMU initialization in the kernels-vs-plain prefix
# Phase 14: config 4, the stereo-inertial fisheye rig. The JAX `System` on the
# same frames on a CPU, with C13 repaired in its Tracker as in the port
# (`python tests/jax_stereo_vi_replay.py --frames 130 --c13`, 640 s on 8 CPU
# cores): initialized on frame 0, every frame OK, the IMU initialized at
# frame 45 with 10 keyframes, VIBA1 at frame 105 (5.25 s), 18 keyframes and
# 1999 points at the end, SE3 ATE 0.002468 m, Sim3 ATE 0.001839 m, Sim3 scale
# 0.996263 over 130 poses. N_FE = 130: VIBA1's frame plus 20 is 125.
N_FE = 130
JAX_FE_INIT_FRAME = 45
JAX_FE_INIT_KFS = 10
JAX_FE_VIBA1_FRAME = 105
JAX_FE_ATE_SE3 = 0.002468
JAX_FE_SCALE = 0.996263
FE_ATE_GATE = max(2 * JAX_FE_ATE_SE3, 0.01)
FE_SCALE_TOL = max(2 * abs(1 - JAX_FE_SCALE), 0.02)


@contextlib.contextmanager
def _b1_calls(calls: list, keep_args):
    """Within the block, append (call site, arguments or None, key count)
    for every B1 wrapper call. `keep_args`: True keeps every call's
    arguments, a set of sites the first call's of each. A call made while
    `COMPARING` is set is named "comparison" (kernels against plain, not the
    main path). The wrapper itself runs unchanged, launch count included."""
    from orbslam3_tpu_torch.ops import _build, cuda_match

    wrapped = cuda_match.hamming_top2

    def recording(*args):
        if not _build.use_kernel(args[0]):  # a plain run launches nothing
            return wrapped(*args)
        names, f = [], sys._getframe(1)
        while f is not None:
            names.append(f.f_code.co_name)
            f = f.f_back
        site = next((B1_PR_SITES[n] for n in names if n in B1_PR_SITES), None) or next(
            (B1_SITES[n] for n in names if n in B1_SITES), None) or next(
            (B1_RIG_SITES[n] for n in names if n in B1_RIG_SITES), "other")
        if COMPARING[0]:
            site = "comparison"
        keep = keep_args is True or (keep_args and site in keep_args
                                     and not any(c[0] == site for c in calls))
        full = args + (None,) * (4 - len(args))  # (desc_a, desc_b, valid_b, window)
        calls.append((site, tuple(_clone(a) for a in full) if keep else None,
                      args[1].shape[0]))
        return wrapped(*args)

    cuda_match.hamming_top2 = recording
    try:
        yield calls
    finally:
        cuda_match.hamming_top2 = wrapped


COMPARING = [False]  # set while a phase re-runs a step to hold kernels against plain


def _clone(x):
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.clone()
    return type(x)(*(_clone(y) for y in x))


def _local_map_variant(args, ref_kf: int):
    """The scene's tensors with map-point normals along the viewing rays
    (the reference's scene points them at the camera, so no point passes the
    frustum test) and the last N_HIDDEN back-projected points dropped from
    the last frame but observed by the reference keyframe: only the
    local-map stage, through its 16384x1024 windowed B1 search, finds them."""
    img, state, local_mask, R, t, last_mp, last_octave = args
    ids = last_mp[last_mp >= 0][-N_HIDDEN:]
    octave = last_octave[last_mp >= 0][-N_HIDDEN:]
    kf_mp = state.kf_mp.clone()
    kf_mp[ref_kf, :N_HIDDEN] = ids
    normal = state.mp_normal.clone()
    normal[:, 2] = 1.0
    # The scene's max_dist (5x the distance) predicts the top octave for every
    # point; give the hidden points the octave of their keypoint instead,
    # half a level from either rounding edge.
    dist = torch.linalg.norm(state.mp_pos[ids.long()] + R.T @ t, dim=-1)
    max_dist = state.mp_max_dist.clone()
    max_dist[ids.long()] = dist * 1.2 ** (octave.to(torch.float32) - 0.5)
    last_mp = torch.where(torch.isin(last_mp, ids), -1, last_mp)
    state = state._replace(kf_mp=kf_mp, mp_normal=normal, mp_max_dist=max_dist)
    return img, state, local_mask, R, t, last_mp, last_octave


def _aligned(rep):
    """The replay's camera centres Sim3-aligned to the rendered ones, keyed
    by timestamp."""
    from orbslam3_tpu_torch.ate import associate, umeyama

    ia, ib = associate(rep.ts, rep.gt_ts, 0.01)
    s, R, t = umeyama(rep.pos[ia], rep.gt_pos[ib], True)
    return {round(float(rep.ts[i]), 6): s * R @ rep.pos[i] + t for i in ia}


def _same_run(rep_k, rep_p, what: str, kf_slack: int) -> str:
    """Gate a replay through the kernels against the same through the plain
    versions: states equal, keyframe counts within `kf_slack`, camera
    centres (Sim3-aligned to the rendered ones) within 2 cm. Returns what
    it compared, for the phase's line."""
    check(rep_k.states == rep_p.states, f"{what}: states {rep_k.states} vs {rep_p.states}")
    check(abs(rep_k.n_kf - rep_p.n_kf) <= kf_slack,
          f"{what}: keyframes {rep_k.n_kf} vs {rep_p.n_kf}")
    a_k, a_p = _aligned(rep_k), _aligned(rep_p)
    common = sorted(set(a_k) & set(a_p))
    d_centre = max(float(np.linalg.norm(a_k[t] - a_p[t])) for t in common)
    check(len(common) >= len(rep_k.states) - 10 and d_centre <= 0.02,
          f"{what}: camera centres differ by {d_centre} m over {len(common)} poses")
    return (f"states equal, keyframes {rep_k.n_kf} vs {rep_p.n_kf}, max camera-centre "
            f"difference {d_centre:.2e} m over {len(common)} poses (Sim3-aligned to the rendered "
            f"centres), ATE {rep_k.ate:.4f} vs {rep_p.ate:.4f} m")


def _quiet_sync():
    """Drain the card without counting it as one of the replay's host syncs."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def _comparing():
    """A kernels-against-plain re-run inside a replay's frame: its host syncs
    are not counted (debug mode off) and its B1 calls are named
    "comparison"; yields a list that receives its ms."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    COMPARING[0] = True
    took = []
    t0 = time.perf_counter()
    try:
        yield took
    finally:
        torch.cuda.synchronize()
        took.append((time.perf_counter() - t0) * 1e3)
        COMPARING[0] = False
        torch.cuda.set_sync_debug_mode(mode)


def phase9_vocabulary(dev, sysm) -> dict:
    """Phase 9: the 97k-word vocabulary on the card; `bow.transform` and
    keyframe-database queries over a replay's keyframes equal on the card
    and on the CPU; B1 with an open octave band (the Sim3 projection's
    window: one radius, no octaves) exact against its plain version at the
    projection's shape. Returns the B1 call's arguments and its error."""
    from orbslam3_tpu_torch import convert
    from orbslam3_tpu_torch.atlas.kfdb import KeyFrameDB
    from orbslam3_tpu_torch.io.vocab_io import load_binary_vocabulary
    from orbslam3_tpu_torch.ops import _build, bow, cuda_match
    from orbslam3_tpu_torch.ops import cameras as cam

    t0 = time.perf_counter()
    voc = load_binary_vocabulary(VOC_100K, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    voc_h = bow.to_device(voc, "cpu")
    store = sysm.store
    s = store.state
    kfs = np.flatnonzero(s.kf_valid.cpu().numpy())
    cpu = lambda x: x.cpu()  # noqa: E731
    n_words = 0
    db_c, db_h = KeyFrameDB(voc, s.Kmax), KeyFrameDB(voc_h, s.Kmax)
    for k in kfs:
        w_c, v_c = db_c.add(int(k), s.kf_desc[k], s.kf_feat_valid[k])
        w_h, v_h = db_h.add(int(k), cpu(s.kf_desc[k]), cpu(s.kf_feat_valid[k]))
        check(torch.equal(w_c.cpu(), w_h), f"bow.transform of keyframe {k}: card vs CPU")
        check(float((v_c.cpu() - v_h).abs().max()) <= 1e-6, f"bow_vector of keyframe {k}")
        n_words += int((w_h >= 0).sum())
    covis = store.covisibility_np()
    cov_c, cov_h = convert.tensor(covis, dev), convert.tensor(covis, "cpu")
    # Each keyframe as a loop query (its covisible neighbourhood excluded)
    # and as a relocalization query of its own features.
    n_cand, d_score = 0, 0.0
    for k in kfs:
        for what, q_c, q_h in (
                ("query", lambda: db_c.query(int(k), cov_c), lambda: db_h.query(int(k), cov_h)),
                ("query_frame", lambda: db_c.query_frame(s.kf_desc[k], s.kf_feat_valid[k], cov_c),
                 lambda: db_h.query_frame(cpu(s.kf_desc[k]), cpu(s.kf_feat_valid[k]), cov_h))):
            (ids_c, sc_c), (ids_h, sc_h) = q_c(), q_h()
            check(torch.equal(ids_c.cpu(), ids_h),
                  f"KFDB {what} of keyframe {k}: {ids_c} vs {ids_h}")
            d_score = max(d_score, float((sc_c.cpu() - sc_h).abs().max()))
            n_cand += int((ids_h >= 0).sum())
    check(n_cand >= len(kfs), f"KFDB: {n_cand} candidates for {len(kfs)} keyframes")
    check(d_score <= 1e-6, f"KFDB scores differ by {d_score}")
    k = int(kfs[-1])

    # B1 with the open band at the Sim3 projection's shape: up to 4096 of the
    # map's points through the newest keyframe's pose, radius 8 px.
    pid = torch.nonzero(s.mp_valid)[:4096, 0]
    Xc = s.mp_pos[pid] @ s.kf_R[k].T + s.kf_t[k]
    uv = cam.project(sysm.tracker.model, sysm.tracker.params, Xc)
    win = cuda_match.MatchWindow(uv.contiguous(), s.kf_uv[k], torch.tensor(8.0, device=dev))
    args = (s.mp_desc[pid], s.kf_desc[k], s.kf_feat_valid[k], win)
    got = cuda_match.hamming_top2(*args)
    with _build.force_plain():
        ref = cuda_match.hamming_top2(*args)
    torch.cuda.synchronize()
    for what, g, r in zip(("d1", "d2", "j1"), got, ref):
        check(torch.equal(g, r), f"B1 open band {what} differs from plain")
    err = max(float((got[0] - ref[0]).abs().max()), float((got[1] - ref[1]).abs().max()))
    print(f"phase 9 vocabulary {VOC_100K}: {voc.n_words} words, depth {voc.depth}, k {voc.k}, "
          f"{load_s:.2f} s to load onto the card; bow.transform of {len(kfs)} keyframes "
          f"({n_words} words) exact card vs CPU; KFDB loop and relocalization queries of each "
          f"keyframe: the same candidates ({n_cand} in all), scores within {d_score:.1e}; "
          f"B1 open band "
          f"{pid.shape[0]}x{s.kf_desc.shape[1]} radius 8: exact (tolerance 0) vs plain, "
          f"{int((got[0] < 1e9).sum())} with a key in their window")
    return dict(args=args, err=err)


def phase10_loop_lap(dev) -> dict:
    """Phase 10: `System` with place recognition at the reference's
    defaults over the loop-and-kidnap lap at full width (752x480, 1000
    features, Kmax 256, Pmax 16384, the 97k-word vocabulary), through
    `entry.mono_replay`; gates, times and host syncs as in the module
    docstring. At the closing pair `_verify_sim3`, and at the relocalizing
    frame `_relocalize` on a copy of its inputs, run again through the
    kernels and through the plain versions inside the replay; those re-runs
    are held apart (their ms, syncs and B1 calls are not the replay's)."""
    import copy

    from orbslam3_tpu_torch import convert
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch.ops import _build, cuda_fast, cuda_match
    from orbslam3_tpu_torch.pipeline import gba as gba_mod
    from orbslam3_tpu_torch.pipeline import loop_closing as lc_mod
    from orbslam3_tpu_torch.pipeline.tracking import Tracker

    frame = [0]
    timers = {k: [] for k in ("verify", "correct", "fuse", "gba_chunk", "reloc")}
    extra_ms = {}  # frame -> ms of its kernels-vs-plain re-runs
    found = {}

    def timed(name, fn):
        def run(self, *a, **kw):
            _quiet_sync()
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            _quiet_sync()
            timers[name].append((frame[0], (time.perf_counter() - t0) * 1e3))
            return out
        return run

    orig = {"verify": lc_mod.LoopCloser._verify_sim3, "correct": lc_mod.LoopCloser._correct_loop,
            "fuse": lc_mod.LoopCloser._search_and_fuse, "gba_chunk": gba_mod.AsyncGBA.tick,
            "reloc": Tracker._relocalize}

    def correct(self, kf_id, loop_kf, *S):
        if "closure" not in found:  # the closing pair, kernels against plain
            runs = {}
            with _comparing() as took:
                for mode in ("kernels", "plain"):
                    with _build.force_plain() if mode == "plain" else contextlib.nullcontext():
                        out = self._verify_sim3_impl(kf_id, loop_kf)
                    runs[mode] = (out, dict(self.last_verify))
            extra_ms[frame[0]] = extra_ms.get(frame[0], 0.0) + took[0]
            found["closure"] = (kf_id, loop_kf, frame[0], runs)
        return timed("correct", orig["correct"])(self, kf_id, loop_kf, *S)

    def reloc(self, cur):
        before = (cur.R.copy(), cur.t.copy(), cur.mp_assoc.copy(), self.ref_kf)
        ok = timed("reloc", orig["reloc"])(self, cur)
        if ok and "reloc" not in found:
            after = (cur.R, cur.t, cur.mp_assoc, self.ref_kf)
            runs = {}
            with _comparing() as took:
                for mode in ("kernels", "plain"):
                    c2 = copy.copy(cur)
                    c2.R, c2.t, c2.mp_assoc = (x.copy() for x in before[:3])
                    self.ref_kf = before[3]
                    with _build.force_plain() if mode == "plain" else contextlib.nullcontext():
                        ok2 = orig["reloc"](self, c2)
                    runs[mode] = (ok2, c2.R, c2.t, c2.mp_assoc, self.ref_kf)
            self.ref_kf = after[3]
            extra_ms[frame[0]] = extra_ms.get(frame[0], 0.0) + took[0]
            found["reloc"] = (frame[0], after, runs)
        return ok

    patches = [(lc_mod.LoopCloser, "_verify_sim3", timed("verify", orig["verify"])),
               (lc_mod.LoopCloser, "_correct_loop", correct),
               (lc_mod.LoopCloser, "_search_and_fuse", timed("fuse", orig["fuse"])),
               (gba_mod.AsyncGBA, "tick", timed("gba_chunk", orig["gba_chunk"])),
               (Tracker, "_relocalize", reloc)]

    def on_frame(k, slam):
        frame[0] = k + 1

    torch.cuda.synchronize()
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        for cls, name, fn in patches:
            setattr(cls, name, fn)
        with _b1_calls([], keep_args=set(B1_PR_SITES.values())) as calls:
            rep = E.mono_replay(dev, LAP_FRAMES, vocabulary=VOC_100K, t_loop=LAP_T_LOOP,
                                kidnap=LAP_KIDNAP, on_frame=on_frame)
    finally:
        for (cls, name, _), fn in zip(patches, (orig["verify"], orig["correct"], orig["fuse"],
                                                orig["gba_chunk"], orig["reloc"])):
            setattr(cls, name, fn)
    wall_s = time.perf_counter() - t0
    sites = {site: sum(c[0] == site for c in calls)
             for site in list(B1_SITES.values()) + list(B1_PR_SITES.values()) + ["comparison"]}
    launches = {"fast_nms": cuda_fast.LAUNCHES,
                "hamming_top2": cuda_match.LAUNCHES - sites["comparison"]}
    check(sum(sites.values()) == cuda_match.LAUNCHES, f"B1 calls by site {sites}")
    for site in B1_PR_SITES.values():  # the rescue runs only below the accept threshold
        check(sites[site] > 0 or site == "reloc rescue",
              f"phase 10: B1 never launched at {site}: {sites}")
    sysm = rep.system

    # What the gates read, printed first so that a failed gate shows it.
    print(f"phase 10 outcome: initialized at frame {rep.states.index('OK')}, loops "
          f"{rep.loops}, GBA {rep.gba_finished} finished, {rep.gba_aborted} aborted; not OK "
          f"after the kidnap at {rep.lost}, relocalized at {rep.relocalized}; ATE {rep.ate:.6f} m "
          f"over {len(rep.ts)} poses", flush=True)
    # Gates.
    check(len(rep.loops) >= 1, f"no loop closed: states {rep.states}")
    lp = rep.loops[0]
    covis = sysm.store.covisibility_np()

    def same_region(a, b):
        return abs(a - b) <= 15 or covis[a, b] >= 15

    check(same_region(lp["kf"], JAX_LAP_LOOP[0]) and same_region(lp["loop_kf"], JAX_LAP_LOOP[1]),
          f"loop {lp} not in the region of the JAX System's {JAX_LAP_LOOP}")
    check(lp["ate_after"] < lp["ate_before"], f"the closure did not lower the ATE: {lp}")
    check(rep.gba_finished >= 1, f"no GBA finished ({rep.gba_aborted} aborted)")
    km = sysm.store.state.kf_mp.cpu().numpy()
    kfv = sysm.store.state.kf_valid.cpu().numpy()
    dups = sum(len(r[r >= 0]) - len(np.unique(r[r >= 0])) for r in km[kfv])
    check(dups == 0, f"{dups} duplicate map points in keyframe rows")
    at = LAP_KIDNAP[0]
    first_lost = next((k for k in range(at, LAP_FRAMES) if rep.states[k] != "OK"), None)
    check(first_lost is not None and first_lost <= at + 1, f"not LOST after the kidnap: "
          f"{rep.states[at:]}")
    check(rep.relocalized is not None and rep.relocalized <= at + 5,
          f"not relocalized within 5 frames of the kidnap: {rep.states[at:]}")
    check(np.isfinite(rep.pos).all() and rep.ate <= LAP_ATE_GATE,
          f"ATE {rep.ate} m above the gate {LAP_ATE_GATE} m")
    check("closure" in found and "reloc" in found, f"phase 10 re-ran {sorted(found)}")
    kf_c, loop_c, fr_c, runs = found["closure"]
    (S_k, st_k), (S_p, st_p) = runs["kernels"], runs["plain"]
    check(S_k is not None and S_p is not None and st_k == st_p,
          f"verify at the closing pair, kernels vs plain: {st_k} vs {st_p}")
    dS = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(S_k, S_p))
    check(dS <= 1e-4, f"verify's Sim3, kernels vs plain: {dS}")
    fr_r, after, rruns = found["reloc"]
    (ok_k, R_k, t_k, a_k, kf_k), (ok_p, R_p, t_p, a_p, kf_p) = rruns["kernels"], rruns["plain"]
    check(ok_k and ok_p and kf_k == kf_p and np.array_equal(a_k, a_p),
          "relocalization, kernels vs plain: outcome or associations differ")
    dP = max(float(np.abs(R_k - R_p).max()), float(np.abs(t_k - t_p).max()))
    check(dP <= 1e-4 and np.array_equal(a_k, after[2]),
          f"relocalization pose, kernels vs plain {dP}")

    kinds = rep.frame_kinds()
    ms = [m - extra_ms.get(k, 0.0) for k, m in enumerate(rep.ms)]
    by_kind = {}
    for kind, n_sync, m in zip(kinds, rep.syncs, ms):
        by_kind.setdefault(kind, []).append((n_sync, m))
    tracked = [n for n, _ in by_kind.get("tracked", [])]
    check(tracked and set(tracked) == {Tracker.HOST_SYNCS_PER_FRAME},
          f"host syncs per tracked non-keyframe frame without a GBA chunk: {sorted(set(tracked))}")
    fps = LAP_FRAMES / (sum(ms) / 1e3)
    med = lambda xs: statistics.median(xs) if xs else float("nan")  # noqa: E731
    print(f"phase 10 lap: {LAP_FRAMES} frames of the synthetic EuRoC sequence with a "
          f"{LAP_T_LOOP:g} s "
          f"lap, kidnapped at frame {at} back to frame {LAP_KIDNAP[1]}; {rep.n_kf} keyframes, "
          f"{rep.n_mp} map points; launches {launches}; {fps:.2f} frames/s over the replay "
          f"({wall_s:.1f} s wall, {rep.render_s:.1f} s of rendering)")
    for L in rep.loops:
        print(f"phase 10 loop closed at frame {L['frame']}: keyframe {L['kf']} onto {L['loop_kf']} "
              f"(JAX: {JAX_LAP_LOOP[0]} onto {JAX_LAP_LOOP[1]}), ATE {L['ate_before']:.4f} -> "
              f"{L['ate_after']:.4f} m by the essential graph")
    print(f"phase 10 GBA: {rep.gba_finished} finished, {rep.gba_aborted} aborted; ATE "
          f"{rep.ate:.4f} m over {len(rep.ts)} poses (Sim3), gate {LAP_ATE_GATE:.4f} m (2 x the "
          f"JAX System's {JAX_LAP_ATE} m); no duplicate point in any keyframe row")
    print(f"phase 10 kidnap at frame {at}: not OK at {rep.lost}, relocalized at frame "
          f"{rep.relocalized} ({ms[rep.relocalized]:.2f} ms; its _relocalize calls "
          f"{[round(m, 2) for f, m in timers['reloc'] if f == rep.relocalized]} ms)")
    fmt = lambda xs: ", ".join(f"{m:.1f}" for _, m in xs)  # noqa: E731
    print(f"phase 10 ms: _verify_sim3 [{fmt(timers['verify'])}] ({len(timers['verify'])} calls); "
          f"_correct_loop [{fmt(timers['correct'])}] (of it _search_and_fuse "
          f"[{fmt(timers['fuse'])}]); GBA chunks [{fmt(timers['gba_chunk'])}]")
    print("phase 10 host syncs and ms per frame kind: " + "; ".join(
        f"{kind} {len(v)} frames, syncs median {med([n for n, _ in v])} (max "
        f"{max(n for n, _ in v)}), ms median {med([m for _, m in v]):.2f}"
        for kind, v in sorted(by_kind.items())))
    print(f"phase 10 kernels vs plain at the closing pair (keyframe {kf_c} onto {loop_c}, frame "
          f"{fr_c}): gate counts equal {st_k}, Sim3 within {dS:.1e}; at the relocalizing frame "
          f"{fr_r}: {int((a_k >= 0).sum())} associations equal, pose within {dP:.1e}")
    print(f"phase 10 B1 launches by call over the replay: {sites}")
    args = {site: next(c[1] for c in calls if c[0] == site) for site in B1_PR_SITES.values()
            if sites[site]}
    if "reloc rescue" not in args:
        # Relocalization accepted without its projection rescue on this lap:
        # take the rescue's B1 arguments (all Pmax points against the last
        # frame's free keypoints, 10 px) from the last frame, to time and
        # hold the call all the same.
        from orbslam3_tpu_torch.ops import matching
        from orbslam3_tpu_torch.pipeline import tracking as trk

        tr, st_ = sysm.tracker, sysm.store.state
        cur = tr.last_frame
        mask = trk._local_point_mask(st_, convert.tensor(np.asarray([tr.ref_kf], np.int32), dev))
        half = np.where(np.arange(cur.mp_assoc.shape[0]) % 2 == 0, cur.mp_assoc, -1)
        assoc = convert.tensor(half.astype(np.int32), dev)  # half the keypoints free
        with _b1_calls([], keep_args={"reloc rescue"}) as extra:
            trk._projection_rescue_match(
                tr.model, tr.params, convert.tensor(cur.R.astype(np.float32), dev),
                convert.tensor(cur.t.astype(np.float32), dev), st_, mask, cur.features, assoc,
                tr.img_wh_t, base_radius=10.0, max_dist=float(matching.TH_HIGH),
                n_levels=tr.orb.n_levels)
        args["reloc rescue"] = extra[0][1]
    return dict(rep=rep, sites=sites, launches=launches, args=args)


@contextlib.contextmanager
def _b2_calls(calls: list, frame: list):
    """Within the block, append (frame, "left atlas" or "right atlas", atlas
    or None) for every B2 wrapper call that launches: a frame's first call
    is its left image's, the second its right's; the first right atlas is
    kept. The wrapper runs unchanged, launch count included."""
    from orbslam3_tpu_torch.ops import _build, cuda_fast

    wrapped = cuda_fast.fast_score_nms

    def recording(img, min_th, ini_th):
        if _build.use_kernel(img):
            right = any(f == frame[0] for f, _, _ in calls)
            keep = right and not any(a is not None for _, _, a in calls)
            calls.append((frame[0], "right atlas" if right else "left atlas",
                          img.clone() if keep else None))
        return wrapped(img, min_th, ini_th)

    cuda_fast.fast_score_nms = recording
    try:
        yield calls
    finally:
        cuda_fast.fast_score_nms = wrapped


def _prefix_recorder(n: int, into: dict):
    """An `on_frame` for `entry.replay` that keeps, for the first `n` frames,
    each frame's associations and pose, and after frame n - 1 the map's
    keyframe rows and points (host copies, read after the frame's timing)."""
    def on_frame(k, slam):
        if k >= n:
            return
        f = slam.tracker.last_frame
        into.setdefault("frames", []).append((f.mp_assoc.copy(), np.array(f.R), np.array(f.t)))
        if k == n - 1:
            s = slam.store.state
            into["map"] = {name: getattr(s, name).cpu().numpy() for name in (
                "kf_valid", "kf_ur", "kf_mp", "kf_R", "kf_t", "mp_valid", "mp_pos")}
    return on_frame


def _same_prefix(rec_k: dict, rec_p: dict, states_k, states_p, what: str) -> str:
    """Gate a prefix through the kernels against the same through the plain
    versions: states, associations, keyframe rows (`kf_ur`, `kf_mp`) and
    point validity equal; poses and points within 1e-4."""
    n = len(rec_p["frames"])
    check(states_k[:n] == states_p[:n], f"{what}: states {states_k[:n]} vs {states_p[:n]}")
    dP = 0.0
    for k, ((a_k, R_k, t_k), (a_p, R_p, t_p)) in enumerate(zip(rec_k["frames"], rec_p["frames"])):
        check(np.array_equal(a_k, a_p), f"{what}: associations of frame {k} differ")
        dP = max(dP, float(np.abs(R_k - R_p).max()), float(np.abs(t_k - t_p).max()))
    m_k, m_p = rec_k["map"], rec_p["map"]
    kf = m_p["kf_valid"]
    for name in ("kf_valid", "kf_ur", "kf_mp", "mp_valid"):
        check(np.array_equal(m_k[name][kf] if name.startswith("kf_") else m_k[name],
                             m_p[name][kf] if name.startswith("kf_") else m_p[name]),
              f"{what}: {name} differs")
    v = m_p["mp_valid"]
    dP = max(dP, float(np.abs(m_k["kf_R"][kf] - m_p["kf_R"][kf]).max()),
             float(np.abs(m_k["kf_t"][kf] - m_p["kf_t"][kf]).max()))
    dX = float(np.abs(m_k["mp_pos"][v] - m_p["mp_pos"][v]).max())
    check(dP <= 1e-4 and dX <= 1e-4, f"{what}: poses within {dP}, points within {dX}")
    return (f"{n} frames: states and associations equal on every frame; {int(kf.sum())} keyframes "
            f"({int((m_p['kf_ur'][kf] >= 0).sum())} stereo rows), kf_ur, kf_mp rows and "
            f"{int(v.sum())} points' validity equal; poses within {dP:.1e}, points within {dX:.1e}")


def _replay_gates(rep, what: str, ate_gate: float, jax_ate: float):
    """Initialization from frame 0, no frame lost after it, SE3 ATE under
    the gate, Sim3 scale within SCALE_TOL, host syncs of the tracked
    frames; returns the per-kind lines' material."""
    from orbslam3_tpu_torch.pipeline.tracking import Tracker

    check(rep.states[0] == "OK", f"{what}: not initialized on frame 0: {rep.states[:5]}")
    check(all(x == "OK" for x in rep.states), f"{what}: a frame not OK: {rep.states}")
    check(rep.pos.shape == (len(rep.ts), 3) and np.isfinite(rep.pos).all(),
          f"{what}: trajectory not finite or misshapen")
    check(rep.ate_se3 <= ate_gate, f"{what}: SE3 ATE {rep.ate_se3} m above the gate {ate_gate} m")
    check(abs(rep.scale - 1) < SCALE_TOL, f"{what}: Sim3 scale {rep.scale}")
    kinds = rep.frame_kinds()
    by_kind = {}
    for kind, n_sync, m in zip(kinds, rep.syncs, rep.ms):
        by_kind.setdefault(kind, []).append((n_sync, m))
    tracked = sorted(set(n for n, _ in by_kind.get("tracked", [])))
    check(tracked == [Tracker.HOST_SYNCS_PER_STEREO_FRAME],
          f"{what}: host syncs per tracked non-keyframe frame {tracked}, documented "
          f"{Tracker.HOST_SYNCS_PER_STEREO_FRAME}")
    med = statistics.median
    print(f"{what}: initialized at frame 0 from one frame, all {len(rep.states)} frames OK, "
          f"{rep.n_kf} keyframes (at frames {[k for k, x in enumerate(rep.keyframe) if x]}), "
          f"{rep.n_mp} map points; SE3 ATE {rep.ate_se3:.6f} m (gate {ate_gate:.6f} m: 2 x the "
          f"JAX System's {jax_ate} m, or 0.01), Sim3 ATE {rep.ate:.6f} m, scale {rep.scale:.5f}; "
          f"{len(rep.states) / (sum(rep.ms) / 1e3):.2f} frames/s "
          f"({rep.render_s:.1f} s of rendering)")
    print(f"{what} host syncs and ms per frame kind: " + "; ".join(
        f"{kind} {len(v)} frames, syncs median {med([n for n, _ in v])} (max "
        f"{max(n for n, _ in v)}), ms median {med([m for _, m in v]):.2f}"
        for kind, v in sorted(by_kind.items())))


def phase11_stereo(dev) -> dict:
    """Phase 11: the stereo `System` over N_STEREO frames at full width,
    through `entry.replay(cuda, "stereo", ...)`; gates and lines as in the
    module docstring. Returns the kernels' launches on the main path, the
    B1 calls by site with one call's arguments each, the right atlas, and
    the prefix's line."""
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch.ops import _build, cuda_fast, cuda_match
    from orbslam3_tpu_torch.ops import features as feat
    from orbslam3_tpu_torch.ops import stereo as stereo_mod
    from orbslam3_tpu_torch.optim import ba as ba_mod
    from orbslam3_tpu_torch.pipeline import local_mapping as lmap

    frame = [0]
    spans, lbas = [], []
    match, local_ba = stereo_mod.match_stereo_rectified, lmap.local_ba

    def timed_match(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        out = match(*a, **kw)
        ev[1].record()
        spans.append((frame[0], ev, (time.perf_counter() - t0) * 1e3))
        return out

    def sized_local_ba(model, params, state, window_ids, fixed_ids, sigma2, **kw):
        C = window_ids.shape[0] + fixed_ids.shape[0]
        cap = kw.get("obs_cap")
        cap = min(lmap.OBS_CAP if cap is None else cap, state.Nf)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = local_ba(model, params, state, window_ids, fixed_ids, sigma2, **kw)
        lbas.append((C, min(lmap.POINT_CAP, state.Pmax), C * cap,
                     torch.cuda.max_memory_allocated() - base))
        return out

    rec_k, rec_p = {}, {}
    prefix = _prefix_recorder(N_STEREO_PREFIX, rec_k)

    def on_frame(k, slam):
        prefix(k, slam)
        frame[0] = k + 1

    torch.cuda.synchronize()
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    stereo_mod.match_stereo_rectified, lmap.local_ba = timed_match, sized_local_ba
    try:
        with _b1_calls([], keep_args=set(B1_SITES.values())) as calls, \
                _b2_calls([], frame) as b2_calls:
            rep = E.replay(dev, "stereo", N_STEREO, on_frame=on_frame)
    finally:
        stereo_mod.match_stereo_rectified, lmap.local_ba = match, local_ba
    launches = {"fast_nms": cuda_fast.LAUNCHES, "hamming_top2": cuda_match.LAUNCHES}
    sites = {site: sum(c[0] == site for c in calls) for site in B1_SITES.values()}
    check(sum(sites.values()) == launches["hamming_top2"] > 0, f"phase 11 B1 calls {sites}")
    check(launches["fast_nms"] == 2 * N_STEREO and all(n == 2 for n in rep.b2),
          f"phase 11 B2 launches {launches['fast_nms']}, per frame {sorted(set(rep.b2))}")
    b2_sides = {side: sum(c[1] == side for c in b2_calls) for side in ("left atlas", "right atlas")}
    check(b2_sides == {"left atlas": N_STEREO, "right atlas": N_STEREO}, f"B2 by side {b2_sides}")
    _replay_gates(rep, "phase 11 stereo", STEREO_ATE_GATE, JAX_STEREO_ATE_SE3)
    Nf = rep.system.store.state.Nf
    match_ms = [ev[0].elapsed_time(ev[1]) for _, ev, _ in spans]
    host_ms = [h for _, _, h in spans]
    check(len(spans) == N_STEREO, f"{len(spans)} stereo matches in {N_STEREO} frames")
    print(f"phase 11 stereo match (dense {Nf}x{Nf} Hamming with the scanline gates, SAD, "
          f"parabola, median cut): median {statistics.median(match_ms):.3f} ms per frame on the "
          f"device stream (CUDA events), max {max(match_ms):.3f}; host issue median "
          f"{statistics.median(host_ms):.3f} ms")
    check(lbas, "phase 11: no local BA ran")
    C, P, O, peak = max(lbas, key=lambda x: (x[2], x[3]))
    check(all(o == c * Nf for c, _, o, _ in lbas), f"local BA observation slots {lbas}")
    check(ba_mod.auto_dense_schur(C, P), f"local BA {C} cameras x {P} points refused dense Schur")
    print(f"phase 11 local BA: {len(lbas)} calls, every observation kept (obs_cap = Nf = {Nf}): at "
          f"most {C} cameras x {P} points, {O} observation slots; dense-Schur estimate "
          f"{ba_mod.dense_schur_bytes(C, P)} bytes (auto_dense_schur: within the 4 GiB budget); "
          f"measured peak {max(x[3] for x in lbas)} bytes above the map "
          f"(torch.cuda.max_memory_allocated)")
    print(f"phase 11 launches on the main path {launches}; B1 by call {sites}; B2 by atlas "
          f"{b2_sides}")

    with _build.force_plain():
        pre_p = E.replay(dev, "stereo", N_STEREO, n_track=N_STEREO_PREFIX,
                         on_frame=_prefix_recorder(N_STEREO_PREFIX, rec_p))
    kf_in_prefix = sum(rep.keyframe[:N_STEREO_PREFIX])  # frame 0 is the first
    check(kf_in_prefix >= 2, f"phase 11 prefix holds {kf_in_prefix} keyframes")
    line = _same_prefix(rec_k, rec_p, rep.states, pre_p.states, "phase 11 prefix")
    print(f"phase 11 kernels vs plain prefix: {line}")

    right = next(a for _, side, a in b2_calls if a is not None)
    got = cuda_fast.fast_score_nms(right, 7.0, 20.0)
    ref = feat.fast_score_nms_plain(right, 7.0, 20.0)
    torch.cuda.synchronize()
    check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
          "B2 right atlas differs from plain")
    print(f"phase 11 B2 right atlas {tuple(right.shape)} of frame 0: exact (tolerance 0) vs plain, "
          f"{int((got[0] > 0).sum())} corners after NMS")
    args = {site: next(c[1] for c in calls if c[0] == site) for site in B1_SITES.values()
            if sites[site]}
    return dict(rep=rep, launches=launches, sites=sites, args=args, right=right,
                match_ms=match_ms)


def phase12_rgbd_raw(dev) -> dict:
    """Phase 12: RGB-D over N_RGBD frames (gates as phase 11's, its first
    N_RGBD_PREFIX frames kernels vs plain) and raw stereo over N_RAW frames
    through `enable_rectification` (the remap card vs CPU, every frame OK,
    the SE3 ATE under phase 11's gate). Returns the launches of each run."""
    from orbslam3_tpu_torch import convert
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch.ops import _build, cuda_fast, cuda_match
    from orbslam3_tpu_torch.ops.rectify import StereoRectifier

    rec_k, rec_p = {}, {}
    torch.cuda.synchronize()
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    rep = E.replay(dev, "rgbd", N_RGBD, on_frame=_prefix_recorder(N_RGBD_PREFIX, rec_k))
    rgbd = {"fast_nms": cuda_fast.LAUNCHES, "hamming_top2": cuda_match.LAUNCHES}
    check(rgbd["fast_nms"] == N_RGBD and rgbd["hamming_top2"] > 0, f"RGB-D launches {rgbd}")
    _replay_gates(rep, "phase 12 RGB-D", RGBD_ATE_GATE, JAX_RGBD_ATE_SE3)
    with _build.force_plain():
        pre_p = E.replay(dev, "rgbd", N_RGBD, n_track=N_RGBD_PREFIX,
                         on_frame=_prefix_recorder(N_RGBD_PREFIX, rec_p))
    print(f"phase 12 RGB-D launches on the main path {rgbd}; kernels vs plain prefix: "
          f"{_same_prefix(rec_k, rec_p, rep.states, pre_p.states, 'phase 12 RGB-D prefix')}")

    _, imgs, _ = E.euroc_frames(1, raw=True)
    rig = E.raw_stereo_rig()
    got = StereoRectifier(*rig, dev)(imgs[0, 0], imgs[0, 1])
    want = StereoRectifier(*rig, "cpu")(imgs[0, 0], imgs[0, 1])
    d_remap = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    check(d_remap <= 1e-4, f"remap_bilinear card vs CPU: {d_remap}")
    torch.cuda.synchronize()
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    raw = E.replay(dev, "raw_stereo", N_RAW)
    raw_l = {"fast_nms": cuda_fast.LAUNCHES, "hamming_top2": cuda_match.LAUNCHES}
    check(raw_l["fast_nms"] == 2 * N_RAW and raw_l["hamming_top2"] > 0, f"raw launches {raw_l}")
    check(all(x == "OK" for x in raw.states), f"raw stereo: a frame not OK: {raw.states}")
    check(np.isfinite(raw.pos).all() and raw.ate_se3 <= STEREO_ATE_GATE,
          f"raw stereo: SE3 ATE {raw.ate_se3} m above the gate {STEREO_ATE_GATE} m")
    print(f"phase 12 raw stereo: remap_bilinear of a raw pair on the card within {d_remap:.1e} of "
          f"the CPU's (tolerance 1e-4); {N_RAW} frames through enable_rectification, all OK, "
          f"{raw.n_kf} keyframes, {raw.n_mp} map points, SE3 ATE {raw.ate_se3:.6f} m (gate "
          f"{STEREO_ATE_GATE:.6f} m), scale {raw.scale:.4f}, median "
          f"{statistics.median(raw.ms):.2f} ms per frame; launches on the main path {raw_l}")
    return dict(rgbd=rgbd, raw=raw_l)


def _vi_recorder(into: dict):
    """An `on_frame` for an inertial replay: each frame's associations, pose
    and body velocity; the frame at which the IMU was initialized; and the
    map VI_PREFIX_AFTER_INIT frames after it (`kf_vel` too), which is where
    the kernels-vs-plain prefix ends."""
    def on_frame(k, slam):
        if "map" in into:
            return
        f = slam.tracker.last_frame
        into.setdefault("frames", []).append(
            (f.mp_assoc.copy() if f is not None else None, np.array(f.R) if f else None,
             np.array(f.t) if f else None, np.array(slam.tracker.body_vel)))
        if "init" not in into and slam.mapper.imu_initialized:
            into["init"] = k
        if into.get("init") is not None and k == into["init"] + VI_PREFIX_AFTER_INIT:
            s = slam.store.state
            into["map"] = {name: getattr(s, name).cpu().numpy() for name in (
                "kf_valid", "kf_ur", "kf_mp", "kf_R", "kf_t", "kf_vel", "kf_bias_g", "mp_valid",
                "mp_pos")}
    return on_frame


def phase13_mono_inertial(dev) -> dict:
    """Phase 13: the mono-inertial `System` (config 3: `entry.replay(cuda,
    "mono_vi", N_VI)`, IMU_MONOCULAR at 1000 features, 8 levels, Kmax 256,
    Pmax 16384, 20 Hz camera, 200 Hz IMU) with the gates and lines of the
    module docstring. Returns the kernels' launches on the main path."""
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch.ops import cuda_fast, cuda_match
    from orbslam3_tpu_torch.optim import inertial as vi
    from orbslam3_tpu_torch.pipeline.tracking import Tracker

    solves = []
    solve = vi.solve_vi_ba

    def sized_solve(model, params, prob, **kw):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = solve(model, params, prob, **kw)
        solves.append((prob.points.shape[0], prob.state.R.shape[0], prob.obs_cam.shape[0],
                       torch.cuda.max_memory_allocated() - base))
        return out

    rec_k = {}
    torch.cuda.synchronize()
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    vi.solve_vi_ba = sized_solve
    t0 = time.perf_counter()
    try:
        with _b1_calls([], keep_args=False) as calls:
            rep = E.replay(dev, "mono_vi", N_VI, on_frame=_vi_recorder(rec_k))
    finally:
        vi.solve_vi_ba = solve
    wall_s = time.perf_counter() - t0
    launches = {"fast_nms": cuda_fast.LAUNCHES, "hamming_top2": cuda_match.LAUNCHES}
    sites = {site: sum(c[0] == site for c in calls) for site in B1_SITES.values()}
    check(sum(sites.values()) == launches["hamming_top2"], f"phase 13 B1 calls {sites}")
    states = rep.states
    init = states.index("OK") if "OK" in states else None
    print(f"phase 13 outcome: map initialized at frame {init}, IMU initialized at frame "
          f"{rep.imu_init_frame} with {rep.imu_init_kfs} keyframes (JAX {JAX_VI_INIT_FRAME}, "
          f"{JAX_VI_INIT_KFS}), VIBA1 at frame {rep.viba1} (JAX {JAX_VI_VIBA1_FRAME}), VIBA2 "
          f"{rep.viba2}; {rep.n_kf} keyframes, {rep.n_mp} map points; SE3 ATE "
          f"{rep.ate_se3:.6f} m, Sim3 ATE {rep.ate:.6f} m, scale {rep.scale:.5f}; states "
          f"{ {x: states.count(x) for x in sorted(set(states))} }")
    check(init is not None and all(x == "OK" for x in states[init:]),
          f"phase 13: a frame not OK after the map's initialization: {states}")
    check(rep.imu_init_kfs is not None and abs(rep.imu_init_kfs - JAX_VI_INIT_KFS) <= 2,
          f"phase 13: IMU initialized with {rep.imu_init_kfs} keyframes, JAX {JAX_VI_INIT_KFS}")
    check(rep.viba1 is not None, "phase 13: VIBA1 did not run")
    check(np.isfinite(rep.pos).all() and rep.pos.shape == (len(rep.ts), 3),
          "phase 13: trajectory not finite or misshapen")
    check(rep.ate_se3 <= VI_ATE_SE3_GATE, f"phase 13: SE3 ATE {rep.ate_se3} m above "
          f"{VI_ATE_SE3_GATE} m")
    check(rep.ate <= VI_ATE_SIM3_GATE, f"phase 13: Sim3 ATE {rep.ate} m above {VI_ATE_SIM3_GATE} m")
    check(abs(rep.scale - 1) <= VI_SCALE_TOL, f"phase 13: Sim3 scale {rep.scale}, tolerance "
          f"{VI_SCALE_TOL}")
    after = [k for k in range(rep.imu_init_frame + 1, N_VI) if states[k] == "OK"]
    share = sum(rep.pi_taken[k] for k in after) / max(len(after), 1)
    check(after and share >= 0.8, f"phase 13: pose-inertial result taken on {share:.4f} of "
          f"{len(after)} tracked frames after the IMU initialization")
    check(all(n == 1 for n in rep.b2) and launches["fast_nms"] == N_VI,
          f"phase 13: B2 launches per frame {sorted(set(rep.b2))}")
    by_kind = _inertial_by_kind(rep)
    for kind, want in (("tracked before IMU init", Tracker.HOST_SYNCS_PER_FRAME),
                       ("tracked after IMU init", Tracker.HOST_SYNCS_PER_INERTIAL_FRAME)):
        got = sorted(set(n for n, _ in by_kind.get(kind, [])))
        check(got == [want], f"phase 13: host syncs per {kind} frame {got}, documented {want}")
    med = statistics.median
    print(f"phase 13 mono-inertial: {N_VI} frames at 752x480, 1000 features, 200 Hz IMU; "
          f"pose-inertial result taken on {share:.4f} of the {len(after)} tracked frames after "
          f"the IMU initialization ({sum(rep.pi_taken)} frames); SE3 ATE {rep.ate_se3:.6f} m "
          f"(gate {VI_ATE_SE3_GATE:.6f} m: 2 x the JAX System's {JAX_VI_ATE_SE3} m, or 0.01), "
          f"Sim3 ATE {rep.ate:.6f} m (gate {VI_ATE_SIM3_GATE:.6f} m), scale {rep.scale:.5f} "
          f"(tolerance {VI_SCALE_TOL:.4f}); {N_VI / (sum(rep.ms) / 1e3):.2f} frames/s "
          f"({wall_s:.1f} s wall, {rep.render_s:.1f} s of rendering)")
    print("phase 13 host syncs and ms per frame kind: " + "; ".join(
        f"{kind} {len(v)} frames, syncs median {med([n for n, _ in v])} (max "
        f"{max(n for n, _ in v)}), ms median {med([m for _, m in v]):.2f}"
        for kind, v in sorted(by_kind.items())))
    calls = rep.inertial_ms
    for name, v in sorted(calls.items()):
        dev_ms = [d for _, _, d in v]
        shown = v if len(v) <= 20 else v[:3] + v[-3:]  # every call of the rarer ones
        print(f"phase 13 {name}: {len(v)} calls, device ms (CUDA events) median "
              f"{med(dev_ms):.3f} max {max(dev_ms):.3f}, host ms median "
              f"{med([h for _, h, _ in v]):.3f}; (frame, host ms, device ms) "
              f"{[(f, round(h, 3), round(d, 3)) for f, h, d in shown]}")
    full = calls.get("full VI-BA", [])
    check(len(full) >= 2, f"phase 13: {len(full)} full VI-BAs (the init-time one and VIBA1)")
    print("phase 13 full VI-BAs (the init-time one, VIBA1, ...): " + "; ".join(
        f"frame {f} {d:.3f} ms device, {h:.3f} ms host" for f, h, d in full))
    P, K, O, peak = max(solves, key=lambda x: x[1])
    lP, lK, lO, lpeak = min(solves, key=lambda x: x[1])
    print(f"phase 13 VI-BA coupling tensor (P, K, 3, 6) float32: full map {P} points x {K} "
          f"keyframes = {vi.coupling_bytes(P, K)} bytes ({O} observation slots, measured peak "
          f"{peak} bytes above the map); local inertial BA {lP} x {lK} = "
          f"{vi.coupling_bytes(lP, lK)} bytes (peak {lpeak}); {len(solves)} solves")
    print(f"phase 13 launches on the main path {launches}; per frame B2 {sorted(set(rep.b2))}, "
          f"B1 median {med(rep.b1)} (max {max(rep.b1)}) over {N_VI} frames; B1 by call {sites}")

    print(f"phase 13 kernels vs plain prefix: "
          f"{_same_vi_prefix(dev, 'mono_vi', N_VI, rep, rec_k, 'phase 13')}")
    return dict(rep=rep, launches=launches)


def _same_vi_prefix(dev, sensor: str, n_frames: int, rep, rec_k: dict, what: str) -> str:
    """Replay the prefix of an inertial run through the IMU initialization
    and VI_PREFIX_AFTER_INIT frames after it through the plain versions and
    gate it against the kernels' run (`rep`, recorded by
    `_vi_recorder(rec_k)`): states, associations, keyframe rows and point validity equal;
    poses, velocities, biases and points within 1e-4. Returns its line."""
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch.ops import _build

    rec_p = {}
    n_prefix = rec_k["init"] + VI_PREFIX_AFTER_INIT + 1
    with _build.force_plain():
        pre_p = E.replay(dev, sensor, n_frames, on_frame=_vi_recorder(rec_p),
                         n_track=n_prefix)
    states = rep.states
    check(states[:n_prefix] == pre_p.states, f"{what} prefix: states {states[:n_prefix]} vs "
          f"{pre_p.states}")
    check(rec_p.get("init") == rec_k["init"], f"{what} prefix: IMU initialized at frame "
          f"{rec_p.get('init')} vs {rec_k['init']}")
    dP = 0.0
    for k, (a, b) in enumerate(zip(rec_k["frames"][:n_prefix], rec_p["frames"])):
        check((a[0] is None) == (b[0] is None) and (a[0] is None or np.array_equal(a[0], b[0])),
              f"{what} prefix: associations of frame {k} differ")
        if a[1] is not None:
            dP = max(dP, *(float(np.abs(x - y).max()) for x, y in zip(a[1:], b[1:])))
    m_k, m_p = rec_k["map"], rec_p["map"]
    kf = m_p["kf_valid"]
    for name in ("kf_valid", "kf_ur", "kf_mp", "mp_valid"):
        check(np.array_equal(m_k[name][kf] if name.startswith("kf_") else m_k[name],
                             m_p[name][kf] if name.startswith("kf_") else m_p[name]),
              f"{what} prefix: {name} differs")
    for name in ("kf_R", "kf_t", "kf_vel", "kf_bias_g"):
        dP = max(dP, float(np.abs(m_k[name][kf] - m_p[name][kf]).max()))
    v = m_p["mp_valid"]
    dX = float(np.abs(m_k["mp_pos"][v] - m_p["mp_pos"][v]).max())
    check(dP <= 1e-4 and dX <= 1e-4, f"{what} prefix: poses and velocities within {dP}, "
          f"points within {dX}")
    return (f"{n_prefix} frames (the IMU initialization at frame {rec_k['init']} and "
            f"{VI_PREFIX_AFTER_INIT} after it): states and associations equal on every frame; "
            f"{int(kf.sum())} keyframes, kf_ur and kf_mp rows and {int(v.sum())} points' "
            f"validity equal; poses, velocities and biases within {dP:.1e}, points within "
            f"{dX:.1e}")


def _inertial_by_kind(rep):
    """{frame kind: [(syncs, ms)]}, tracked frames split at the IMU
    initialization."""
    by_kind = {}
    for k, (kind, n_sync, m) in enumerate(zip(rep.frame_kinds(), rep.syncs, rep.ms)):
        if kind == "tracked":
            after = rep.imu_init_frame is not None and k > rep.imu_init_frame
            kind = "tracked after IMU init" if after else "tracked before IMU init"
        by_kind.setdefault(kind, []).append((n_sync, m))
    return by_kind


def phase14_stereo_fisheye_inertial(dev) -> dict:
    """Phase 14: config 4, the stereo-inertial two-camera fisheye rig
    (`entry.replay(cuda, "stereo_vi_fisheye", N_FE)`), with the gates and
    lines of the module docstring. Returns the kernels' launches on the
    main path, the B1 calls by site with the fisheye match's arguments, a
    512x512 right atlas and the frames' kinds."""
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch.ops import cuda_fast, cuda_match
    from orbslam3_tpu_torch.ops import features as feat
    from orbslam3_tpu_torch.pipeline.tracking import Tracker

    rec_k = {}
    frame = [0]
    vi_rec = _vi_recorder(rec_k)

    def on_frame(k, slam):
        vi_rec(k, slam)
        frame[0] = k + 1

    torch.cuda.synchronize()
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    t0 = time.perf_counter()
    with _b1_calls([], keep_args={"fisheye match"}) as calls, _b2_calls([], frame) as b2_calls:
        rep = E.replay(dev, "stereo_vi_fisheye", N_FE, on_frame=on_frame)
    wall_s = time.perf_counter() - t0
    launches = {"fast_nms": cuda_fast.LAUNCHES, "hamming_top2": cuda_match.LAUNCHES}
    sites = {site: sum(c[0] == site for c in calls)
             for site in list(B1_SITES.values()) + list(B1_RIG_SITES.values())}
    check(sum(sites.values()) == launches["hamming_top2"], f"phase 14 B1 calls {sites}")
    check(sites["fisheye match"] == 2 * N_FE, f"phase 14 fisheye match B1 launches {sites}")
    check(launches["fast_nms"] == 2 * N_FE and all(n == 2 for n in rep.b2),
          f"phase 14 B2 launches {launches['fast_nms']}, per frame {sorted(set(rep.b2))}")
    b2_sides = {side: sum(c[1] == side for c in b2_calls) for side in ("left atlas", "right atlas")}
    check(b2_sides == {"left atlas": N_FE, "right atlas": N_FE}, f"B2 by side {b2_sides}")
    states = rep.states
    print(f"phase 14 outcome: map initialized at frame {states.index('OK')}, IMU initialized at "
          f"frame {rep.imu_init_frame} with {rep.imu_init_kfs} keyframes (JAX "
          f"{JAX_FE_INIT_FRAME}, {JAX_FE_INIT_KFS}), VIBA1 at frame {rep.viba1} (JAX "
          f"{JAX_FE_VIBA1_FRAME}), VIBA2 {rep.viba2}; {rep.n_kf} keyframes, {rep.n_mp} map "
          f"points; SE3 ATE {rep.ate_se3:.6f} m, Sim3 ATE {rep.ate:.6f} m, scale "
          f"{rep.scale:.5f}; states { {x: states.count(x) for x in sorted(set(states))} }")
    check(states == ["OK"] * N_FE, f"phase 14: a frame not OK (single-frame init): {states}")
    check(rep.imu_init_kfs is not None and abs(rep.imu_init_kfs - JAX_FE_INIT_KFS) <= 2,
          f"phase 14: IMU initialized with {rep.imu_init_kfs} keyframes, JAX {JAX_FE_INIT_KFS}")
    check(rep.viba1 is not None, "phase 14: VIBA1 did not run")
    check(np.isfinite(rep.pos).all() and rep.pos.shape == (len(rep.ts), 3),
          "phase 14: trajectory not finite or misshapen")
    check(rep.ate_se3 <= FE_ATE_GATE, f"phase 14: SE3 ATE {rep.ate_se3} m above {FE_ATE_GATE} m")
    check(abs(rep.scale - 1) <= FE_SCALE_TOL, f"phase 14: Sim3 scale {rep.scale}, tolerance "
          f"{FE_SCALE_TOL}")
    after = [k for k in range(rep.imu_init_frame + 1, N_FE) if states[k] == "OK"]
    share = sum(rep.pi_taken[k] for k in after) / max(len(after), 1)
    check(after and share >= 0.8, f"phase 14: pose-inertial result taken on {share:.4f} of "
          f"{len(after)} tracked frames after the IMU initialization")
    by_kind = _inertial_by_kind(rep)
    for kind, want in (("tracked before IMU init", Tracker.HOST_SYNCS_PER_STEREO_FRAME),
                       ("tracked after IMU init", Tracker.HOST_SYNCS_PER_STEREO_INERTIAL_FRAME)):
        got = sorted(set(n for n, _ in by_kind.get(kind, [])))
        check(got == [want], f"phase 14: host syncs per {kind} frame {got}, documented {want}")
    med = statistics.median
    print(f"phase 14 stereo-inertial fisheye rig: {N_FE} frames of the 512x512 KB8 pair, 1000 "
          f"features, 200 Hz IMU; pose-inertial result taken on {share:.4f} of the {len(after)} "
          f"tracked frames after the IMU initialization; SE3 ATE {rep.ate_se3:.6f} m (gate "
          f"{FE_ATE_GATE:.6f} m: 2 x the JAX System's {JAX_FE_ATE_SE3} m, or 0.01), scale "
          f"{rep.scale:.5f} (tolerance {FE_SCALE_TOL:.4f}); {N_FE / (sum(rep.ms) / 1e3):.2f} "
          f"frames/s ({wall_s:.1f} s wall, {rep.render_s:.1f} s of rendering)")
    print("phase 14 host syncs and ms per frame kind: " + "; ".join(
        f"{kind} {len(v)} frames, syncs median {med([n for n, _ in v])} (max "
        f"{max(n for n, _ in v)}), ms median {med([m for _, m in v]):.2f}"
        for kind, v in sorted(by_kind.items())))
    calls_ms = rep.inertial_ms
    for name in ("fisheye match", "pose solve with right rows", "pose-inertial (last frame)",
                 "pose-inertial (last keyframe)", "preintegration", "try_initialize",
                 "full VI-BA", "local inertial BA"):
        v = calls_ms.get(name, [])
        check(v or name.startswith("pose-inertial"), f"phase 14: no span {name!r}")
        if not v:
            continue
        dev_ms = [d for _, _, d in v]
        print(f"phase 14 {name}: {len(v)} calls, device ms (CUDA events) median "
              f"{med(dev_ms):.3f} max {max(dev_ms):.3f}, host ms median "
              f"{med([h for _, h, _ in v]):.3f}")
    check(len(calls_ms["fisheye match"]) == N_FE, "phase 14: a frame without the fisheye match")
    print(f"phase 14 launches on the main path {launches}; per frame B2 {sorted(set(rep.b2))}, "
          f"B1 median {med(rep.b1)} (max {max(rep.b1)}); B1 by call {sites}; B2 by atlas "
          f"{b2_sides}")
    line = _same_vi_prefix(dev, "stereo_vi_fisheye", N_FE, rep, rec_k, "phase 14")
    print(f"phase 14 kernels vs plain prefix: {line}")
    right = next(a for _, side, a in b2_calls if a is not None)
    got = cuda_fast.fast_score_nms(right, 7.0, 20.0)
    ref = feat.fast_score_nms_plain(right, 7.0, 20.0)
    torch.cuda.synchronize()
    check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
          "B2 fisheye right atlas differs from plain")
    print(f"phase 14 B2 right atlas {tuple(right.shape)} of frame 0: exact (tolerance 0) vs plain, "
          f"{int((got[0] > 0).sum())} corners after NMS")
    args = next(c[1] for c in calls if c[0] == "fisheye match")
    return dict(rep=rep, launches=launches, sites=sites, args=args, right=right)


def check(ok, what: str) -> None:
    """Fail the run (every phase's checks are hard failures)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save-inputs", metavar="FILE",
                    help="write phase 7's kernel inputs to FILE (torch.save)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from orbslam3_tpu_torch import convert
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch import kernel_bench as KB
    from orbslam3_tpu_torch.ops import _build, cuda_fast, cuda_match
    from orbslam3_tpu_torch.ops import features as feat
    from orbslam3_tpu_torch.pipeline import frame as fr
    from orbslam3_tpu_torch.pipeline import local_mapping as lmap

    dev = torch.device("cuda", 0)
    walls = {"start": time.perf_counter()}  # phase -> the script's clock at its end
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    print(f"build: {'%.1f s nvcc' % built if built is not None else 'cached'}, "
          f"{time.perf_counter() - t0:.1f} s to load")
    print(_build.resource_report(), end="")
    walls["build"] = time.perf_counter()

    cfg = E.EUROC
    orb = cfg.orb
    step, args = E.entry(dev, cfg)
    img, state, local_mask, R_pred, t_pred, last_mp, last_octave = args

    # --- Phase 1: B2 on the EuRoC atlas and on its small and plateau images --
    atlas = feat.build_atlas(img, orb)
    err_b2 = 0.0
    for name, x in [("EuRoC atlas", atlas)] + [(n, convert.tensor(c, dev))
                                               for n, c in KB.b2_cases()]:
        n0 = cuda_fast.LAUNCHES
        s_k, i_k = cuda_fast.fast_score_nms(x, orb.min_th, orb.ini_th)
        check(cuda_fast.LAUNCHES == n0 + 1, f"B2 {name}: not one launch")
        s_p, i_p = feat.fast_score_nms_plain(x, orb.min_th, orb.ini_th)
        torch.cuda.synchronize()
        err_b2 = max(err_b2, float((s_k - s_p).abs().max()))
        # Both pad with zeros, so they agree on every pixel, the border included.
        check(torch.equal(s_k, s_p), f"B2 {name}: score differs from plain")
        check(torch.equal(i_k, i_p), f"B2 {name}: pass_ini differs from plain")
        check(int((s_k > 0).sum()) > (10000 if x is atlas else 0), f"B2 {name}: no corners")
        print(f"phase 1 B2 fast_nms {name} {tuple(x.shape)}: exact vs plain on every pixel "
              f"(tolerance 0), {int((s_k > 0).sum())} corners after NMS, 1 launch")

    # --- Phase 2: B1 at the slice's two shapes --------------------------
    f = feat.extract(img, orb)
    c = E._consts(cfg, dev)
    uv, visible, lvl, vcos = fr.frustum_and_scale(
        c.model, c.params, R_pred, t_pred, state.mp_pos, state.mp_valid, state.mp_normal,
        state.mp_min_dist, state.mp_max_dist, c.img_wh, n_levels=orb.n_levels)
    win = cuda_match.MatchWindow(uv, f.uv, fr.search_radius(vcos, lvl), f.octave,
                                 torch.clamp(lvl - 1, min=0), lvl + 1)

    def b1_local():
        return cuda_match.hamming_top2(state.mp_desc, f.desc, f.valid, win)

    out_k = b1_local()
    with _build.force_plain():
        out_p = b1_local()
    torch.cuda.synchronize()
    # Every row is compared: the kernel computes all 16384 queries whatever
    # their validity (the synthetic map's normals face away, so the frustum
    # test passes no point at this pose and validity would leave none).
    for name, k_, p_ in zip(("d1", "d2", "j1"), out_k, out_p):
        check(torch.equal(k_, p_), f"B1 windowed {name} differs from plain")
    err_b1 = max(float((out_k[0] - out_p[0]).abs().max()),
                 float((out_k[1] - out_p[1]).abs().max()))
    n_in_window = int((out_k[0] < 1e9).sum())

    rk = cfg.ref_kf
    kf_desc, kf_valid = state.kf_desc[rk], state.kf_feat_valid[rk]

    def b1_cross():
        fwd = cuda_match.hamming_top2(kf_desc, f.desc, f.valid)
        back = cuda_match.hamming_top2(f.desc, kf_desc, kf_valid)
        return fwd + back

    out_k = b1_cross()
    with _build.force_plain():
        out_p = b1_cross()
    torch.cuda.synchronize()
    for i, (k_, p_) in enumerate(zip(out_k, out_p)):
        check(torch.equal(k_, p_), f"B1 cross-check output {i} differs from plain")
    print(f"phase 2 B1 hamming_top2: windowed {tuple(state.mp_desc.shape[:1])}x{f.desc.shape[0]} "
          f"exact (tolerance 0) vs plain on all rows ({n_in_window} with a key in their window, "
          f"{int(visible.sum())} visible); cross-checked {kf_desc.shape[0]}x{f.desc.shape[0]} "
          f"(2 launches) exact on all rows")
    cross_args = (kf_desc, f.desc, f.valid, None)  # the forward launch of the pair

    # B1's edge cases, every row exact.
    cases = KB.b1_edge_cases()
    n_rows = 0
    for name, case in cases:
        a = KB.b1_case_args(case, dev)
        got = cuda_match.hamming_top2(*a)
        ref = cuda_match.hamming_top2_plain(*a)
        torch.cuda.synchronize()
        for what, k_, p_ in zip(("d1", "d2", "j1"), got, ref):
            check(torch.equal(k_, p_), f"B1 edge case {name}: {what} differs from plain")
        n_rows += a[0].shape[0]
    print(f"phase 2 B1 edge cases: {len(cases)} cases, {n_rows} rows, d1/d2/j1 exact "
          f"(tolerance 0) vs plain")

    walls["phases 1-2"] = time.perf_counter()
    # --- Phase 3: the slice, through both entry points -------------------
    rng = np.random.default_rng(1)
    img_np = img.cpu().numpy()

    def noisy():
        return convert.tensor(img_np + rng.normal(0, 1.0, img_np.shape).astype(np.float32), dev)

    R, t, n_inl = step(noisy(), *args[1:])
    check(torch.isfinite(R).all() and torch.isfinite(t).all(), "entry() pose not finite")
    check(int(n_inl) >= MIN_INLIERS, f"entry() n_inl {int(n_inl)} < {MIN_INLIERS}")
    run = E.staged_pipeline(dev, cfg)
    frames = [noisy() for _ in range(N_FRAMES)]
    run(frames[0], *args[1:])  # first call: per-shape tables and caches
    torch.cuda.synchronize()
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    wall, bundles = [], []
    for fimg in frames:
        t0 = time.perf_counter()
        bundles.append(run(fimg, *args[1:]))  # ends in the bundle fetch (synchronous)
        wall.append((time.perf_counter() - t0) * 1e3)
    launches = {"fast_nms": cuda_fast.LAUNCHES, "hamming_top2": cuda_match.LAUNCHES}
    check(launches["fast_nms"] >= N_FRAMES and launches["hamming_top2"] >= 2 * N_FRAMES, str(launches))
    for bnd in bundles:
        check(bool(bnd["used_a"]), "motion model not used")
        check(np.isfinite(bnd["R"]).all() and np.isfinite(bnd["t"]).all(), "pose not finite")
        check(int(bnd["n_inl"]) >= MIN_INLIERS, f"n_inl {int(bnd['n_inl'])} < {MIN_INLIERS}")
    n_inls = [int(bnd["n_inl"]) for bnd in bundles]
    med = statistics.median(wall)
    print(f"phase 3 slice: {N_FRAMES} frames via staged_pipeline, launches {launches}, "
          f"n_inl min {min(n_inls)} median {statistics.median(n_inls)}, used_a all, "
          f"median {med:.2f} ms/frame ({1e3 / med:.1f} frames/s), "
          f"entry() n_inl {int(n_inl)}")

    # Host synchronisations in one frame: the read of the motion model's
    # success and the bundle fetch (`_track_step`'s docstring).
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(frames[1], *args[1:])
    torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
    check(len(syncs) == 2, f"{len(syncs)} host syncs in one frame, expected 2: {syncs}")
    print(f"phase 3 host syncs per frame: {len(syncs)}")

    # --- Phase 4: one frame through the kernels and through the plain versions,
    # on the scene as built and on its variant where the local-map stage matches.
    frame_calls = []
    for name, a in (("as built", args), ("local map", _local_map_variant(args, cfg.ref_kf))):
        with _b1_calls(frame_calls, keep_args=name == "local map"):
            got_k = run(frames[0], *a[1:])
        with _build.force_plain():
            got_p = run(frames[0], *a[1:])
        check(np.array_equal(got_k["assoc"], got_p["assoc"]), f"{name}: assoc, kernels vs plain")
        dR = float(np.abs(got_k["R"] - got_p["R"]).max())
        dt = float(np.abs(got_k["t"] - got_p["t"]).max())
        check(dR <= 1e-4 and dt <= 1e-4, f"{name}: |dR| {dR}, |dt| {dt}")
        n_assoc = int((got_k["assoc"] >= 0).sum())
        if name == "local map":
            check(n_assoc >= int(got_k["n_a"]) + N_HIDDEN // 2,
                  f"local-map stage found {n_assoc - int(got_k['n_a'])} of {N_HIDDEN} points")
        print(f"phase 4 kernels vs plain frame ({name}): assoc equal ({n_assoc} associated, "
              f"{int(got_k['n_a'])} by the motion model), n_inl {int(got_k['n_inl'])} vs "
              f"{int(got_p['n_inl'])}, max |dR| {dR:.2e}, max |dt| {dt:.2e}")
    # The local-map variant's frame: the motion model's and the local map's calls.
    b1_shapes = {site: a for site, a, _ in frame_calls if a is not None}
    check(sorted(b1_shapes) == ["local map", "motion model"],
          f"B1 calls of a frame: {[c[0] for c in frame_calls]}")

    walls["phases 3-4"] = time.perf_counter()
    # --- Phase 5: the mapping pass ----------------------------------------
    mcfg = E.EUROC_MAPPING
    mrun, (mstate,) = E.mapping_pass(dev, mcfg)
    mscene = E.make_mapping_scene(mcfg)
    variant = E.mapping_variant(mscene)
    vstate = convert.to_torch(variant.state, dev)
    n_nb = mcfg.n_nb
    mc = E._consts(E.EUROC, dev)  # the mapping scene's camera and ORB levels

    # B1 at the fuse shape (1024 candidates x 1024 keypoints, windowed), on
    # the variant's first neighbour, where planted keypoints match.
    nbk = int(mscene.nb_ids[0])
    cand = convert.tensor(mscene.cand_ids, dev).long()
    Rk, tk = vstate.kf_R[nbk], vstate.kf_t[nbk]
    uv_c, vis_c, lvl_c, _ = fr.frustum_and_scale(
        mc.model, mc.params, Rk, tk, vstate.mp_pos[cand], vstate.mp_valid[cand],
        vstate.mp_normal[cand], vstate.mp_min_dist[cand], vstate.mp_max_dist[cand], mc.img_wh)
    win_f = cuda_match.MatchWindow(uv_c, vstate.kf_uv[nbk], 3.0 * 1.2 ** lvl_c.float(),
                                   vstate.kf_octave[nbk], torch.clamp(lvl_c - 1, min=0), lvl_c)

    def b1_fuse():
        return cuda_match.hamming_top2(vstate.mp_desc[cand], vstate.kf_desc[nbk],
                                       vstate.kf_feat_valid[nbk], win_f)

    out_k = b1_fuse()
    with _build.force_plain():
        out_p = b1_fuse()
    torch.cuda.synchronize()
    for name, k_, p_ in zip(("d1", "d2", "j1"), out_k, out_p):
        check(torch.equal(k_, p_), f"B1 fuse-shape {name} differs from plain")
    err_b1 = max(err_b1, float((out_k[0] - out_p[0]).abs().max()),
                 float((out_k[1] - out_p[1]).abs().max()))
    n_zero = int((out_k[0] == 0).sum())
    print(f"phase 5 B1 fuse shape {cand.shape[0]}x{vstate.kf_desc.shape[1]} windowed: exact "
          f"(tolerance 0) vs plain, {n_zero} queries at distance 0")
    b1_shapes["cross-check"] = cross_args
    b1_shapes["fuse into a neighbour"] = (vstate.mp_desc[cand], vstate.kf_desc[nbk],
                                          vstate.kf_feat_valid[nbk], win_f)

    # The main path: one pass through the entry point, counts read around it.
    E.fetch_mapping(mrun(mstate))  # first call: per-shape tables and caches
    torch.cuda.synchronize()
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    ref_k = E.fetch_mapping(mrun(mstate))
    launches5 = {"fast_nms": cuda_fast.LAUNCHES, "hamming_top2": cuda_match.LAUNCHES}
    check(launches5["hamming_top2"] >= n_nb, f"mapping pass launches {launches5}")
    wall5 = []
    for _ in range(N_PASSES):
        t0 = time.perf_counter()
        E.fetch_mapping(mrun(mstate))
        wall5.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = mrun(mstate)
        n_before = len(caught)
        E.fetch_mapping(out)
    torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
    check(n_before == 0, f"{n_before} host syncs before the mapping pass's fetch: {syncs}")
    print(f"phase 5 mapping pass (Kmax {mcfg.Kmax}, {mcfg.n_kf} KFs, {n_nb} neighbours, "
          f"{mcfg.n_cand} candidates, LBA window {mcfg.n_window} + fixed {mcfg.n_fixed}, "
          f"{mcfg.iters} LM iterations): launches {launches5}, median "
          f"{statistics.median(wall5):.2f} ms/pass over {N_PASSES} (min {min(wall5):.2f}), "
          f"host syncs {n_before} before the fetch, {len(syncs)} with it")

    window = convert.tensor(mscene.window_ids, dev)
    fixed = convert.tensor(mscene.fixed_ids, dev)
    for name, st0 in (("reference", mstate), ("variant", vstate)):
        got_k = E.fetch_mapping(mrun(st0))
        with _build.force_plain():
            got_p = E.fetch_mapping(mrun(st0))
        for k in ("good", "idx", "rows", "adds", "conflict", "n_bad"):
            check(np.array_equal(got_k[k], got_p[k]), f"{name}: {k}, kernels vs plain")
        g = got_k["good"]
        check(np.array_equal(got_k["Xw"][g], got_p["Xw"][g]), f"{name}: Xw, kernels vs plain")
        dR = float(np.abs(got_k["kf_R"] - got_p["kf_R"]).max())
        dt = float(np.abs(got_k["kf_t"] - got_p["kf_t"]).max())
        check(dR <= 1e-4 and dt <= 1e-4, f"{name}: |dR| {dR}, |dt| {dt}")
        for k in ("Xw", "kf_R", "kf_t", "mp_pos", "cost"):
            check(np.isfinite(got_k[k]).all(), f"{name}: {k} not finite")
        cost0 = float(lmap.local_ba(mc.model, mc.params, st0, window, fixed, mc.sigma2,
                                    iters=0)[1])
        cost1 = float(got_k["cost"])
        check(cost1 < cost0, f"{name}: LBA cost {cost1} not below the start {cost0}")
        n_good = int(g.any(0).sum())
        adds = got_k["adds"].tolist()
        n_conf = int(got_k["conflict"].sum())
        kf0_before = st0.kf_mp[0].cpu().numpy()
        kf0_erased = int(((kf0_before >= 0) & (got_k["kf_mp"][0] < 0)).sum())
        if name == "variant":
            check(n_good >= 100, f"variant: {n_good} good triangulations < 100 of 200 planted")
            check(min(adds) >= 50, f"variant: fuse adds {adds}, expected >= 50 of 100 each")
            check(n_conf >= 1, "variant: fuse reported no conflict")
            check(kf0_erased >= 1, "variant: keyframe 0's planted outlier was not erased")
        print(f"phase 5 kernels vs plain pass ({name}): good/idx/rows/adds/conflicts/n_bad "
              f"equal, max |dR| {dR:.2e}, max |dt| {dt:.2e}; good triangulations {n_good} "
              f"({int(g.sum())} pairs), fuse adds per neighbour {adds}, conflicts {n_conf}, "
              f"n_bad {int(got_k['n_bad'])} (keyframe 0: {kf0_erased} erased), "
              f"LBA cost {cost0:.2f} -> {cost1:.2f}")

    # Amortized: tracked frames with a mapping pass every KF_EVERY-th.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(N_AMORTIZED):
        run(frames[i % N_FRAMES], *args[1:])
        if i % KF_EVERY == KF_EVERY - 1:
            mout = mrun(mstate)
    E.fetch_mapping(mout)
    amort_s = time.perf_counter() - t0
    print(f"phase 5 amortized: {N_AMORTIZED} frames of staged_pipeline with a mapping pass "
          f"every {KF_EVERY}th, {amort_s:.3f} s, {N_AMORTIZED / amort_s:.2f} frames/s")

    walls["phase 5"] = time.perf_counter()
    # --- Phase 6: the monocular System end to end -------------------------
    from orbslam3_tpu_torch.pipeline.tracking import Tracker

    torch.cuda.synchronize()
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    t0 = time.perf_counter()
    with _b1_calls([], keep_args=False) as replay_calls:
        rep = E.mono_replay(dev, N_REPLAY)
    replay_s = time.perf_counter() - t0
    launches6 = {"fast_nms": cuda_fast.LAUNCHES, "hamming_top2": cuda_match.LAUNCHES}
    per_site = {site: sum(c[0] == site for c in replay_calls) for site in B1_SITES.values()}
    check(sum(per_site.values()) == launches6["hamming_top2"],
          f"B1 calls by site {per_site} vs launches {launches6}")
    states = rep.states
    init = next((k for k, x in enumerate(states) if x == "OK"), None)
    check(init is not None and init < 10, f"no initialization in the first 10 frames: {states[:10]}")
    after = states[init:]
    n_ok = sum(x == "OK" for x in after)
    check("LOST" not in after, f"LOST after initialization: {states}")
    check(n_ok >= 0.95 * len(after), f"{n_ok} of {len(after)} frames OK after initialization")
    check(rep.n_kf >= 3 and rep.n_mp >= 500, f"{rep.n_kf} keyframes, {rep.n_mp} map points")
    check(rep.pos.shape == (len(rep.ts), 3) and np.isfinite(rep.pos).all(),
          "trajectory not finite or misshapen")
    check(rep.ate <= ATE_GATE, f"ATE {rep.ate} m above the gate {ATE_GATE} m")
    check(all(n == 1 for n in rep.b2), f"B2 launches per frame {rep.b2}")
    tracked = [k for k in range(init + 1, N_REPLAY) if states[k] == "OK"]
    check(all(rep.b1[k] >= 2 for k in tracked), f"B1 launches per frame {rep.b1}")
    plain = [k for k in tracked if not rep.keyframe[k]]
    kfs = [k for k in tracked if rep.keyframe[k]]
    sync_counts = sorted(set(rep.syncs[k] for k in plain))
    check(plain and sync_counts == [Tracker.HOST_SYNCS_PER_FRAME],
          f"host syncs per tracked non-keyframe frame {sync_counts}, documented "
          f"{Tracker.HOST_SYNCS_PER_FRAME}")
    ms_plain = statistics.median(rep.ms[k] for k in plain)
    ms_kf = statistics.median(rep.ms[k] for k in kfs) if kfs else float("nan")
    fps6 = N_REPLAY / (sum(rep.ms) / 1e3)
    print(f"phase 6 replay: {N_REPLAY} frames at 752x480, 1000 features; initialized at frame "
          f"{init} (the reference frame before it), {n_ok} of {len(after)} frames OK after it, "
          f"{rep.n_kf} keyframes, {rep.n_mp} map points; launches {launches6}")
    print(f"phase 6 ATE {rep.ate:.4f} m (Sim3, {len(rep.ts)} poses), gate {ATE_GATE:.4f} m")
    print(f"phase 6 time: median {ms_plain:.2f} ms per tracked non-keyframe frame "
          f"({len(plain)}), median {ms_kf:.2f} ms per keyframe frame with its mapping pass "
          f"({len(kfs)}), {fps6:.2f} frames/s over the replay ({replay_s:.1f} s wall with "
          f"{rep.render_s:.1f} s of rendering)")
    print(f"phase 6 host syncs per tracked non-keyframe frame: {sync_counts[0]} on all "
          f"{len(plain)} (keyframe frames: median "
          f"{statistics.median(rep.syncs[k] for k in kfs) if kfs else 0})")
    print(f"phase 6 B1 launches by call over the replay: {per_site} ({len(tracked)} tracked "
          f"frames after initialization, {len(kfs)} of them keyframes)")

    pre_k = E.mono_replay(dev, N_PREFIX)
    with _build.force_plain():
        pre_p = E.mono_replay(dev, N_PREFIX)
    print(f"phase 6 kernels vs plain prefix ({N_PREFIX} frames): "
          f"{_same_run(pre_k, pre_p, 'prefix', kf_slack=1)}")

    # B1 at the fuse-into-keyframe shape: 4096 candidates into the newest
    # keyframe of the replay's map, windowed as `fuse_into_kf` windows them.
    sysm = rep.system
    ms_state = sysm.store.state
    kf = sysm.tracker.last_kf_id
    cand = torch.nonzero(ms_state.mp_valid)[:4096, 0]
    lane_ok = torch.arange(4096, device=dev) < cand.shape[0]  # padding lanes are invalid
    cand = torch.cat([cand, cand.new_zeros(4096 - cand.shape[0])])
    Rk, tk = ms_state.kf_R[kf], ms_state.kf_t[kf]
    uv_c, vis_c, lvl_c, _ = fr.frustum_and_scale(
        sysm.tracker.model, sysm.tracker.params, Rk, tk, ms_state.mp_pos[cand],
        lane_ok & ms_state.mp_valid[cand], ms_state.mp_normal[cand], ms_state.mp_min_dist[cand],
        ms_state.mp_max_dist[cand], sysm.tracker.img_wh_t)
    win_k = cuda_match.MatchWindow(uv_c, ms_state.kf_uv[kf], 3.0 * 1.2 ** lvl_c.float(),
                                   ms_state.kf_octave[kf], torch.clamp(lvl_c - 1, min=0), lvl_c)

    def b1_pool():
        return cuda_match.hamming_top2(ms_state.mp_desc[cand], ms_state.kf_desc[kf],
                                       ms_state.kf_feat_valid[kf], win_k)

    out_k = b1_pool()
    with _build.force_plain():
        out_p = b1_pool()
    torch.cuda.synchronize()
    for name, k_, p_ in zip(("d1", "d2", "j1"), out_k, out_p):
        check(torch.equal(k_, p_), f"B1 pool-shape {name} differs from plain")
    err_b1 = max(err_b1, float((out_k[0] - out_p[0]).abs().max()),
                 float((out_k[1] - out_p[1]).abs().max()))
    print(f"phase 6 B1 fuse-into-keyframe shape {cand.shape[0]}x{ms_state.kf_desc.shape[1]} "
          f"windowed: exact (tolerance 0) vs plain, {int(vis_c.sum())} candidates visible, "
          f"{int((out_k[0] < 1e9).sum())} with a key in their window")
    b1_shapes["fuse into the keyframe"] = (ms_state.mp_desc[cand], ms_state.kf_desc[kf],
                                           ms_state.kf_feat_valid[kf], win_k)

    walls["phase 6"] = time.perf_counter()
    # --- Phase 7: device-only times, call times and bounds ------------------
    card = smi.stdout.strip().splitlines()[0]
    b2_t = KB.time_b2(atlas, orb.min_th, orb.ini_th)
    with _build.force_plain():
        b2_plain_ms = KB.call_us(lambda: cuda_fast.fast_score_nms(atlas, orb.min_th, orb.ini_th),
                                 iters=10) / 1e3
    b2_b = KB.b2_bound(atlas)
    print(f"phase 7 B2 fast_nms {tuple(atlas.shape)}: device {b2_t['device_us']:.2f} us "
          f"(graph of {KB.GRAPH_CALLS}), call {b2_t['call_us']:.2f} us, profiler "
          f"{b2_t['profiler_us']} us (kernel launches per call "
          f"{b2_t['profiler_launches_per_call']}), bound {b2_b['bound_us']:.2f} us ({b2_b['bound_by']}: "
          f"{b2_b['byte_us']:.2f} us for {b2_b['bytes']} bytes, {b2_b['op_us']:.2f} us for "
          f"{b2_b['ops']} fp32 ops), plain {b2_plain_ms:.4f} ms; 1 launch per frame [{card}]")
    b1_rows = []
    for site in B1_SITES.values():
        a = b1_shapes[site]
        got = cuda_match.hamming_top2(*a)
        with _build.force_plain():
            ref = cuda_match.hamming_top2(*a)
        torch.cuda.synchronize()
        for what, k_, p_ in zip(("d1", "d2", "j1"), got, ref):
            check(torch.equal(k_, p_), f"B1 {site}: {what} differs from plain")
        err_b1 = max(err_b1, float((got[0] - ref[0]).abs().max()),
                     float((got[1] - ref[1]).abs().max()))
        t = KB.time_b1(a)
        with _build.force_plain():
            plain_ms = KB.call_us(lambda: cuda_match.hamming_top2(*a), iters=10) / 1e3
        bd = KB.b1_bound(*a)
        fuse = site.startswith("fuse")
        per = per_site[site] / max(len(kfs) if fuse else len(tracked), 1)
        row = {"call": site, "shape": [a[0].shape[0], a[1].shape[0]], "windowed": a[3] is not None,
               **t, "plain_ms": plain_ms, "bound_us": bd["bound_us"], "bound_by": bd["bound_by"],
               "in_window_pairs": bd["pairs"], "launches_per_replay": per_site[site],
               ("launches_per_keyframe" if fuse else "launches_per_tracked_frame"): per}
        b1_rows.append(row)
        print(f"phase 7 B1 {site} {a[0].shape[0]}x{a[1].shape[0]} "
              f"{'windowed' if row['windowed'] else 'unwindowed'}: exact vs plain; device "
              f"{t['device_us']:.2f} us (graph of {KB.GRAPH_CALLS}), call {t['call_us']:.2f} us, "
              f"profiler {t['profiler_us']} us, bound {bd['bound_us']:.3f} us ({bd['bound_by']}; "
              f"{bd['bytes']} bytes, {bd['pairs']} pairs to popcount), plain {plain_ms:.4f} ms; "
              f"{per_site[site]} launches in the replay ({per:.2f} per "
              f"{'keyframe' if fuse else 'tracked frame'}) [{card}]")

    walls["phase 7"] = time.perf_counter()
    # --- Phase 8: B1 above one 1024-key tile; a 2000-feature System -------
    tile_cases = KB.b1_tile_cases()
    n_rows = 0
    for name, case in tile_cases:
        a = KB.b1_case_args(case, dev)
        got = cuda_match.hamming_top2(*a)
        ref = cuda_match.hamming_top2_plain(*a)
        torch.cuda.synchronize()
        for what, k_, p_ in zip(("d1", "d2", "j1"), got, ref):
            check(torch.equal(k_, p_), f"B1 tile case {name}: {what} differs from plain")
        if name.startswith("tile_tie"):  # key 1029 ties key 5 at distance 0
            check(int(got[2][0]) == 5 and float(got[0][0]) == 0.0,
                  f"B1 {name}: query 0 has j1 {int(got[2][0])} at {float(got[0][0])}, expected 5")
        err_b1 = max(err_b1, float((got[0] - ref[0]).abs().max()),
                     float((got[1] - ref[1]).abs().max()))
        n_rows += a[0].shape[0]
    print(f"phase 8 B1 above one 1024-key tile: {len(tile_cases)} cases (1025, 2000 and 4097 "
          f"keys at 16384 and 1024 windowed and 1024 unwindowed queries; 2048 keys tied across "
          f"the tile edge, query 0 at j1 = 5 where key 1029 ties), {n_rows} rows, d1/d2/j1 "
          f"exact (tolerance 0) vs plain")

    wide = feat.OrbParams(n_features=N_WIDE_FEATURES)
    torch.cuda.synchronize()
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    with _b1_calls([], keep_args=False) as wide_calls:
        wide_k = E.mono_replay(dev, N_WIDE, orb=wide)
    launches8 = {"fast_nms": cuda_fast.LAUNCHES, "hamming_top2": cuda_match.LAUNCHES}
    with _build.force_plain():
        wide_p = E.mono_replay(dev, N_WIDE, orb=wide)
    keys = [m for _, _, m in wide_calls]
    check(launches8["fast_nms"] == N_WIDE and launches8["hamming_top2"] == len(keys) > 0,
          f"2000-feature replay launches {launches8}, {len(keys)} B1 calls")
    check(max(keys) > 1024, f"2000-feature replay: B1 saw at most {max(keys)} keys")
    check(wide_k.states[-1] == "OK", f"2000-feature replay states {wide_k.states}")
    same = _same_run(wide_k, wide_p, f"{N_WIDE_FEATURES}-feature replay", kf_slack=0)
    print(f"phase 8 System at {N_WIDE_FEATURES} features: {N_WIDE} frames, {wide_k.n_kf} "
          f"keyframes, {wide_k.n_mp} map points, launches {launches8} (B1 keys per call "
          f"{min(keys)}-{max(keys)}); kernels vs plain: {same}")

    walls["phase 8"] = time.perf_counter()
    # --- Phase 9: the vocabulary and the keyframe database on the card ------
    p9 = phase9_vocabulary(dev, sysm)
    err_b1 = max(err_b1, p9["err"])

    walls["phase 9"] = time.perf_counter()
    # --- Phase 10: loop closing and relocalization at full width ----------
    p10 = phase10_loop_lap(dev)
    for site, a in p10["args"].items():  # B1 at place recognition's calls
        got = cuda_match.hamming_top2(*a)
        with _build.force_plain():
            ref = cuda_match.hamming_top2(*a)
        torch.cuda.synchronize()
        for what, k_, p_ in zip(("d1", "d2", "j1"), got, ref):
            check(torch.equal(k_, p_), f"B1 {site}: {what} differs from plain")
        err_b1 = max(err_b1, float((got[0] - ref[0]).abs().max()),
                     float((got[1] - ref[1]).abs().max()))
        t = KB.time_b1(a)
        with _build.force_plain():
            plain_ms = KB.call_us(lambda: cuda_match.hamming_top2(*a), iters=10) / 1e3
        bd = KB.b1_bound(*a)
        n10 = p10["sites"][site]
        b1_rows.append({"call": site, "shape": [a[0].shape[0], a[1].shape[0]],
                        "windowed": a[3] is not None, **t, "plain_ms": plain_ms,
                        "bound_us": bd["bound_us"], "bound_by": bd["bound_by"],
                        "in_window_pairs": bd["pairs"], "launches_per_replay": n10,
                        "replay": "phase 10"})
        b1_shapes[site] = a
        print(f"phase 10 B1 {site} {a[0].shape[0]}x{a[1].shape[0]} "
              f"{'windowed' if a[3] is not None else 'unwindowed'}: exact vs plain; device "
              f"{t['device_us']:.2f} us (graph of {KB.GRAPH_CALLS}), call {t['call_us']:.2f} us, "
              f"profiler {t['profiler_us']} us, bound {bd['bound_us']:.3f} us ({bd['bound_by']}; "
              f"{bd['bytes']} bytes, {bd['pairs']} pairs to popcount), plain {plain_ms:.4f} ms; "
              f"{n10} launches in the phase-10 replay [{card}]")
    walls["phase 10"] = time.perf_counter()
    # --- Phase 11: the stereo System; phase 12: RGB-D and raw stereo ------
    p11 = phase11_stereo(dev)
    right = p11["right"]
    b2_rows = [{"call": "left atlas (phase 7)", "shape": list(atlas.shape), **b2_t,
                "plain_ms": b2_plain_ms, "bound_us": b2_b["bound_us"], "bound_by": b2_b["bound_by"],
                "launches_per_stereo_frame": 1,
                "launches_per_replay": p11["launches"]["fast_nms"] // 2}]
    t = KB.time_b2(right, orb.min_th, orb.ini_th)
    with _build.force_plain():
        plain_ms = KB.call_us(lambda: cuda_fast.fast_score_nms(right, orb.min_th, orb.ini_th),
                              iters=10) / 1e3
    bd = KB.b2_bound(right)
    b2_rows.append({"call": "right atlas (phase 11)", "shape": list(right.shape), **t,
                    "plain_ms": plain_ms, "bound_us": bd["bound_us"], "bound_by": bd["bound_by"],
                    "launches_per_stereo_frame": 1,
                    "launches_per_replay": p11["launches"]["fast_nms"] // 2})
    print(f"phase 11 B2 right atlas {tuple(right.shape)}: device {t['device_us']:.2f} us (graph of "
          f"{KB.GRAPH_CALLS}), call {t['call_us']:.2f} us, profiler {t['profiler_us']} us, bound "
          f"{bd['bound_us']:.2f} us ({bd['bound_by']}), plain {plain_ms:.4f} ms; 1 launch per "
          f"stereo frame, {p11['launches']['fast_nms'] // 2} in the replay (left atlas: "
          f"{b2_t['device_us']:.2f} us in phase 7) [{card}]")
    n_tracked = sum(k in ("tracked", "keyframe") for k in p11["rep"].frame_kinds())
    n_kf11 = sum(p11["rep"].keyframe)
    for site, a in p11["args"].items():  # B1 at the stereo replay's calls
        got = cuda_match.hamming_top2(*a)
        with _build.force_plain():
            ref = cuda_match.hamming_top2(*a)
        torch.cuda.synchronize()
        for what, k_, p_ in zip(("d1", "d2", "j1"), got, ref):
            check(torch.equal(k_, p_), f"B1 {site} (phase 11): {what} differs from plain")
        err_b1 = max(err_b1, float((got[0] - ref[0]).abs().max()),
                     float((got[1] - ref[1]).abs().max()))
        t = KB.time_b1(a)
        with _build.force_plain():
            plain_ms = KB.call_us(lambda: cuda_match.hamming_top2(*a), iters=10) / 1e3
        bd = KB.b1_bound(*a)
        n11 = p11["sites"][site]
        fuse = site.startswith("fuse")
        per = n11 / max(n_kf11 if fuse else n_tracked, 1)
        b1_rows.append({"call": site, "shape": [a[0].shape[0], a[1].shape[0]],
                        "windowed": a[3] is not None, **t, "plain_ms": plain_ms,
                        "bound_us": bd["bound_us"], "bound_by": bd["bound_by"],
                        "in_window_pairs": bd["pairs"], "launches_per_replay": n11,
                        "replay": "phase 11",
                        ("launches_per_keyframe" if fuse else "launches_per_tracked_frame"): per})
        print(f"phase 11 B1 {site} {a[0].shape[0]}x{a[1].shape[0]} "
              f"{'windowed' if a[3] is not None else 'unwindowed'}: exact vs plain; device "
              f"{t['device_us']:.2f} us, call {t['call_us']:.2f} us, bound {bd['bound_us']:.3f} us "
              f"({bd['bound_by']}), plain {plain_ms:.4f} ms; {n11} launches in the stereo replay "
              f"({per:.2f} per "
              f"{'keyframe' if fuse else 'tracked frame'}) [{card}]")
    p12 = phase12_rgbd_raw(dev)
    walls["phases 11-12"] = time.perf_counter()
    # --- Phase 13: the mono-inertial System --------------------------------
    p13 = phase13_mono_inertial(dev)
    walls["phase 13"] = time.perf_counter()
    # --- Phase 14: config 4, the stereo-inertial fisheye rig ---------------
    p14 = phase14_stereo_fisheye_inertial(dev)
    right = p14["right"]
    t = KB.time_b2(right, orb.min_th, orb.ini_th)
    with _build.force_plain():
        plain_ms = KB.call_us(lambda: cuda_fast.fast_score_nms(right, orb.min_th, orb.ini_th),
                              iters=10) / 1e3
    bd = KB.b2_bound(right)
    b2_rows.append({"call": "fisheye right atlas (phase 14)", "shape": list(right.shape), **t,
                    "plain_ms": plain_ms, "bound_us": bd["bound_us"], "bound_by": bd["bound_by"],
                    "launches_per_rig_frame": 2,
                    "launches_per_replay": p14["launches"]["fast_nms"]})
    print(f"phase 14 B2 fisheye right atlas {tuple(right.shape)}: device {t['device_us']:.2f} us "
          f"(graph of {KB.GRAPH_CALLS}), call {t['call_us']:.2f} us, profiler "
          f"{t['profiler_us']} us, bound {bd['bound_us']:.2f} us ({bd['bound_by']}), plain "
          f"{plain_ms:.4f} ms; 2 launches per rig frame (left and right), "
          f"{p14['launches']['fast_nms']} in the replay [{card}]")
    a = p14["args"]
    got = cuda_match.hamming_top2(*a)
    with _build.force_plain():
        ref = cuda_match.hamming_top2(*a)
    torch.cuda.synchronize()
    for what, k_, p_ in zip(("d1", "d2", "j1"), got, ref):
        check(torch.equal(k_, p_), f"B1 fisheye match (phase 14): {what} differs from plain")
    err_b1 = max(err_b1, float((got[0] - ref[0]).abs().max()),
                 float((got[1] - ref[1]).abs().max()))
    t = KB.time_b1(a)
    with _build.force_plain():
        plain_ms = KB.call_us(lambda: cuda_match.hamming_top2(*a), iters=10) / 1e3
    bd = KB.b1_bound(*a)
    n14 = p14["sites"]["fisheye match"]
    b1_rows.append({"call": "fisheye match", "shape": [a[0].shape[0], a[1].shape[0]],
                    "windowed": a[3] is not None, **t, "plain_ms": plain_ms,
                    "bound_us": bd["bound_us"], "bound_by": bd["bound_by"],
                    "in_window_pairs": bd["pairs"], "launches_per_replay": n14,
                    "replay": "phase 14", "launches_per_rig_frame": n14 / N_FE})
    print(f"phase 14 B1 fisheye match {a[0].shape[0]}x{a[1].shape[0]} "
          f"{'windowed' if a[3] is not None else 'unwindowed'}: exact vs plain; device "
          f"{t['device_us']:.2f} us (graph of {KB.GRAPH_CALLS}), call {t['call_us']:.2f} us, "
          f"profiler {t['profiler_us']} us, bound {bd['bound_us']:.3f} us ({bd['bound_by']}; "
          f"{bd['bytes']} bytes, {bd['pairs']} pairs to popcount), plain {plain_ms:.4f} ms; {n14} "
          f"launches in the phase-14 replay (2 per rig frame: forward and the cross-check) "
          f"[{card}]")
    for site in ("motion model", "local map", "fuse into a neighbour", "fuse into the keyframe",
                 "cross-check"):
        print(f"phase 14 B1 {site}: {p14['sites'][site]} launches in the phase-14 replay")
    walls["phase 14"] = time.perf_counter()

    if opts.save_inputs:
        per_replay = {**per_site, **p10["sites"]}
        torch.save({"b2": {"atlas": atlas.cpu(), "min_th": orb.min_th, "ini_th": orb.ini_th},
                    "b1": [KB.b1_record(site, a, per_replay.get(site))
                           for site, a in b1_shapes.items()]},
                   opts.save_inputs)

    for k in launches:
        launches[k] += sum(run[k] for run in (launches5, launches6, launches8, p10["launches"],
                                              p11["launches"], p12["rgbd"], p12["raw"],
                                              p13["launches"], p14["launches"]))
    lm = next(r for r in b1_rows if r["call"] == "local map")  # the kernel's headline call
    record = {"kernels": [
        {"name": "fast_nms", "route": "cuda", "source": "orbslam3_tpu_torch/csrc/fast_nms.cu",
         "replaces": "orbslam3_tpu/ops/pallas_fast.py:141", "launches": launches["fast_nms"],
         "max_abs_err": err_b2, "ms": b2_t["device_us"] / 1e3, "plain_ms": b2_plain_ms,
         "bound_ms": b2_b["bound_us"] / 1e3, "bound_by": b2_b["bound_by"], "library_ms": None,
         "device_us": b2_t["device_us"], "call_us": b2_t["call_us"],
         "bound_us": b2_b["bound_us"], "launches_per_replay": launches6["fast_nms"],
         "calls": b2_rows},
        {"name": "hamming_top2", "route": "cuda",
         "source": "orbslam3_tpu_torch/csrc/hamming_top2.cu",
         "replaces": "orbslam3_tpu/ops/pallas_match.py:155",
         "launches": launches["hamming_top2"], "max_abs_err": err_b1,
         "ms": lm["device_us"] / 1e3, "plain_ms": lm["plain_ms"],
         "bound_ms": lm["bound_us"] / 1e3, "bound_by": lm["bound_by"], "library_ms": None,
         "device_us": lm["device_us"], "call_us": lm["call_us"], "bound_us": lm["bound_us"],
         "launches_per_replay": launches6["hamming_top2"], "calls": b1_rows},
    ]}
    names = list(walls)
    print("wall per phase (s): " + ", ".join(
        f"{b} {walls[b] - walls[a]:.1f}" for a, b in zip(names, names[1:]))
        + f"; whole script {time.perf_counter() - walls['start']:.1f}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
