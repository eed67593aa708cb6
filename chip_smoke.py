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
"mono_vi", N_VI, n_track=N_VI_TRACK)`, IMU_MONOCULAR at full width with the
synthetic sequence's 200 Hz IMU) just past the IMU initialization and VIBA1
(phases 19b and 20 carry config 3 further): the IMU
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
timed.

Phase 15 drives config 1 with place recognition and the Atlas
(`entry.replay(cuda, "mono", 360, vocabulary=..., t_loop=16, multimap=True,
blind=(80, 110))`: the synthetic sequence's lap shortened to 16 s, the lens
covered for frames 80-189) at full width: map 0 stored within 2 frames of
the JAX `System`'s frame (185) and 2 maps after it, a merge within 2
keyframes of JAX's (the merged map's keyframe count) and 1 map after it,
the post-merge GBA finished, the Sim3 ATE over the frames that are not
blind within max(2 x JAX's, 0.01 m), 2 host syncs per tracked frame; at
the merging keyframe `_merge_sim3` and then `merge_maps` with the weld fuse
re-run on copies of the two maps through the kernels and through the plain
versions (the same matches and outcome, Sim3 within 1e-4, the same `kf_mp`
rows, floats within 1e-4); `save_atlas`, then `load_atlas` into a fresh
`System` on the card (every array equal bit for bit) and map 0's images
relocalized into it within 5 frames. It prints the median ms per frame kind
(tracked, keyframe, blind, the merging frame), `_try_merge`'s ms per
keyframe, `_do_merge`'s split, the atlas's save and load ms, and B1 at its
two new calls (the merge's verification match, the weld fuse) exact and
timed.

Phase 16 writes phase 10's 8 s lap without the kidnap (260 frames, with its
ground truth and IMU stream) to a EuRoC directory with the port's own PNG
writer and gates its digest (decoded pixels and CSV text) equal to the
CPU's, then runs the runner at its defaults (`run_sequence.main`: async
mapping, Kmax 512, Pmax 65536, the 97k-word vocabulary, place recognition
and the Atlas) in this process, and `python -m
orbslam3_tpu_torch.run_sequence ... --sync-mapping --max-frames 200` (its
first SYNC16_FRAMES frames) as a subprocess. Each
run: every frame OK from the map's initialization on, a loop closed within
30 frames of the JAX runner's on the same files, the closure lowering the
ATE, a GBA finished on the matrix-free PCG path, the mapper idle after
shutdown, the Sim3 ATE under max(2 x the JAX runner's, 0.01 m), the TUM
files written and read back; it prints frames/s, the median, p95 and max
ms per frame, syncs and ms per frame kind, the GBA's chunk ms and each
mapping stage's ms (`mapping/*` spans). In the async run the local-map
match of one frame runs again through the kernels and through the plain
versions (equal), and B1 at its 65536-key call is held exact and timed.
Phase 17 writes config 3's first 60 frames to disk and serves them to an
IMU_MONOCULAR `System` on the card (async mapping, the viewer on) over a
UNIX socket from a thread, with `serve_stream.replay` as the client: every
frame answered, the states and poses equal (within 1e-4) to the same
System driven directly by `track_monocular` after the serve, the viewer's
`/state.json` during and after the serve (its counts the System's),
`/frame.png` and `/map.png` decoded by `io/png.py`, and no tensor read by
any thread but the serving one; it prints the IMU initialization's frame,
the ms per frame and of `viewer.update` and the syncs it adds.

Phase 18 is BASELINE config 5 on two ranks of the card (both on cuda:0
over gloo, which stages CUDA tensors through the host; NCCL takes one rank
a card), spawned by `orbslam3_tpu_torch.parallel.launch` with a 300 s
timeout on every collective. 18a runs `entry.dryrun_multichip(2)`: the
sharded BA at the production GBA shape (128 keyframes, 16384 points, 512
observations each, 3 LM iterations) in both layouts, each held against the
one-device solve on the card (poses within 2e-3, the points seen from 4 or
more keyframes within 5e-3, under 2% of the inliers flipped, the cost within
5%), the ranks equal, a point-sharded rank's peak memory below one device's;
it prints ms per LM iteration, the collectives per solve with their bytes
and ms, and the peaks. 18b replays phase 15's multi-map lap as two SPMD
replicas with `System.enable_distributed()` (each rank reads the frames
phase 15 rendered, written once to a temporary file by `entry.save_frames`)
against phase 15's one-device result: map 0 stored within 2
frames, as many merges and the first within 2 keyframes, every GBA chunk
over the group, every merge query sharded, |ATE - phase 15's| < 5e-3 m and
the ATE under phase 15's gate, both ranks' map digests equal at every GBA
start and at the end, the ranks' replays equal, 2 host syncs and no
collective per tracked frame; it prints per frame kind (GBA-chunk and
merge-query frames among them) the syncs the sync-debug mode sees, the
collectives (each a host wait it does not see) with their ms, and both
summed, then the GBA chunk ms against phase 15's, each rank's B1 and B2
launches and collectives.

Phase 19 runs the runner's other sensor modes from files on disk. 19a
writes, with the port's own writers (`entry.write_euroc_sequence`), EuRoC
stereo (config 2, 30 frames), the TUM-VI stereo-inertial fisheye pair
(config 4, 60 frames, past its IMU initialization near frame 45), TUM RGB-D (20
frames, the ray-cast depth as 16-bit PNGs at DepthMapFactor 5000) and KITTI
mono (config 1's frames, 20), and runs each through `run_sequence.main(...,
"--sync-mapping", "--no-loop", "--kmax", "256", "--pmax", "16384")` in this
process and through a direct drive of `entry.make_system(cuda, sensor)` on
the same decoded files (`entry.drive_files`): every frame's state, keyframe
count, IMU stages and pose equal bit for bit, the trajectory files equal
byte for byte, every frame OK after the map's initialization, the host syncs
of the tracked frames at the documented counts (2 mono; 3 stereo, RGB-D or
the rig; 5 on the rig after the IMU initialization), B2 once a frame (twice
for a pair), and at one frame of each the local-map match run again through
the kernels and through the plain versions, equal. 19b writes config 3's
first N19B frames with their IMU stream (the digest the CPU's) and runs them
through `run_sequence.main(..., "--mode", "mono-vi")` at the runner's
defaults (asynchronous mapping, place recognition with the 97k-word
vocabulary, the Atlas; Kmax 256, Pmax 16384) past VIBA2 and the first scale
refinement, against the JAX runner at the same flags on the same files
(`tests/jax_runner_lap.py --mode mono-vi ... --c13`): the IMU initialized,
VIBA1, VIBA2 and the first refinement applied each within 2 keyframes of
JAX's, every frame OK after the map's initialization, the pose-inertial
result on >= 80% of the frames after the IMU initialization, SE3 and Sim3
ATE under max(2 x JAX's, 0.01 m), the Sim3 scale within max(2 x |1 - JAX's|,
0.02) of 1, the first refinement's inputs copied to the CPU and solved again
there within 1e-4 in scale and gravity rotation, 2 syncs a tracked frame
before the IMU initialization and 4 after. 19c writes config 4's first N19C
frames (the KB8 pair, TUM-VI layout) and runs them through the runner at its
defaults with `--dataset tumvi --mode stereo-vi` against the JAX runner's
run: the IMU initialized within 2 keyframes of JAX's, VIBA1 run, every frame
OK, SE3 ATE under max(2 x JAX's, 0.01 m), 3 syncs a tracked frame before the
IMU initialization and 5 after. Both run their first frames again through
the plain versions of B1 and B2 (`--max-frames`, to PREFIX19 frames past the
IMU initialization's tick): states, keyframes, IMU stages and the
pose-inertial choice equal, poses within 1e-4. Both print the syncs and ms
per frame kind (each frame whose tick completed an IMU stage its own kind),
the syncs of each mapping stage, the median, p95 and maximum frame ms (19b
beside its synchronous run's), and fault C20's numbers: the IMU
prediction's distance from the tracked camera centre on the frame after
each IMU stage's tick, beside the median of the other frames after the
initialization and the JAX runner's; a stage above C20_FACTOR x that median
and C20_FLOOR fails the phase. With the card's name and power limit.

Phase 20 runs the inertial Atlas: config 3 (IMU_MONOCULAR, 200 Hz IMU) with
place recognition and the Atlas on phase 15's 16 s lap, its lens covered for
frames 100-209 (`entry.replay(cuda, "mono_vi", MMVI_FRAMES, vocabulary=...,
t_loop=16, multimap=True, blind=MMVI_BLIND, n_track=MMVI_TRACK)`), against
the JAX `System` on the same lap (`tests/jax_multimap_lap.py --mode mono-vi
--track MMVI_TRACK`): map 0's IMU initialization within 2 keyframes of
JAX's and map 0 stored within 2 frames of JAX's frame; map 1's IMU
initialization within 2 keyframes of JAX's; a
merge within 2 keyframes of JAX's (the active map's count) with `imu_metric`
true, s in (0.9, 1.1) and the gated rotation yaw only (the x and y of its log
below 1e-6), the weld through `_local_inertial_ba` over 16 keyframes and the
graph 4-DoF; the post-merge GBA finished; every frame OK from map 1's
initialization apart from the blind frames and those JAX also loses; the
pose-inertial result on >= 80% of the frames after each map's IMU
initialization; SE3 and Sim3 ATE over the frames that are not blind under
max(2 x JAX's, 0.01 m) and the Sim3 scale within max(2 x |1 - JAX's|, 0.02)
of 1; 2 host syncs per tracked frame before a map's IMU initialization and
4 after. At the merging keyframe `_merge_sim3`, `merge_maps`, the weld fuse,
the inertial weld BA and the 4-DoF graph run again on copies of the two maps
and their preintegrations, through the kernels and through the plain
versions (the same matches and outcome; poses, velocities, biases and points
within 1e-4; exact on the card), then from the same inputs copied to the
CPU at its threads and at one thread: the Sim3, poses, velocities and
biases within 1e-4 of the card's, the points within max(1e-4, 2 x the two
CPU runs' distance) (fault C19: no float32 solve of the weld holds its
points to 1e-4); a prefix from the map's initialization through
MMVI_PREFIX frames after it is equal through the kernels and the plain
versions. It prints the IMU prediction's distance from the tracked pose on
the frame after the merge and the largest elsewhere (fault C20), ms and
syncs per
frame kind (blind, RECENTLY_LOST and LOST frames their own kinds), the
merging frame's split by span with host clock and CUDA events, B1's
launches per site and B2's, and its essential graph's largest keyframe
rotation change and gravity-axis change, with the card's name and power
limit.

Phase 21 runs config 3 through the runner at its defaults (asynchronous
mapping, place recognition with the 97k-word vocabulary, the Atlas; Kmax
256, Pmax 16384) on phase 10's 8 s lap (N21 frames; the sequence phase 16
writes, with its IMU, the digest the CPU's), on which an inertial loop
closes, against the JAX runner at the same flags on the same files
(`tests/jax_runner_lap.py --mode mono-vi --t-loop 8 --frames 260 ... --c13`,
JAX_VI_LAP; its 4-DoF graph unrepaired, so the gates are outcomes): the IMU
initialized and VIBA1 each within 2 keyframes of JAX's; a loop closed with
a keyframe count within 2 of JAX's, every Sim3 scale exactly 1; per 4-DoF
graph every corrected keyframe's R z within GRAVITY_TOL of its old one and
the loop edge's rotation residual (the angle of M^-1 S_j S_i^-1), where it
was above YAW_RESIDUAL_MIN, at least halved (fault C22); a GBA finished
after the loop; every frame OK after the map's initialization; the
pose-inertial result on >= 80% of the frames after the IMU initialization
and of those after the loop's tick; SE3 ATE under max(2 x JAX's, 0.01 m);
2 syncs a tracked frame before the IMU initialization and 4 after; fault
C20: no frame after an IMU stage's, the loop's or a GBA's finishing tick
above C20_FACTOR x the other frames' median and C20_FLOOR (printed beside
the JAX runner's and the parent checkout's). At the closing pair
`_verify_sim3` runs again through the kernels and the plain versions
(exact), and the first correction (graph, points, velocities,
SearchAndFuse) again from its inputs copied to the CPU at its threads and
at one: `kf_mp` equal, poses and velocities within 1e-4, points within
max(1e-4, 2 x the two CPU runs' distance) (C19). The frames through the IMU
initialization's tick and PREFIX19 after it run again through the plain
versions (`--max-frames`), equal. It prints the ms and syncs per frame kind
(the loop's tick, the GBA chunks and finish their own), `_verify_sim3`, the
graph, the point correction, SearchAndFuse and each GBA chunk by `spans`
(CUDA events and host clock), B1's launches by site and B2's, with the
card's name and power limit.

Every run prints how many CUDA graphs the pose solves captured and
replayed (`optim.graphed`), and the wall time of each phase and of the
whole script.

Every phase prints its lines; any failure ends the run with a non-zero
exit. Without a CUDA device it exits non-zero and prints no result.

    python3 chip_smoke.py --save-inputs FILE

also writes the kernels' inputs of phases 7 and 10 to FILE, for `python -m
orbslam3_tpu_torch.kernel_bench FILE` to time another checkout's kernels on
the same inputs.

    python3 chip_smoke.py --only 15

builds the kernels and runs phase 15 alone (its record holds B1's rows of
that phase only); `--only 16`, `--only 17` and `--only 19` do the same for
those, `--only 20` and `--only 21` for phases 20 and 21, and `--only 18` runs
phase 15 (18b's one-device side), then phase 18.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
# The Atlas's B1 calls (phase 15), named before all others.
B1_MM_SITES = {"_merge_sim3": "merge verify match", "_weld_fuse": "weld fuse"}
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
# (`python tests/jax_vi_replay.py --frames 160 --track 112 --c13`, 554 s): the
# IMU initialized at frame 44 with 10 keyframes, VIBA1 at frame 104 (5.2 s),
# every frame OK after the map's initialization (frame 3), 16 keyframes and
# 1302 points at the end, SE3 ATE 0.020243 m, Sim3 ATE 0.020158 m, Sim3 scale
# 1.004185 over 110 poses. Unrepaired, it loses track on the frame after each
# IMU initialization and never reaches VIBA1. The sequence is N_VI = 160
# frames (8 s; its IMU noise is drawn after all its images, so the length
# fixes it); the first N_VI_TRACK are tracked, just past VIBA1: phases 19b and
# 20 carry config 3 further.
N_VI = 160
N_VI_TRACK = 112
JAX_VI_INIT_FRAME = 44
JAX_VI_INIT_KFS = 10
JAX_VI_VIBA1_FRAME = 104
JAX_VI_ATE_SE3 = 0.020243
JAX_VI_ATE_SIM3 = 0.020158
JAX_VI_SCALE = 1.004185
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

# Phase 15: the multi-map lap (config 1 with the Atlas). The JAX `System` on
# the same frames on a CPU (`python tests/jax_multimap_lap.py --t-loop 16
# --frames 360 --blind-at 80 --blind-n 110`, 1307 s on 8 CPU cores):
# initialized at frame 24, 18 keyframes when the lens is covered at frame 80;
# RECENTLY_LOST for 5 s, LOST from frame 181, map 0 stored at frame 185 (18
# keyframes); map 1 initialized at frame 191 on a part of the room map 0 never
# saw; merged into map 0 at frame 304 (keyframe 31 of the 36-keyframe map 1
# onto keyframe 1, s 0.99608), 54 keyframes after it, every frame OK from
# frame 191, the post-merge GBA finished, 63 keyframes at the end, no loop
# closed; Sim3 ATE 0.041078 m over the 227 poses of the 250 frames that are
# not blind.
MM_T_LOOP = 16.0
MM_FRAMES = 360
MM_BLIND = (80, 110)  # frames 80-189: a uniform grey 35 image
JAX_MM_STORED = (185, 18)  # frame, keyframes of the stored map
JAX_MM_MERGE = (304, 36, 31, 1)  # frame, keyframes of the active map, the keyframe pair
JAX_MM_ATE = 0.041078
MM_ATE_GATE = max(2 * JAX_MM_ATE, 0.01)
MM_RELOC_FRAMES = (40, 50)  # map 0's images fed to the loaded atlas

@contextlib.contextmanager
def _b1_calls(calls: list, keep_args):
    """Within the block, append (call site, arguments or None, key count, the
    frame of the active span recorder or None) for every B1 wrapper call.
    `keep_args`: True keeps every call's arguments, a set of sites the first
    call's of each. A call made while
    `COMPARING` is set is named "comparison" (kernels against plain, not the
    main path). The wrapper itself runs unchanged, launch count included."""
    from orbslam3_tpu_torch import spans
    from orbslam3_tpu_torch.ops import _build, cuda_match

    wrapped = cuda_match.hamming_top2

    def recording(*args):
        if not _build.use_kernel(args[0]):  # a plain run launches nothing
            return wrapped(*args)
        names, f = [], sys._getframe(1)
        while f is not None:
            names.append(f.f_code.co_name)
            f = f.f_back
        site = next((B1_MM_SITES[n] for n in names if n in B1_MM_SITES), None) or next(
            (B1_PR_SITES[n] for n in names if n in B1_PR_SITES), None) or next(
            (B1_SITES[n] for n in names if n in B1_SITES), None) or next(
            (B1_RIG_SITES[n] for n in names if n in B1_RIG_SITES), "other")
        if COMPARING[0]:
            site = "comparison"
        keep = keep_args is True or (keep_args and site in keep_args
                                     and not any(c[0] == site for c in calls))
        full = args + (None,) * (4 - len(args))  # (desc_a, desc_b, valid_b, window)
        calls.append((site, tuple(_clone(a) for a in full) if keep else None,
                      args[1].shape[0], None if spans._active is None else spans._active.frame))
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
            rep = E.replay(dev, "mono_vi", N_VI, on_frame=_vi_recorder(rec_k),
                           n_track=N_VI_TRACK)
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
    after = [k for k in range(rep.imu_init_frame + 1, N_VI_TRACK) if states[k] == "OK"]
    share = sum(rep.pi_taken[k] for k in after) / max(len(after), 1)
    check(after and share >= 0.8, f"phase 13: pose-inertial result taken on {share:.4f} of "
          f"{len(after)} tracked frames after the IMU initialization")
    check(all(n == 1 for n in rep.b2) and launches["fast_nms"] == N_VI_TRACK,
          f"phase 13: B2 launches per frame {sorted(set(rep.b2))}")
    by_kind = _inertial_by_kind(rep)
    for kind, want in (("tracked before IMU init", Tracker.HOST_SYNCS_PER_FRAME),
                       ("tracked after IMU init", Tracker.HOST_SYNCS_PER_INERTIAL_FRAME)):
        got = sorted(set(n for n, _ in by_kind.get(kind, [])))
        check(got == [want], f"phase 13: host syncs per {kind} frame {got}, documented {want}")
    med = statistics.median
    print(f"phase 13 mono-inertial: the first {N_VI_TRACK} of {N_VI} frames at 752x480, 1000 "
          f"features, 200 Hz IMU; "
          f"pose-inertial result taken on {share:.4f} of the {len(after)} tracked frames after "
          f"the IMU initialization ({sum(rep.pi_taken)} frames); SE3 ATE {rep.ate_se3:.6f} m "
          f"(gate {VI_ATE_SE3_GATE:.6f} m: 2 x the JAX System's {JAX_VI_ATE_SE3} m, or 0.01), "
          f"Sim3 ATE {rep.ate:.6f} m (gate {VI_ATE_SIM3_GATE:.6f} m), scale {rep.scale:.5f} "
          f"(tolerance {VI_SCALE_TOL:.4f}); {N_VI_TRACK / (sum(rep.ms) / 1e3):.2f} frames/s "
          f"({wall_s:.1f} s wall, {rep.render_s:.1f} s of rendering)")
    print("phase 13 host syncs and ms per frame kind: " + "; ".join(
        f"{kind} {len(v)} frames, syncs median {med([n for n, _ in v])} (max "
        f"{max(n for n, _ in v)}), ms median {med([m for _, m in v]):.2f}"
        for kind, v in sorted(by_kind.items())))
    calls = rep.inertial_ms
    for name, v in sorted(calls.items()):
        if name.startswith("count/"):  # a counter: (frame, n, None)
            continue
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
          f"B1 median {med(rep.b1)} (max {max(rep.b1)}) over {N_VI_TRACK} frames; B1 by call "
          f"{sites}")

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


def _clone_store(store):
    """A copy of a `MapStore` whose tensors and host bookkeeping are its own."""
    import copy

    from orbslam3_tpu_torch.atlas import store as st

    c = copy.copy(store)
    c.state = st.MapState(*(x.clone() for x in store.state))
    c.kf_ts, c.kf_frame_id = store.kf_ts.copy(), store.kf_frame_id.copy()
    c.free_mp_slots, c.free_kf_slots = list(store.free_mp_slots), list(store.free_kf_slots)
    c._mirrors = {}
    return c


def _same_store(a, b) -> bool:
    """Every array equal bit for bit, and the host bookkeeping equal."""
    return (all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a.state, b.state))
            and (a.n_kf, a.n_mp, a.change_index) == (b.n_kf, b.n_mp, b.change_index)
            and list(a.free_mp_slots) == list(b.free_mp_slots)
            and list(a.free_kf_slots) == list(b.free_kf_slots)
            and np.array_equal(a.kf_ts, b.kf_ts) and np.array_equal(a.kf_frame_id, b.kf_frame_id))


def phase15_multimap(dev) -> dict:
    """Phase 15: config 1 with place recognition and the Atlas
    (`entry.replay(cuda, "mono", MM_FRAMES, multimap=True, blind=MM_BLIND)`,
    the 16 s lap, its lens covered for MM_BLIND[1] frames): map 0 stored
    within 2 frames of the JAX `System`'s frame and 2 maps after it; a merge
    within 2 keyframes of JAX's (the active map's count) and 1 map after it;
    the post-merge GBA finished; the Sim3 ATE over the frames that are not
    blind within max(2 x JAX's, 0.01 m); 2 host syncs per tracked frame. At
    the merging keyframe `_merge_sim3` (B1 unwindowed, twice) and then
    `merge_maps` and the weld fuse (B1 windowed per Nf chunk) run again on
    copies of the two maps through the kernels and through the plain
    versions: the same matches and outcome, the Sim3 within 1e-4, the same
    `kf_mp` rows, poses and points within 1e-4. Then `save_atlas`, and
    `load_atlas` into a fresh `System` on the card: every array equal bit for
    bit, and map 0's images relocalize into the loaded map within 5 frames."""
    import tempfile

    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch.io.vocab_io import load_binary_vocabulary
    from orbslam3_tpu_torch.ops import _build, cuda_fast, cuda_match
    from orbslam3_tpu_torch.ops import cameras as cam
    from orbslam3_tpu_torch.pipeline import map_merging
    from orbslam3_tpu_torch.pipeline import multimap as mm_mod
    from orbslam3_tpu_torch.pipeline.tracking import Tracker, TrackState
    from orbslam3_tpu_torch.system import Sensor, System

    frame = [0]
    found, extra_ms, gba_at_merge = {}, {}, []
    orig_do_merge = mm_mod.MultiMapManager._do_merge

    def do_merge(self, act, target, R, t, s):
        if "merge" not in found:  # copies of both maps for the kernels-vs-plain re-run
            with _comparing() as took:
                found["merge"] = dict(act=_clone_store(act), tgt=_clone_store(target), R=R, t=t,
                                      s=s, verify=dict(self.last_verify), frame=frame[0],
                                      pre=target.state.mp_valid.cpu().numpy().copy())
            extra_ms[frame[0]] = extra_ms.get(frame[0], 0.0) + took[0]
        out = orig_do_merge(self, act, target, R, t, s)
        lc = self.system.loop_closer
        gba_at_merge.append(lc.gba_async.n_finished)
        return out

    def on_frame(k, slam):
        frame[0] = k + 1

    torch.cuda.synchronize()
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    t0 = time.perf_counter()
    mm_mod.MultiMapManager._do_merge = do_merge
    try:
        with _b1_calls([], keep_args=set(B1_MM_SITES.values())) as calls:
            rep = E.replay(dev, "mono", MM_FRAMES, vocabulary=VOC_100K, t_loop=MM_T_LOOP,
                           multimap=True, blind=MM_BLIND, on_frame=on_frame)
    finally:
        mm_mod.MultiMapManager._do_merge = orig_do_merge
    wall_s = time.perf_counter() - t0
    sites = {site: sum(c[0] == site for c in calls)
             for site in (list(B1_SITES.values()) + list(B1_PR_SITES.values())
                          + list(B1_MM_SITES.values()) + ["comparison", "other"])}
    launches = {"fast_nms": cuda_fast.LAUNCHES,
                "hamming_top2": cuda_match.LAUNCHES - sites["comparison"]}
    check(sum(sites.values()) == cuda_match.LAUNCHES and sites["other"] == 0,
          f"phase 15 B1 calls by site {sites}")
    sysm = rep.system
    mm = sysm.multimap

    print(f"phase 15 outcome: initialized at frame {rep.states.index('OK')}; stored "
          f"{rep.stored}; merges "
          f"{[{k: v for k, v in m.items() if k not in ('R', 't')} for m in rep.merges]}; "
          f"maps at the end {mm.atlas.n_maps}, {rep.n_kf} keyframes, {rep.n_mp} points, loops "
          f"{len(rep.loops)}; GBA {rep.gba_finished} finished, {rep.gba_aborted} aborted; ATE "
          f"{rep.ate:.6f} m over {len(rep.ts)} poses", flush=True)
    # Gates.
    check(len(rep.stored) >= 1, f"phase 15: no map stored: states {rep.states[70:200]}")
    st0 = rep.stored[0]
    check(abs(st0["frame"] - JAX_MM_STORED[0]) <= 2 and rep.n_maps[st0["frame"]] == 2,
          f"phase 15: map 0 stored at frame {st0['frame']} ({rep.n_maps[st0['frame']]} maps), "
          f"JAX {JAX_MM_STORED}")
    check(len(rep.merges) >= 1, f"phase 15: no merge: states {rep.states[185:]}")
    mg = rep.merges[0]
    check(abs(mg["n_kf_active"] - JAX_MM_MERGE[1]) <= 2 and rep.n_maps[mg["frame"]] == 1,
          f"phase 15: merge at frame {mg['frame']} with {mg['n_kf_active']} keyframes in the "
          f"active map, {rep.n_maps[mg['frame']]} maps after it; JAX {JAX_MM_MERGE}")
    check(rep.gba_finished > gba_at_merge[0],
          f"phase 15: the post-merge GBA did not finish ({rep.gba_finished} finished, "
          f"{gba_at_merge[0]} before the merge)")
    check(np.isfinite(rep.pos).all() and rep.ate <= MM_ATE_GATE,
          f"phase 15: ATE {rep.ate} m above the gate {MM_ATE_GATE} m")
    for site in B1_MM_SITES.values():
        check(sites[site] > 0, f"phase 15: B1 never launched at {site}: {sites}")

    kinds = rep.frame_kinds()
    blind = set(range(MM_BLIND[0], MM_BLIND[0] + MM_BLIND[1]))
    ms = [m - extra_ms.get(k, 0.0) for k, m in enumerate(rep.ms)]
    by_kind = {}
    for k, (kind, n_sync, m) in enumerate(zip(kinds, rep.syncs, ms)):
        kind = "blind" if k in blind else "merge" if k == mg["frame"] else kind
        by_kind.setdefault(kind, []).append((n_sync, m))
    tracked = [n for n, _ in by_kind.get("tracked", [])]
    check(tracked and set(tracked) == {Tracker.HOST_SYNCS_PER_FRAME},
          f"phase 15: host syncs per tracked frame {sorted(set(tracked))}")

    # Kernels against plain at the merging keyframe, on copies of the two maps.
    m0 = found["merge"]
    v0 = m0["verify"]
    runs = {}
    with _comparing():
        for mode in ("kernels", "plain"):
            with _build.force_plain() if mode == "plain" else contextlib.nullcontext():
                act, tgt = _clone_store(m0["act"]), _clone_store(m0["tgt"])
                S = mm._merge_sim3(act, tgt, v0["kf"], v0["cand"])
                v = dict(mm.last_verify)
                kf_remap, _ = map_merging.merge_maps(tgt, act, m0["R"], m0["t"], m0["s"])
                mm._weld_fuse(tgt, list(kf_remap.values()), m0["pre"])
            runs[mode] = (S, v, tgt)
    (S_k, v_k, t_k), (S_p, v_p, t_p) = runs["kernels"], runs["plain"]
    check(S_k is not None and S_p is not None, "phase 15: the merge did not verify again")
    same_m = (np.array_equal(v_k["valid"], v_p["valid"])
              and np.array_equal(v_k["idx"][v_k["valid"]], v_p["idx"][v_p["valid"]]))
    check(same_m and v_k["matches"] == v_p["matches"] == v0["matches"]
          and v_k["sim3_inliers"] == v_p["sim3_inliers"],
          f"phase 15 merge verify, kernels vs plain: {v_k['matches']} / {v_k['sim3_inliers']} vs "
          f"{v_p['matches']} / {v_p['sim3_inliers']} (the lap {v0['matches']})")
    dS = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(S_k, S_p))
    dS0 = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
              for a, b in zip(S_k, (m0["R"], m0["t"], m0["s"])))
    check(dS <= 1e-4 and dS0 <= 1e-4,
          f"phase 15 merge Sim3, kernels vs plain {dS}, vs the lap {dS0}")
    check(torch.equal(t_k.state.kf_mp, t_p.state.kf_mp),
          "phase 15 merge + weld fuse, kernels vs plain: kf_mp rows differ")
    dW = max(float((getattr(t_k.state, f) - getattr(t_p.state, f)).abs().max())
             for f in ("kf_R", "kf_t", "mp_pos", "mp_normal"))
    check(dW <= 1e-4, f"phase 15 merge + weld fuse, kernels vs plain: floats {dW}")

    # Save the Atlas, load it into a fresh System on the card, relocalize.
    voc = load_binary_vocabulary(VOC_100K, dev)
    cfg = E.EUROC_MONO
    with tempfile.TemporaryDirectory() as d, _comparing():
        t1 = time.perf_counter()
        sysm.save_atlas(d)
        save_ms = (time.perf_counter() - t1) * 1e3
        fresh = System(Sensor.MONOCULAR, cam.CameraModel.PINHOLE, cfg["camera"], cfg["img_wh"],
                       cfg["orb"], device=dev, Kmax=cfg["Kmax"], Pmax=cfg["Pmax"], fps=cfg["fps"])
        fresh.enable_place_recognition(voc)
        fresh.enable_multimap(voc)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fresh.load_atlas(d)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t1) * 1e3
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    maps_a, maps_b = mm.atlas.maps, fresh.multimap.atlas.maps
    check(len(maps_a) == len(maps_b) and all(_same_store(a, b) for a, b in zip(maps_a, maps_b))
          and fresh.store is maps_b[mm.atlas.active_idx]
          and all(m.device == dev for m in maps_b),
          "phase 15: the loaded atlas differs from the saved one")
    check(fresh.tracking_state == TrackState.LOST, f"phase 15: loaded state {fresh.tracking_state}")
    imgs = E._rendered("mono", MM_FRAMES, 0, MM_T_LOOP, None, MM_BLIND)[1]  # still cached
    t_next = float(rep.gt_ts[-1]) + 1.0
    reloc_states = []
    for j, k in enumerate(range(*MM_RELOC_FRAMES)):
        fresh.track_monocular(imgs[k], t_next + 0.05 * j)
        reloc_states.append(fresh.tracking_state.name)
    first_ok = reloc_states.index("OK") if "OK" in reloc_states else None
    check(first_ok is not None and first_ok < 5 and fresh.multimap.atlas.n_maps == len(maps_a),
          f"phase 15: the loaded atlas did not relocalize within 5 frames: {reloc_states}")

    fps = MM_FRAMES / (sum(ms) / 1e3)
    med = lambda xs: statistics.median(xs) if xs else float("nan")  # noqa: E731
    spans_ms = rep.multimap_ms
    print(f"phase 15 lap: {MM_FRAMES} frames of the synthetic EuRoC sequence with a "
          f"{MM_T_LOOP:g} s lap, frames {MM_BLIND[0]}-{sum(MM_BLIND) - 1} blind; launches "
          f"{launches}; {fps:.2f} frames/s over the replay ({wall_s:.1f} s wall, "
          f"{rep.render_s:.1f} s of rendering)")
    print(f"phase 15 map 0 stored at frame {st0['frame']} with {st0['n_kf']} keyframes (JAX "
          f"{JAX_MM_STORED[0]}, {JAX_MM_STORED[1]}); merged at frame {mg['frame']}: keyframe "
          f"{mg['kf']} of the {mg['n_kf_active']}-keyframe map onto {mg['cand']} (JAX frame "
          f"{JAX_MM_MERGE[0]}, {JAX_MM_MERGE[1]} keyframes, {JAX_MM_MERGE[2]} onto "
          f"{JAX_MM_MERGE[3]}), s {mg['s']:.6f}, {mg['n_kf']} keyframes after it; maps per frame "
          f"{sorted(set(rep.n_maps))}; ATE {rep.ate:.6f} m, gate {MM_ATE_GATE:.6f} m (2 x the "
          f"JAX System's {JAX_MM_ATE} m); GBA {rep.gba_finished} finished")
    print("phase 15 host syncs and ms per frame kind: " + "; ".join(
        f"{kind} {len(v)} frames, syncs median {med([n for n, _ in v])} (max "
        f"{max(n for n, _ in v)}), ms median {med([m for _, m in v]):.2f}"
        for kind, v in sorted(by_kind.items())))

    def span_line(name):
        v = spans_ms.get(name, [])
        return (f"{name} {len(v)} calls, host ms median {med([h for _, h, _ in v]):.2f}, device "
                f"ms median {med([d for _, _, d in v if d is not None]):.2f}")

    at_merge = [h for f_, h, _ in spans_ms.get("try merge", []) if f_ == mg["frame"]]
    print(f"phase 15 ms: {span_line('try merge')} (one per keyframe frame of a map while "
          f"another is stored; {at_merge} at the merging frame); _do_merge at frame "
          f"{mg['frame']}: " + "; ".join(
              f"{name[len('merge: '):]} host {h:.2f} / device {dv:.2f}"
              for name in ("merge: merge maps", "merge: weld fuse", "merge: weld BA",
                           "merge: essential graph", "merge: GBA start")
              for f_, h, dv in spans_ms.get(name, []) if f_ == mg["frame"]))
    print(f"phase 15 kernels vs plain at the merging keyframe ({v0['kf']} onto {v0['cand']}): "
          f"{v_k['matches']} matches equal, {v_k['sim3_inliers']} Sim3 inliers, Sim3 within "
          f"{dS:.1e} (within {dS0:.1e} of the lap's); merge_maps + weld fuse: kf_mp rows equal, "
          f"floats within {dW:.1e}")
    print(f"phase 15 atlas: save {save_ms:.1f} ms, load {load_ms:.1f} ms ({len(maps_a)} maps, "
          f"{size} bytes on disk), every array equal bit for bit; map 0's frames "
          f"{MM_RELOC_FRAMES[0]}-{MM_RELOC_FRAMES[1] - 1} fed to it: {reloc_states}")
    print(f"phase 15 B1 launches by call over the replay: {sites}")
    args = {site: next(c[1] for c in calls if c[0] == site) for site in B1_MM_SITES.values()}
    return dict(rep=rep, sites=sites, launches=launches, args=args)


# Phase 16: the runner at its defaults on a sequence on disk. Phase 10's 8 s
# lap without the kidnap (seed 0, 752x480, 260 frames, with its ground truth
# and 200 Hz IMU) written in the EuRoC layout by `entry.write_euroc_sequence`;
# its digest over the decoded pixels and the CSV text, taken when the CPU
# wrote it. The JAX runner on the same files on a CPU (`python
# tests/jax_runner_lap.py --seq DIR` and `--sync-mapping`, about an hour each on
# 8 cores; every flag at its default: Kmax 512, Pmax 65536, the 97k-word
# vocabulary, place recognition and the Atlas): initialized at frame 1, every
# frame OK after it, one loop closed (async: keyframe 31 onto 2 after frame
# 167; sync: 67 onto 5 after frame 156), the GBA finished on the PCG path, 47
# and 75 keyframes, Sim3 ATE 0.020303 m (async) and 0.012712 m (sync). The
# `--sync-mapping` run tracks the first SYNC16_FRAMES frames (`--max-frames`,
# cut from 260 for the time limit); the JAX runner with `--sync-mapping
# --max-frames 200` (2559 s): the same loop after frame 156, its GBA finished
# in frame 160's tick, 71 keyframes, Sim3 ATE 0.013689 m.
SEQ16_FRAMES = 260
SEQ16_T_LOOP = 8.0
SEQ16_DIGEST = "2592ec37f0f0b18819bc18b578e12b7c4ce567c6b6aea6bf43b6aa4259e8faed"
SYNC16_FRAMES = 200
JAX_RUNNER = {
    "async": dict(ate=0.020303, loop_frame=167, n_kf=47, gba_finished=1),
    "sync": dict(ate=0.013689, loop_frame=156, n_kf=71, gba_finished=1),
}
RUNNER_LOOP_SLACK = 30  # frames between the port's first closure and the JAX runner's
RERUN16_FRAME = 200  # the frame whose local-map match runs again, kernels vs plain
# Phase 17: the stream server and the viewer, config 3's first 60 frames (cut
# from 80 for the time limit; its IMU initializes near frame 49).
N_STREAM = 60


class _NoSummary:
    """stdout without the runner's `summary {...}` line (this script reads the
    in-process run's summary from `main`'s result)."""

    def __init__(self, out):
        self.out, self.buf = out, ""

    def write(self, text):
        self.buf += text
        *lines, self.buf = self.buf.split("\n")
        for line in lines:
            if not line.startswith("summary "):
                self.out.write(line + "\n")
        return len(text)

    def flush(self):
        self.out.flush()


def _runner_lines(summ: dict, what: str, jax: dict) -> None:
    """Gate and print one run of the runner from its summary."""
    n = summ["n"]
    ms = summ["frame_ms"]
    med = lambda xs: statistics.median(xs) if xs else float("nan")  # noqa: E731
    loops = summ["loops"]
    print(f"{what} outcome: initialized at frame {summ['first_ok']}, not OK after it "
          f"{summ['not_ok_after_init']}, loops {[(L['frame'], L['kf'], L['loop_kf']) for L in loops]} "
          f"(JAX runner: frame {jax['loop_frame']}), {summ['n_kf']} keyframes (JAX {jax['n_kf']}), "
          f"GBA {summ['gba_path']} path {summ['gba_finished']} finished {summ['gba_aborted']} "
          f"aborted (JAX {jax['gba_finished']} finished), ATE {summ['ate']} m (JAX runner "
          f"{jax['ate']} m), mapper idle after shutdown {summ['mapper_idle']}", flush=True)
    check(summ["first_ok"] is not None and not summ["not_ok_after_init"],
          f"{what}: frames not OK after the map's initialization {summ['not_ok_after_init']}")
    check(loops and abs(loops[0]["frame"] - jax["loop_frame"]) <= RUNNER_LOOP_SLACK,
          f"{what}: no loop closed within {RUNNER_LOOP_SLACK} frames of the JAX runner's "
          f"(frame {jax['loop_frame']}): {loops}")
    check(not loops or loops[0]["ate_after"] < loops[0]["ate_before"],
          f"{what}: the closure raised the ATE")
    check(summ["gba_path"] == "pcg" and summ["gba_finished"] >= 1,
          f"{what}: no GBA finished on the PCG path ({summ['gba_path']}, "
          f"{summ['gba_finished']} finished)")
    check(summ["mapper_idle"], f"{what}: the mapper is busy after shutdown")
    gate = max(2 * jax["ate"], 0.01)
    check(summ["ate"] is not None and summ["ate"] <= gate,
          f"{what}: ATE {summ['ate']} m above the gate {gate} m")
    check(summ["syncs"] is not None, f"{what}: host syncs not counted")
    syncs = summ["syncs"] or [-1] * n
    by_kind = {}
    for kind, sy, m in zip(summ["kinds"], syncs, ms):
        by_kind.setdefault(kind, []).append((sy, m))
    print(f"{what}: {n / (sum(ms) / 1e3):.2f} frames/s over {n} frames ({summ['wall_s']:.1f} s "
          f"wall with the final drain); ms per frame median {med(ms):.2f}, p95 "
          f"{float(np.percentile(ms, 95)):.2f}, max {max(ms):.2f} (frame {int(np.argmax(ms))}); "
          f"ATE {summ['ate']:.6f} m, gate {gate:.6f} m (2 x the JAX runner's {jax['ate']} m)")
    print(f"{what} syncs and ms per frame kind: " + "; ".join(
        f"{kind} {len(v)} frames, syncs median {med([s for s, _ in v])} (max "
        f"{max(s for s, _ in v)}), ms median {med([m for _, m in v]):.2f} p95 "
        f"{float(np.percentile([m for _, m in v], 95)):.2f}" for kind, v in sorted(by_kind.items())))
    chunks = summ["gba_chunk_ms"]
    print(f"{what} GBA chunks (2 LM iterations of 50 CG steps each, PCG path): "
          f"{[round(d, 2) for _, d in chunks]} ms device, {[round(h, 2) for h, _ in chunks]} ms "
          f"host")
    for name, v in sorted(summ["spans"].items()):
        if name.startswith("mapping/"):
            dev = [d for _, _, d in v if d is not None]
            print(f"{what} {name}: {len(v)} calls, device ms median {med(dev):.2f} max "
                  f"{max(dev) if dev else float('nan'):.2f}, host ms median "
                  f"{med([h for _, h, _ in v]):.2f}; on frames {sorted({f for f, _, _ in v})[:12]}...")


def _trajectory_files(out: str, kf_out: str, summ: dict, what: str) -> None:
    rows = np.loadtxt(out, ndmin=2)
    kf_rows = np.loadtxt(kf_out, ndmin=2)
    n_tracked = summ["n"] - summ["first_ok"] + 1
    check(rows.shape[1] == 8 and rows.shape[0] >= n_tracked - 1 and np.isfinite(rows).all(),
          f"{what}: {out} holds {rows.shape} rows (frames tracked {n_tracked})")
    check(kf_rows.shape[1] == 8 and 2 <= kf_rows.shape[0] <= summ["n_kf"],
          f"{what}: {kf_out} holds {kf_rows.shape} rows, {summ['n_kf']} keyframes")
    print(f"{what} trajectory files (TUM): {rows.shape[0]} frame poses and {kf_rows.shape[0]} "
          f"keyframe poses read back")


@contextlib.contextmanager
def _rerun_local_map(frame: int):
    """Within the block, the first local-map match of runner frame `frame`
    (the runner's span recorder names the frame) runs again through the
    kernels and through the plain versions; yields a dict that receives B1's
    arguments there, whether all three results are equal, the re-runs' ms
    and the associations found."""
    from orbslam3_tpu_torch import spans
    from orbslam3_tpu_torch.ops import _build, cuda_match
    from orbslam3_tpu_torch.pipeline import tracking as trk

    rerun = {}
    orig_lm = trk._track_local_map_match

    def local_map(*a, **kw):
        out = orig_lm(*a, **kw)
        rec = spans._active
        if rec is not None and rec.frame == frame and not rerun:
            captured = []
            inner = cuda_match.hamming_top2

            def capture(*args):
                captured.append(tuple(_clone(x) for x in args + (None,) * (4 - len(args))))
                return inner(*args)

            with _comparing() as took:
                cuda_match.hamming_top2 = capture
                try:
                    k_ = orig_lm(*a, **kw)
                finally:
                    cuda_match.hamming_top2 = inner
                with _build.force_plain():
                    p_ = orig_lm(*a, **kw)
                same = all(torch.equal(x, y) for x, y in zip(k_, p_)) and all(
                    torch.equal(x, y) for x, y in zip(k_, out))
                n_assoc = int((k_[0] >= 0).sum())  # read while the syncs are not counted
            rerun.update(args=captured[0], same=same, took=took, n_assoc=n_assoc)
        return out

    trk._track_local_map_match = local_map
    try:
        yield rerun
    finally:
        trk._track_local_map_match = orig_lm


def phase16_runner(dev, card: str, lap: str | None = None) -> dict:
    """Phase 16: `python -m orbslam3_tpu_torch.run_sequence` at its defaults
    (asynchronous mapping, Kmax 512, Pmax 65536, the 97k-word vocabulary,
    place recognition and the Atlas) on phase 10's lap written to disk, first
    in this process through `run_sequence.main` (so B1's calls are recorded;
    the local-map match of frame RERUN16_FRAME runs again through the kernels
    and through the plain versions), then with `--sync-mapping` as a
    subprocess, the command as a user types it. Gates and prints in the
    module docstring. The sequence is written at `lap` when given (phase 21
    replays it), else in a temporary directory. Returns the launches and
    B1's row at the 65536-key local-map call."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="_chip_smoke_seq_", dir=root) as tmp:
        return _phase16_in(lap or os.path.join(tmp, "lap"), tmp, root, card)


def _lap_sequence(seq: str, what: str) -> None:
    """Phase 10's lap with its IMU in the EuRoC layout at `seq`
    (`entry.write_euroc_sequence(seq, SEQ16_FRAMES, 0, t_loop=SEQ16_T_LOOP,
    imu=True)`), written unless an earlier phase of the run wrote it there;
    its digest must be the CPU's."""
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch.io import datasets

    t0 = time.perf_counter()
    wrote = not os.path.exists(os.path.join(seq, "settings.yaml"))
    if wrote:
        E.write_euroc_sequence(seq, SEQ16_FRAMES, 0, t_loop=SEQ16_T_LOOP, imu=True)
    t1 = time.perf_counter()
    digest = datasets.sequence_digest(seq)
    print(f"{what} sequence: {SEQ16_FRAMES} frames of the {SEQ16_T_LOOP:g} s lap with its 200 Hz "
          f"IMU in the EuRoC layout, " + (f"written in {t1 - t0:.1f} s" if wrote else
                                           "as an earlier phase wrote it")
          + f"; sha256 of its pixels and CSV text {digest} ({time.perf_counter() - t1:.1f} s)",
          flush=True)
    check(digest == SEQ16_DIGEST, f"{what}: the sequence's digest {digest} is not the CPU's "
          f"{SEQ16_DIGEST}")


def _phase16_in(seq: str, tmp: str, root: str, card: str) -> dict:
    from orbslam3_tpu_torch import kernel_bench as KB
    from orbslam3_tpu_torch import run_sequence
    from orbslam3_tpu_torch.ops import _build, cuda_fast, cuda_match

    _lap_sequence(seq, "phase 16")
    settings = os.path.join(seq, "settings.yaml")

    out_a, kf_a = os.path.join(tmp, "async.txt"), os.path.join(tmp, "async_kf.txt")
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    with _rerun_local_map(RERUN16_FRAME) as rerun, _b1_calls([], keep_args=set()) as calls, \
            contextlib.redirect_stdout(_NoSummary(sys.stdout)):
        res = run_sequence.main([settings, seq, "--dataset", "euroc", "--mode", "mono",
                                 "--out", out_a, "--kf-out", kf_a, "--timing"])
    sites = {}
    for c in calls:
        sites[c[0]] = sites.get(c[0], 0) + 1
    launches = {"fast_nms": cuda_fast.LAUNCHES,
                "hamming_top2": cuda_match.LAUNCHES - sites.get("comparison", 0)}
    check(launches["fast_nms"] >= SEQ16_FRAMES and sites.get("local map", 0) > 0,
          f"phase 16: launches {launches}, B1 by site {sites}")
    summ = {k: v for k, v in res.items() if k not in ("system", "states")}
    check("args" in rerun, f"phase 16: frame {RERUN16_FRAME}'s local-map match did not run")
    summ["frame_ms"][RERUN16_FRAME] -= rerun["took"][0]
    _runner_lines(summ, "phase 16 async", JAX_RUNNER["async"])
    _trajectory_files(out_a, kf_a, summ, "phase 16 async")
    check(rerun["same"], f"phase 16: frame {RERUN16_FRAME}'s local-map match differs, kernels "
          f"vs plain")
    a = rerun["args"]
    print(f"phase 16 kernels vs plain: frame {RERUN16_FRAME}'s local-map match "
          f"({a[0].shape[0]} map points x {a[1].shape[0]} keypoints) equal, {rerun['n_assoc']} "
          f"associations; launches {launches}; B1 by site {sites}")
    got = cuda_match.hamming_top2(*a)
    with _build.force_plain():
        ref = cuda_match.hamming_top2(*a)
    torch.cuda.synchronize()
    for what, k_, p_ in zip(("d1", "d2", "j1"), got, ref):
        check(torch.equal(k_, p_), f"B1 local map {a[0].shape[0]} keys (phase 16): {what} differs")
    err = max(float((got[0] - ref[0]).abs().max()), float((got[1] - ref[1]).abs().max()))
    t = KB.time_b1(a)
    with _build.force_plain():
        plain_ms = KB.call_us(lambda: cuda_match.hamming_top2(*a), iters=10) / 1e3
    bd = KB.b1_bound(*a)
    n_lm = sites.get("local map", 0)
    n_ok = len(summ["kinds"]) - summ["kinds"].count("not OK")
    row = {"call": "local map, runner (Pmax 65536)", "shape": [a[0].shape[0], a[1].shape[0]],
           "windowed": a[3] is not None, **t, "plain_ms": plain_ms, "bound_us": bd["bound_us"],
           "bound_by": bd["bound_by"], "in_window_pairs": bd["pairs"],
           "launches_per_replay": n_lm, "replay": "phase 16",
           "launches_per_tracked_frame": n_lm / max(n_ok, 1)}
    print(f"phase 16 B1 local map {a[0].shape[0]}x{a[1].shape[0]} windowed: exact vs plain; "
          f"device {t['device_us']:.2f} us (graph of {KB.GRAPH_CALLS}), call {t['call_us']:.2f} us, "
          f"profiler {t['profiler_us']} us, bound {bd['bound_us']:.3f} us ({bd['bound_by']}; "
          f"{bd['bytes']} bytes, {bd['pairs']} pairs to popcount), plain {plain_ms:.4f} ms; {n_lm} "
          f"launches in the runner's async run [{card}]", flush=True)
    del res
    torch.cuda.empty_cache()  # the subprocess's run gets the card's memory back

    out_s, kf_s = os.path.join(tmp, "sync.txt"), os.path.join(tmp, "sync_kf.txt")
    cmd = [sys.executable, "-m", "orbslam3_tpu_torch.run_sequence", settings, seq, "--dataset",
           "euroc", "--mode", "mono", "--sync-mapping", "--max-frames", str(SYNC16_FRAMES),
           "--out", out_s, "--kf-out", kf_s, "--timing"]
    t2 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("summary "):
            print(f"phase 16 sync | {line}")
    check(proc.returncode == 0, f"phase 16: the --sync-mapping run exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    summ_s = json.loads(next(x for x in lines if x.startswith("summary "))[len("summary "):])
    print(f"phase 16 sync: `python -m orbslam3_tpu_torch.run_sequence ... --sync-mapping "
          f"--max-frames {SYNC16_FRAMES}` took {time.perf_counter() - t2:.1f} s as a subprocess")
    _runner_lines(summ_s, "phase 16 sync", JAX_RUNNER["sync"])
    _trajectory_files(out_s, kf_s, summ_s, "phase 16 sync")
    return dict(launches=launches, row=row, err=err)


def phase17_stream_viewer(dev, card: str) -> dict:
    """Phase 17: the stream server and the viewer. Config 3's first N_STREAM
    frames written to disk; an IMU_MONOCULAR `System` on the card with
    asynchronous mapping and the viewer (port 0, 0.2 s) serves them on a UNIX
    socket from its own thread while `serve_stream.replay` sends each frame's
    IMU samples, then the frame; a poller fetches the viewer's routes during
    the serve. After it, the same System is driven directly by
    `track_monocular` on the same files: states equal, poses within 1e-4.
    Tensor reads off the serving thread are counted: none may happen."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="_chip_smoke_seq_", dir=root) as seq:
        return _phase17_in(seq, card)


def _phase17_in(seq: str, card: str) -> dict:
    import socket
    import threading
    import urllib.request
    from types import SimpleNamespace

    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch import serve_stream
    from orbslam3_tpu_torch.io import datasets, png, stream
    from orbslam3_tpu_torch.ops import cuda_fast, cuda_match
    from orbslam3_tpu_torch.pipeline.tracking import TrackState

    t0 = time.perf_counter()
    E.write_euroc_sequence(seq, N_STREAM, 0, imu=True)
    print(f"phase 17 sequence: config 3's first {N_STREAM} frames and their IMU stream in the "
          f"EuRoC layout ({time.perf_counter() - t0:.1f} s)", flush=True)
    args = SimpleNamespace(settings=os.path.join(seq, "settings.yaml"), mode="mono-vi", kmax=256,
                           pmax=16384, device=None, vocab=None, viewer=0)
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    served = serve_stream.build_system(args)
    viewer = served.viewer
    check(viewer.min_period_s == 0.2, "phase 17: the viewer's period is not 0.2 s")
    sock_path = os.path.join(seq, "slam.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(1)
    info = dict(states=[], imu_init=[], ms=[], update_ms=[], update_syncs=[])
    fetched, published, done = threading.Event(), threading.Event(), threading.Event()
    serving = {}

    def serve():
        serving["thread"] = threading.current_thread()
        conn, _ = srv.accept()
        track = served.track_monocular
        update = viewer.update

        def tracked(img, t, imu_measurements=None):
            t1 = time.perf_counter()
            cur = track(img, t, imu_measurements=imu_measurements)
            info["ms"].append((time.perf_counter() - t1) * 1e3)
            info["states"].append(served.tracking_state.name)
            info["imu_init"].append(served.mapper.imu_initialized)
            info["last"] = (img, cur)
            return cur

        def timed_update(img=None, frame=None):
            n0 = viewer.n_published
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t1 = time.perf_counter()
                update(img, frame)
                dt = (time.perf_counter() - t1) * 1e3
            torch.cuda.set_sync_debug_mode(0)
            if viewer.n_published > n0:
                info["update_ms"].append(dt)
                info["update_syncs"].append(sum("synchroniz" in str(w.message) for w in caught))

        served.track_monocular = tracked
        viewer.update = timed_update
        try:
            info["n"] = stream.serve(served, conn)
            viewer._last_pub = -1e9  # one more publish, of the final state
            update(*info["last"])
            info["final"] = (served.n_keyframes, served.n_map_points, served.tracking_state.name)
            published.set()
            fetched.wait(timeout=120)
            served.shutdown()
            info["idle"] = served.async_mapper.idle()
        except Exception:
            import traceback

            info["error"] = traceback.format_exc()
        finally:
            published.set()
            conn.close()
            done.set()

    # Tensor reads while serving, by thread: only the serving thread may read.
    reads_off = []
    methods = ("cpu", "numpy", "item", "tolist", "__array__")
    originals = {m: getattr(torch.Tensor, m) for m in methods}

    def counted(name):
        def read(self, *a, **kw):
            if self.is_cuda and threading.current_thread() is not serving.get("thread"):
                reads_off.append((threading.current_thread().name, name))
            return originals[name](self, *a, **kw)
        return read

    polls = []

    def poll():
        while not done.is_set():
            for route in ("/state.json", "/frame.png", "/map.png"):
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}{route}",
                                                timeout=10) as r:
                        polls.append((route, r.status, r.read()))
                except Exception as e:  # /frame.png is 404 until the first publish
                    polls.append((route, getattr(e, "code", None), b""))
            time.sleep(0.3)

    th = threading.Thread(target=serve, name="phase17-serve")
    poller = threading.Thread(target=poll, name="phase17-poll", daemon=True)
    for m in methods:
        setattr(torch.Tensor, m, counted(m))
    try:
        torch.cuda.synchronize()
        t_serve = time.perf_counter()
        th.start()
        poller.start()
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(sock_path)
        poses = serve_stream.replay(sock, seq, mode="mono-vi", log_every=0)
        published.wait(timeout=600)
        after = {}
        for route in ("/state.json", "/frame.png", "/map.png"):
            with urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}{route}", timeout=30) as r:
                after[route] = r.read()
        fetched.set()
        th.join(timeout=600)
        serve_s = time.perf_counter() - t_serve
        done.set()
        poller.join(timeout=30)
        sock.close()
        srv.close()
    finally:
        for m, f in originals.items():
            setattr(torch.Tensor, m, f)
    launches = {"fast_nms": cuda_fast.LAUNCHES, "hamming_top2": cuda_match.LAUNCHES}
    check(launches["fast_nms"] >= N_STREAM and launches["hamming_top2"] > 0,
          f"phase 17: the serve launched {launches}")
    check("error" not in info, f"phase 17: the serving thread failed: {info.get('error')}")
    check(info.get("n") == N_STREAM == len(poses), f"phase 17: {info.get('n')} frames served, "
          f"{len(poses)} poses received of {N_STREAM}")
    check(not reads_off, f"phase 17: tensor reads off the serving thread: {reads_off[:10]}")
    check(info.get("idle"), "phase 17: the mapper is busy after shutdown")
    during = [json.loads(b) for r, code, b in polls if r == "/state.json" and code == 200]
    check(len(during) >= 2 and any(d["frame_id"] >= 0 for d in during),
          f"phase 17: /state.json fetched {len(during)} times during the serve")
    last = json.loads(after["/state.json"])
    n_kf, n_mp, state = info["final"]
    check((last["n_keyframes"], last["n_map_points"], last["state"]) == (n_kf, n_mp, state),
          f"phase 17: /state.json after the serve {last['n_keyframes']}, {last['n_map_points']}, "
          f"{last['state']} vs the System's {n_kf}, {n_mp}, {state}")
    frame_png = png.decode(after["/frame.png"], png.IMREAD_UNCHANGED)
    map_png = png.decode(after["/map.png"], png.IMREAD_UNCHANGED)
    check(frame_png.shape == (480, 752, 3) and map_png.shape == (640, 640, 3),
          f"phase 17: /frame.png {frame_png.shape}, /map.png {map_png.shape}")
    n_pngs = sum(code == 200 and r != "/state.json" for r, code, _ in polls)

    # The direct-drive twin, after the serve: the same System, the same files.
    direct = serve_stream.build_system(SimpleNamespace(**{**vars(args), "viewer": None}))
    seq_l = datasets.load_euroc_images(seq)
    imu = datasets.load_euroc_imu(seq)
    cursor, d_states, dmax, d_ms, d_init = 0, [], 0.0, [], []
    for k in range(N_STREAM):
        ts = float(seq_l.timestamps[k])
        hi = int(np.searchsorted(imu.timestamps, ts, side="right"))
        batch = [(float(imu.timestamps[j]), imu.acc[j], imu.gyro[j]) for j in range(cursor, hi)]
        cursor = hi
        t1 = time.perf_counter()
        cur = direct.track_monocular(seq_l.read(k), ts, imu_measurements=batch or None)
        d_ms.append((time.perf_counter() - t1) * 1e3)
        d_states.append(direct.tracking_state.name)
        d_init.append(direct.mapper.imu_initialized)
        Rwc, twc = cur.Twc()
        t_s, st_s, R_s, tw_s = poses[k]
        check(t_s == ts, f"phase 17 frame {k}: the POSE's timestamp {t_s} is not {ts}")
        dmax = max(dmax, float(np.abs(R_s - Rwc).max()), float(np.abs(tw_s - twc).max()))
    direct.shutdown()
    served_states = [stream_state for _, stream_state, _, _ in poses]
    check([TrackState(v).name for v in served_states] == d_states == info["states"],
          f"phase 17: states served {served_states} vs direct {d_states}")
    check(dmax <= 1e-4, f"phase 17: served poses {dmax} from the direct drive's")
    init_s = info["imu_init"].index(True) if True in info["imu_init"] else None
    init_d = d_init.index(True) if True in d_init else None
    med = lambda xs: statistics.median(xs) if xs else float("nan")  # noqa: E731
    first_ok = d_states.index("OK") if "OK" in d_states else None
    print(f"phase 17 served {N_STREAM} frames over a UNIX socket in {serve_s:.1f} s: every frame "
          f"answered; states equal to the direct drive's (initialized at frame {first_ok}, "
          f"{d_states.count('OK')} OK), poses within {dmax:.2e} (gate 1e-4); IMU initialized at "
          f"frame {init_s} served, {init_d} direct; {n_kf} keyframes, {n_mp} points; launches "
          f"{launches}")
    print(f"phase 17 ms per frame: served median {med(info['ms']):.2f} (max {max(info['ms']):.2f}), "
          f"direct median {med(d_ms):.2f} (max {max(d_ms):.2f}); viewer.update {len(info['update_ms'])} "
          f"publishes, ms median {med(info['update_ms']):.2f} max {max(info['update_ms']):.2f}, host "
          f"syncs per publish {sorted(set(info['update_syncs']))} (every 0.2 s, "
          f"{len(info['update_ms']) / N_STREAM:.2f} per frame) [{card}]")
    print(f"phase 17 viewer: /state.json fetched {len(during)} times during the serve and once "
          f"after it (keyframes {last['n_keyframes']}, points {last['n_map_points']}, state "
          f"{last['state']} equal to the System's); {n_pngs} PNGs during; /frame.png "
          f"{frame_png.shape}, /map.png {map_png.shape} decoded by io/png.py; tensor reads off "
          f"the serving thread: {len(reads_off)}")
    return dict(launches=launches)


# Phase 18: BASELINE config 5 ("map merging + global BA across 2 hosts") on
# two ranks: with one card both on cuda:0 over gloo (NCCL takes one rank a
# card; with two cards or more, NCCL). Each collective raises after
# DIST_TIMEOUT s, so a rank that diverges fails the phase instead of the
# script's time limit.
# Phase 19a: the runner's other sensor modes from files on disk (`--sync-mapping
# --no-loop`, Kmax 256, Pmax 16384), each against a direct drive of the
# `System` on the same decoded files: (what, layout, --dataset, --mode, the
# entry sensor of the direct drive, frames, write_euroc_sequence's keywords,
# the frame whose local-map match runs again, kernels vs plain).
RUNNER_MODES_19A = (
    ("EuRoC stereo (config 2)", "euroc", "euroc", "stereo", "stereo", 30,
     dict(stereo=True), 20),
    ("TUM-VI stereo-inertial fisheye (config 4)", "euroc", "tumvi", "stereo-vi",
     "stereo_vi_fisheye", 60, dict(fisheye=True, imu=True), 50),
    ("TUM RGB-D", "tumrgbd", "tumrgbd", "rgbd", "rgbd", 20, dict(depth=True), 15),
    ("KITTI mono (config 1)", "kitti", "kitti", "mono", "mono", 20, {}, 15),
)
RUNNER_KMAX, RUNNER_PMAX = 256, 16384  # configs 1-4's, as in phases 6-14
# Phase 19b: config 3 through the runner at its defaults (asynchronous
# mapping, place recognition with the 97k-word vocabulary, the Atlas) past
# VIBA2 and the first scale refinement, at configs 1-4's map size. The JAX
# runner on the same files on a CPU (`python tests/jax_runner_lap.py --seq DIR
# --frames 530 --mode mono-vi --kmax 256 --pmax 16384 --c13`, 2220 s on 8 shared cores):
# the map initialized at frame 3, the IMU in the tick of frame 49 with 10
# keyframes, VIBA1 at frame 112 with 17, VIBA2 at 310 with 38, the first scale
# refinement at 510 with 58 (scale 1.000884), every frame OK after the map's
# initialization, no loop closed, 60 keyframes; SE3 ATE 0.025136 m, Sim3 ATE
# 0.014356 m, Sim3 scale 1.011774. Its IMU prediction on the frame after each
# stage's tick (fault C20, unrepaired in the JAX package) and the other frames'
# median, in m. N19B is the synchronous JAX run's first refinement (frame 506) + 24.
N19B = 530
SEQ19B_DIGEST = "c3b2714cb765c8de02b8d9becf0f2f135142903e1f05ef9fe5075db6db6c6895"
JAX_VI_RUNNER = dict(imu_init_frame=49, imu_init_kfs=10, viba1_frame=112, viba1_kfs=17,
                     viba2_frame=310, viba2_kfs=38, refine_frame=510, refine_kfs=58,
                     ate_se3=0.025136, ate_sim3=0.014356, scale=1.011774,
                     c20=dict(after={"imu_init": 0.008977, "viba1": 0.011346,
                                     "viba2": 0.025715, "refinement 1": 0.008302},
                              median=5.1e-05))
# Phase 19b with `--sync-mapping --no-loop` (PR 15, the final run's; PERF.md
# §5): frame ms over the 530 frames, printed beside the defaults' numbers.
SYNC19B_MS = dict(median=176.50, p95=565.14, max=1098.40)
# Phase 19c: config 4, the TUM-VI stereo-inertial fisheye rig, through the
# runner at its defaults, past its IMU initialization and VIBA1. The JAX runner
# on the same files (`python tests/jax_runner_lap.py --seq DIR --frames 130 --mode
# stereo-vi --kmax 256 --pmax 16384 --c13`, 718 s on 8 shared cores): every frame
# OK, the IMU in the tick of frame 52 with 10 keyframes, VIBA1 at frame 112, 18
# keyframes, no loop closed; SE3 ATE 0.001989 m, Sim3 scale 0.998377.
N19C = 130
SEQ19C_DIGEST = "ad7141f308d6b930fbd981dc413743ef49e27df617d12fb2b5cead912f8d2c03"
JAX_SVI_RUNNER = dict(imu_init_frame=52, imu_init_kfs=10, viba1_frame=112, ate_se3=0.001989,
                      c20=dict(after={"imu_init": 0.013374, "viba1": 0.007855},
                               median=6.5e-05))
PREFIX19 = 8  # the plain re-run's frames past the frame that initialized the IMU
C20_FACTOR, C20_FLOOR = 5.0, 0.01  # fault C20 shows: above 5 x the median and 0.01 m


def _load_files(seq_dir: str, dataset: str, mode: str):
    """(the `datasets` loader's sequence, its IMU samples or None) of a
    directory, for a direct drive."""
    from orbslam3_tpu_torch.io import datasets

    if dataset == "kitti":
        seq = datasets.load_kitti(seq_dir)
    elif dataset == "tumrgbd":
        seq = datasets.load_tum_rgbd(seq_dir, os.path.join(seq_dir, "associations.txt"))
    else:
        seq = datasets.load_euroc_images(seq_dir)
        if mode in ("stereo", "stereo-vi"):
            seq.paths_right = datasets.load_euroc_images(seq_dir, cam="cam1").paths
    imu = datasets.load_euroc_imu(seq_dir) if mode.endswith("-vi") else None
    return seq, imu


def _syncs_by_kind(summ: dict, init_frame, what: str, stages: dict | None = None) -> dict:
    """{frame kind: [(syncs, ms, frame)]} of a runner run: its tracked frames
    split at the IMU initialization (when there is one), a tracked frame
    that captured a pose solve's CUDA graph (`summ["captures"]`; the capture
    synchronizes the device) of its own kind, and so is each frame whose call
    completed an IMU stage (`stages`, `entry.imu_stage_frames`)."""
    check(summ["syncs"] is not None, f"{what}: the runner counted no host syncs")
    by_kind = {}
    syncs = summ["syncs"] or [-1] * summ["n"]
    at_stage = {k: name for name, k in (stages or {}).items()}
    for k, (kind, n_sync, m) in enumerate(zip(summ["kinds"], syncs, summ["frame_ms"])):
        if k in at_stage:
            kind = f"{at_stage[k]} completed ({kind})"
        elif kind == "tracked" and k in summ["captures"]:
            kind = "tracked, graph captured"
        elif kind == "tracked" and init_frame is not None:
            kind = "tracked after IMU init" if k > init_frame else "tracked before IMU init"
        by_kind.setdefault(kind, []).append((n_sync, m, k))
    return by_kind


def _kind_line(by_kind: dict) -> str:
    med = statistics.median
    return "; ".join(
        f"{kind} {len(v)} frames, syncs median {med([n for n, _, _ in v])} (max "
        f"{max(n for n, _, _ in v)}), ms median {med([m for _, m, _ in v]):.2f} max "
        f"{max(m for _, m, _ in v):.2f}" for kind, v in sorted(by_kind.items()))


def _check_tracked_syncs(by_kind: dict, want: dict, calls: list, what: str) -> None:
    """Every frame of a kind in `want` made exactly its documented host
    syncs; a frame that did not is named with its B1 calls."""
    for kind, n_want in want.items():
        off = [(k, n) for n, _, k in by_kind.get(kind, []) if n != n_want]
        check(not off, f"{what}: host syncs per {kind} frame not {n_want}: (frame, syncs) {off}; "
              f"their B1 calls {[(c[3], c[0]) for c in calls if c[3] in {k for k, _ in off}]}")


def _run_runner(argv: list, rerun_frame=None):
    """`run_sequence.main(argv)` in this process with every frame recorded
    (`entry.record_frames`), the kernels' launches counted from 0, B1's calls
    by site and, at `rerun_frame`, the local-map match again through the
    kernels and the plain versions; the frames on which a pose solve's CUDA
    graph was captured go to the summary's "captures". Returns (summary,
    frame records, launches, B1 sites, the re-run's dict, B1's calls)."""
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch import run_sequence, spans
    from orbslam3_tpu_torch.ops import cuda_fast, cuda_match
    from orbslam3_tpu_torch.optim import graphed

    captures, graph_run = set(), graphed.run

    def run(*a, **kw):
        n = graphed.CAPTURES
        out = graph_run(*a, **kw)
        if graphed.CAPTURES > n and spans._active is not None:
            captures.add(spans._active.frame)
        return out

    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    graphed.run = run
    try:
        with _rerun_local_map(-1 if rerun_frame is None else rerun_frame) as rerun, \
                _b1_calls([], keep_args=False) as calls, E.record_frames() as rows, \
                contextlib.redirect_stdout(_NoSummary(sys.stdout)):
            res = run_sequence.main(argv)
    finally:
        graphed.run = graph_run
    sites = {}
    for c in calls:
        sites[c[0]] = sites.get(c[0], 0) + 1
    launches = {"fast_nms": cuda_fast.LAUNCHES,
                "hamming_top2": cuda_match.LAUNCHES - sites.pop("comparison", 0)}
    if rerun.get("took"):
        res["frame_ms"][rerun_frame] -= rerun["took"][0]
    res["captures"] = captures
    return res, rows, launches, sites, rerun, calls


def phase19_runner_modes(dev, card: str) -> dict:
    """Phase 19: 19a, the runner in each mode of RUNNER_MODES_19A against a
    direct drive; 19b, config 3 through the runner at its defaults to its
    first scale refinement, and 19c, config 4 through it past VIBA1, against
    the JAX runner's constants. Gates and lines in the module docstring.
    Returns the launches of the runner's runs."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    launches = {"fast_nms": 0, "hamming_top2": 0}
    walls = {}
    with tempfile.TemporaryDirectory(prefix="_chip_smoke_seq_19_", dir=root) as tmp:
        for mode in RUNNER_MODES_19A:
            t0 = time.perf_counter()
            got = _phase19a_mode(dev, card, tmp, *mode)
            launches = {k: launches[k] + got[k] for k in launches}
            walls[mode[0]] = time.perf_counter() - t0
        print("phase 19a wall per mode (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
        for name, fn in (("19b", _phase19b_mono_inertial), ("19c", _phase19c_stereo_inertial)):
            t0 = time.perf_counter()
            got = fn(dev, card, tmp)
            launches = {k: launches[k] + got[k] for k in launches}
            print(f"phase {name} wall: {time.perf_counter() - t0:.1f} s")
    return launches


def _phase19a_mode(dev, card, tmp, what, layout, dataset, mode, sensor, n, kw, rerun_frame):
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch.pipeline.tracking import Tracker

    seq_dir = os.path.join(tmp, sensor)
    t0 = time.perf_counter()
    E.write_euroc_sequence(seq_dir, n, 0, layout=layout, **kw)
    write_s = time.perf_counter() - t0
    fmt = "kitti" if dataset == "kitti" else "tum"
    out, kf_out = os.path.join(tmp, f"{sensor}.txt"), os.path.join(tmp, f"{sensor}_kf.txt")
    argv = [os.path.join(seq_dir, "settings.yaml"), seq_dir, "--dataset", dataset, "--mode", mode,
            "--sync-mapping", "--no-loop", "--traj-format", fmt, "--out", out, "--kf-out",
            kf_out, "--kmax", str(RUNNER_KMAX), "--pmax", str(RUNNER_PMAX)]
    if layout == "tumrgbd":
        argv += ["--assoc", os.path.join(seq_dir, "associations.txt")]
    res, rows, launches, sites, rerun, calls = _run_runner(argv, rerun_frame)
    summ = {k: v for k, v in res.items() if k not in ("system", "states", "spans")}
    del res

    seq, imu = _load_files(seq_dir, dataset, mode)
    slam = E.make_system(dev, sensor, Kmax=RUNNER_KMAX, Pmax=RUNNER_PMAX)
    t1 = time.perf_counter()
    with E.record_frames() as direct:
        E.drive_files(slam, mode, seq, imu=imu)
    slam.shutdown()
    direct_s = time.perf_counter() - t1
    tag = f"phase 19a {what}"
    check(len(rows) == len(direct) == n, f"{tag}: {len(rows)} runner frames, {len(direct)} direct")
    keep = ("state", "n_kf", "keyframe", "imu_init", "viba1", "viba2", "pi_taken")
    for k, (a, b) in enumerate(zip(rows, direct)):
        check([getattr(a, f) for f in keep] == [getattr(b, f) for f in keep],
              f"{tag}: frame {k} differs from the direct drive: {a[:2]} vs {b[:2]}")
        check(np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t),
              f"{tag}: frame {k}'s pose differs from the direct drive's")
    check([kd == "keyframe" for kd in summ["kinds"]] == [r.state == "OK" and r.keyframe
                                                          for r in rows],
          f"{tag}: the runner's keyframe frames are not the frames that inserted one (C18)")
    save = slam.save_trajectory_kitti if fmt == "kitti" else slam.save_trajectory_tum
    save(out + ".direct")
    slam.save_keyframe_trajectory_tum(kf_out + ".direct")
    for a in (out, kf_out):
        with open(a, "rb") as f1, open(a + ".direct", "rb") as f2:
            check(f1.read() == f2.read(), f"{tag}: {os.path.basename(a)} differs from the direct "
                  f"drive's byte for byte")
    states = [r.state for r in rows]
    first_ok = states.index("OK") if "OK" in states else None
    check(first_ok is not None and all(x == "OK" for x in states[first_ok:]),
          f"{tag}: a frame not OK after the map's initialization: {states}")
    init = next((k for k, r in enumerate(rows) if r.imu_init), None)
    inertial = mode.endswith("-vi")
    check(not inertial or init is not None, f"{tag}: the IMU did not initialize")
    by_kind = _syncs_by_kind(summ, init, tag)
    base = (Tracker.HOST_SYNCS_PER_FRAME if mode == "mono"
            else Tracker.HOST_SYNCS_PER_STEREO_FRAME)
    want = {"tracked": base, "tracked before IMU init": base,
            "tracked after IMU init": Tracker.HOST_SYNCS_PER_STEREO_INERTIAL_FRAME}
    _check_tracked_syncs(by_kind, want, calls, tag)
    check(launches["fast_nms"] == n * (2 if mode.startswith("stereo") else 1)
          and sites.get("local map", 0) > 0, f"{tag}: launches {launches}, B1 by site {sites}")
    check("args" in rerun and rerun["same"], f"{tag}: frame {rerun_frame}'s local-map match "
          f"did not run again or differs, kernels vs plain")
    ms = summ["frame_ms"]
    print(f"{tag}: {n} frames written ({layout} layout) in {write_s:.1f} s; the runner "
          f"({' '.join(argv[2:6])} --sync-mapping --no-loop) equals a direct drive of "
          f"`entry.make_system(cuda, {sensor!r})` on the decoded files frame for frame (states, "
          f"keyframes, IMU stages, poses bit for bit) and in its trajectory files byte for byte; "
          f"initialized at frame {first_ok}, IMU at {init}, {summ['n_kf']} keyframes; ATE "
          f"{summ['ate']} m, scale vs GT {summ['scale']}; frame ms median "
          f"{statistics.median(ms):.2f} max {max(ms):.2f}, direct drive {direct_s:.1f} s "
          f"[{card}]", flush=True)
    print(f"{tag} syncs and ms per frame kind: {_kind_line(by_kind)}")
    a = rerun["args"]
    print(f"{tag} kernels vs plain: frame {rerun_frame}'s local-map match ({a[0].shape[0]} map "
          f"points x {a[1].shape[0]} keypoints) equal, {rerun['n_assoc']} associations; "
          f"launches {launches}; B1 by site {sites}")
    return launches


def _cpu_refine(captured: dict) -> tuple:
    """The first scale refinement again on the CPU (the plain path) from its
    inputs copied off the card: (Rwg, scale)."""
    from orbslam3_tpu_torch.atlas import store as st
    from orbslam3_tpu_torch.ops import imu as imu_ops
    from orbslam3_tpu_torch.pipeline import inertial_support as isup

    s = captured["state"]
    store = st.MapStore(Kmax=s.kf_R.shape[0], Pmax=s.mp_pos.shape[0], Nf=s.kf_mp.shape[1],
                        device="cpu")
    store.state = s
    store.n_kf, store.kf_ts = captured["n_kf"], captured["kf_ts"]
    ini = isup.ImuInitializer(captured["calib"], mono=True)
    ini.initialized = True
    check(ini.refine_scale(store, captured["preints"], captured["Rbc"], captured["tbc"]),
          "phase 19b: the CPU's scale refinement failed")
    return ini.applied_transform


@contextlib.contextmanager
def _stage_syncs(into: dict):
    """Within the block, the host syncs each mapping stage (`LocalMapper.STAGES`)
    made, appended per stage name to `into`: the syncs that the runner's
    sync-debug mode recorded while the stage ran."""
    from orbslam3_tpu_torch.pipeline.local_mapping import LocalMapper

    stages = LocalMapper.STAGES

    def counted(fn):
        def stage(self, kf_id):
            log = getattr(warnings._showwarnmsg_impl, "__self__", None)  # catch_warnings' list
            n0 = len(log) if isinstance(log, list) else None
            out = fn(self, kf_id)
            if n0 is not None:
                into.setdefault(fn.__name__, []).append(
                    sum("synchroniz" in str(w.message) for w in log[n0:]))
            return out

        return stage

    LocalMapper.STAGES = tuple(counted(f) for f in stages)
    try:
        yield into
    finally:
        LocalMapper.STAGES = stages


def _plain_prefix(argv: list, rows: list, n: int, what: str) -> str:
    """The runner's first `n` frames again through the plain versions of B1 and
    B2 (`--max-frames n`), held to the kernels' run: every frame's state,
    keyframe count, IMU stages and pose-inertial choice equal, its pose, IMU
    prediction and tracked centre within 1e-4."""
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch import run_sequence
    from orbslam3_tpu_torch.ops import _build

    keep = ("state", "n_kf", "keyframe", "imu_init", "viba1", "viba2", "pi_taken", "refined")
    t0 = time.perf_counter()
    with _build.force_plain(), E.record_frames() as plain, \
            contextlib.redirect_stdout(io.StringIO()):
        run_sequence.main(argv + ["--max-frames", str(n)])
    took = time.perf_counter() - t0
    check(len(plain) == n, f"{what} plain prefix: {len(plain)} frames, not {n}")
    d = 0.0
    for k, (a, b) in enumerate(zip(rows, plain)):
        check([getattr(a, f) for f in keep] == [getattr(b, f) for f in keep],
              f"{what} plain prefix: frame {k} differs: {a[:3]}, {b[:3]}")
        for x, y in ((a.R, b.R), (a.t, b.t), (a.pred, b.pred), (a.centre, b.centre)):
            check((x is None) == (y is None), f"{what} plain prefix: frame {k}'s records differ")
            if x is not None:
                d = max(d, float(np.abs(np.asarray(x) - np.asarray(y)).max()))
    check(d <= 1e-4, f"{what} plain prefix: poses within {d}")
    return (f"{n} frames again through the plain versions ({took:.1f} s): states, keyframes, IMU "
            f"stages and the pose-inertial choice equal on every frame, poses, IMU predictions "
            f"and tracked centres within {d:.1e}")


def _c20_line(rows: list, what: str, jax: dict) -> dict:
    """Fault C20's numbers of a run (`entry.imu_prediction_errors`), printed
    beside the JAX runner's; `shows` lists the stages whose next frame is
    above C20_FACTOR x the median and C20_FLOOR."""
    from orbslam3_tpu_torch import entry as E

    c20 = E.imu_prediction_errors(rows)
    med = c20["median"]
    c20["shows"] = [name for name, e in c20["after"].items() if e is not None and med is not None
                    and e > C20_FACTOR * med and e > C20_FLOOR]
    fmt = lambda d: {k: None if v is None else round(v, 6) for k, v in d.items()}  # noqa: E731
    print(f"{what} IMU prediction against the tracked camera centre (fault C20), m: on the frame "
          f"after each IMU stage's tick {fmt(c20['after'])} (stages' frames {c20['stages']}); the "
          f"other {c20['n']} frames after the IMU initialization median "
          f"{med if med is None else round(med, 6)}, largest "
          f"{[(k, round(e, 6)) for k, e in c20['largest']]}; the JAX runner "
          f"{fmt(jax['c20']['after'])}, median {jax['c20']['median']}; above {C20_FACTOR:g} x the "
          f"median and {C20_FLOOR} m: {c20['shows'] or 'none'}")
    return c20


def _vi_runner_lines(summ: dict, rows: list, stages: dict, stage_syncs: dict, calls: list,
                     base: int, after: int, what: str, card: str, sync_ms: dict | None) -> None:
    """Syncs per frame kind (the IMU stages' frames their own kinds) gated for
    the tracked frames (`base` before the IMU initialization, `after` after
    it); the syncs of each mapping stage; frame ms percentiles."""
    init = stages.get("imu_init")
    by_kind = _syncs_by_kind(summ, init, what, stages)
    _check_tracked_syncs(by_kind, {"tracked before IMU init": base,
                                   "tracked after IMU init": after}, calls, what)
    print(f"{what} syncs and ms per frame kind: {_kind_line(by_kind)} [{card}]")
    med = statistics.median
    print(f"{what} host syncs per asynchronous mapping stage: " + "; ".join(
        f"{name} {len(v)} runs, median {med(v)}, max {max(v)}"
        for name, v in stage_syncs.items() if v))
    ms = summ["frame_ms"]
    line = (f"{what} frame ms: median {med(ms):.2f}, p95 {float(np.percentile(ms, 95)):.2f}, max "
            f"{max(ms):.2f} (frame {int(np.argmax(ms))}), {len(ms) / (sum(ms) / 1e3):.2f} frames/s")
    if sync_ms:
        line += (f"; with --sync-mapping --no-loop (PERF.md): median {sync_ms['median']}, p95 "
                 f"{sync_ms['p95']}, max {sync_ms['max']}")
    print(line + f" [{card}]")
    print(f"{what} ms of the frames whose tick completed an IMU stage or a map event: " + "; ".join(
        f"{name} frame {k} {ms[k]:.2f} ms ({(summ['syncs'] or [None] * len(ms))[k]} syncs)"
        for name, k in stages.items()) + f" [{card}]")


def _phase19b_mono_inertial(dev, card, tmp) -> dict:
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch import spans
    from orbslam3_tpu_torch.ate import ate_rmse, ate_scale
    from orbslam3_tpu_torch.atlas import store as st
    from orbslam3_tpu_torch.io import datasets
    from orbslam3_tpu_torch.ops import imu as imu_ops
    from orbslam3_tpu_torch.pipeline import inertial_support as isup
    from orbslam3_tpu_torch.pipeline.tracking import Tracker

    jx = JAX_VI_RUNNER
    seq = os.path.join(tmp, "mono_vi")
    t0 = time.perf_counter()
    E.write_euroc_sequence(seq, N19B, 0, imu=True)
    t1 = time.perf_counter()
    digest = datasets.sequence_digest(seq)
    print(f"phase 19b sequence: {N19B} frames of config 3 with its 200 Hz IMU in the EuRoC "
          f"layout, written in {t1 - t0:.1f} s; sha256 of its pixels and CSV text {digest} "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    check(digest == SEQ19B_DIGEST, f"phase 19b: the sequence's digest {digest} is not the CPU's "
          f"{SEQ19B_DIGEST}")
    refines = []
    refine = isup.ImuInitializer.refine_scale

    def watched(self, store, preints, Rbc, tbc, *a, **kw):
        first = not refines
        if first:  # its inputs, copied off the card before the call moves the map
            with _comparing():
                captured = dict(
                    state=st.MapState(*(x.cpu() for x in store.state)), n_kf=store.n_kf,
                    kf_ts=store.kf_ts.copy(), Rbc=np.array(Rbc), tbc=np.array(tbc),
                    preints={k: imu_ops.Preintegrated(*(x.cpu() for x in p))
                             for k, p in preints.items()},
                    calib=imu_ops.ImuCalib(*(x.cpu() for x in self.calib)))
        self.applied_transform = None
        ok = refine(self, store, preints, Rbc, tbc, *a, **kw)
        t = self.applied_transform
        refines.append(dict(frame=spans._active.frame, n_kf=store.n_kf, ok=bool(ok),
                            scale=None if t is None else float(t[1]),
                            Rwg=None if t is None else np.array(t[0])))
        if first:
            refines[0]["captured"] = captured
        return ok

    out, kf_out = os.path.join(tmp, "mono_vi.txt"), os.path.join(tmp, "mono_vi_kf.txt")
    argv = [os.path.join(seq, "settings.yaml"), seq, "--dataset", "euroc", "--mode", "mono-vi",
            "--out", out, "--kf-out", kf_out, "--kmax", str(RUNNER_KMAX), "--pmax",
            str(RUNNER_PMAX)]
    isup.ImuInitializer.refine_scale = watched
    try:
        with _stage_syncs({}) as stage_syncs:
            res, rows, launches, sites, _, calls = _run_runner(argv)
    finally:
        isup.ImuInitializer.refine_scale = refine
    slam, summ = res["system"], {k: v for k, v in res.items() if k not in ("system", "spans")}
    states = [r.state for r in rows]
    first_ok = states.index("OK") if "OK" in states else None
    stages = E.imu_stage_frames(rows)
    init, viba1, viba2 = (stages.get(k) for k in ("imu_init", "viba1", "viba2"))
    init_kfs = rows[init].n_kf if init is not None else None
    gt = datasets.load_groundtruth_euroc(seq)
    ts, pos = slam.get_trajectory()
    ate_se3 = ate_rmse(ts, pos, gt[0], gt[1], with_scale=False)
    ate_sim3 = ate_rmse(ts, pos, gt[0], gt[1], with_scale=True)
    scale = ate_scale(ts, pos, gt[0], gt[1])
    after = [k for k in range(init + 1, N19B) if states[k] == "OK"] if init is not None else []
    share = sum(rows[k].pi_taken for k in after) / max(len(after), 1)
    print(f"phase 19b outcome (the runner at its defaults: {summ['mapping']} mapping, place "
          f"recognition, the Atlas): map initialized at frame {first_ok}, IMU at frame {init} with "
          f"{init_kfs} keyframes (JAX runner {jx['imu_init_frame']}, {jx['imu_init_kfs']}), VIBA1 "
          f"at frame {viba1} (JAX {jx['viba1_frame']}), VIBA2 at {viba2} (JAX "
          f"{jx['viba2_frame']}), scale refinements "
          f"{[(r['frame'], r['n_kf'], r['ok'], r['scale']) for r in refines]} (frame, keyframes, "
          f"applied, scale; JAX's first at frame {jx['refine_frame']} with {jx['refine_kfs']} "
          f"keyframes); {summ['n_kf']} keyframes, {summ['n_loops']} loops, {summ['merges']} "
          f"merges; SE3 ATE {ate_se3:.6f} m (JAX {jx['ate_se3']}), Sim3 ATE {ate_sim3:.6f} m (JAX "
          f"{jx['ate_sim3']}), scale {scale:.5f} (JAX {jx['scale']}); pose-inertial result on "
          f"{share:.4f} of {len(after)} frames after the IMU initialization; states "
          f"{ {x: states.count(x) for x in sorted(set(states))} }", flush=True)
    check(summ["mapping"] == "asynchronous" and summ["mapper_idle"],
          f"phase 19b: mapping {summ['mapping']}, idle after shutdown {summ['mapper_idle']}")
    check(first_ok is not None and all(x == "OK" for x in states[first_ok:]),
          f"phase 19b: a frame not OK after the map's initialization")
    check(init_kfs is not None and abs(init_kfs - jx["imu_init_kfs"]) <= 2,
          f"phase 19b: IMU initialized with {init_kfs} keyframes, JAX {jx['imu_init_kfs']}")
    check(viba1 is not None and viba2 is not None, "phase 19b: VIBA1 or VIBA2 did not run")
    for name in ("viba1", "viba2"):
        k = stages.get(name)
        check(k is not None and abs(rows[k].n_kf - jx[f"{name}_kfs"]) <= 2,
              f"phase 19b: {name} at frame {k} ({k is not None and rows[k].n_kf} keyframes), JAX "
              f"{jx[f'{name}_kfs']} at frame {jx[f'{name}_frame']}")
    check(refines and abs(refines[0]["n_kf"] - jx["refine_kfs"]) <= 2,
          f"phase 19b: first scale refinement with {refines[0]['n_kf'] if refines else None} "
          f"keyframes, JAX {jx['refine_kfs']}")
    check(after and share >= 0.8, f"phase 19b: pose-inertial result on {share:.4f} of the frames "
          f"after the IMU initialization")
    gates = dict(se3=max(2 * jx["ate_se3"], 0.01), sim3=max(2 * jx["ate_sim3"], 0.01),
                 scale=max(2 * abs(1 - jx["scale"]), 0.02))
    check(np.isfinite(pos).all() and ate_se3 <= gates["se3"] and ate_sim3 <= gates["sim3"]
          and abs(scale - 1) <= gates["scale"],
          f"phase 19b: SE3 ATE {ate_se3}, Sim3 ATE {ate_sim3}, scale {scale} outside {gates}")
    for r0 in refines[:1]:
        check(r0["ok"], "phase 19b: the first scale refinement was not applied")
        Rwg_cpu, s_cpu = _cpu_refine(r0.pop("captured"))
        d_s, d_R = abs(s_cpu - r0["scale"]), float(np.abs(Rwg_cpu - r0["Rwg"]).max())
        check(d_s <= 1e-4 and d_R <= 1e-4, f"phase 19b: the first refinement on the card and on "
              f"the CPU differ: scale {r0['scale']} vs {s_cpu}, Rwg by {d_R}")
        print(f"phase 19b first scale refinement (frame {r0['frame']}) again on the CPU from its "
              f"inputs: scale {s_cpu:.7f} vs the card's {r0['scale']:.7f} (|d| {d_s:.2e}), Rwg "
              f"within {d_R:.2e} (gate 1e-4 each)")
    _vi_runner_lines(summ, rows, stages, stage_syncs, calls, Tracker.HOST_SYNCS_PER_FRAME,
                     Tracker.HOST_SYNCS_PER_INERTIAL_FRAME, "phase 19b", card, SYNC19B_MS)
    c20 = _c20_line(rows, "phase 19b", jx)
    check(not c20["shows"], f"phase 19b: the IMU prediction after {c20['shows']} (fault C20)")
    spans_ = res["spans"]
    for name in ("try_initialize", "full VI-BA", "scale refinement", "local inertial BA"):
        v = spans_.get(name, [])
        if v:
            shown = v if len(v) <= 6 else v[:3] + v[-3:]
            print(f"phase 19b {name}: {len(v)} calls; (frame, host ms, device ms) "
                  f"{[(f, round(h, 2), None if d is None else round(d, 2)) for f, h, d in shown]}")
    check(launches["fast_nms"] == N19B and sites.get("local map", 0) > 0,
          f"phase 19b: launches {launches}, B1 by site {sites}")
    print(f"phase 19b launches on the main path {launches}; B1 by site {sites}")
    print(f"phase 19b kernels vs plain: {_plain_prefix(argv, rows, init + PREFIX19, 'phase 19b')}")
    return launches


def _phase19c_stereo_inertial(dev, card, tmp) -> dict:
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch.ate import ate_rmse, ate_scale
    from orbslam3_tpu_torch.io import datasets
    from orbslam3_tpu_torch.pipeline.tracking import Tracker

    jx = JAX_SVI_RUNNER
    seq = os.path.join(tmp, "stereo_vi")
    t0 = time.perf_counter()
    E.write_euroc_sequence(seq, N19C, 0, imu=True, fisheye=True)
    t1 = time.perf_counter()
    digest = datasets.sequence_digest(seq)
    print(f"phase 19c sequence: {N19C} frames of config 4 (the 512x512 KB8 pair) with its 200 Hz "
          f"IMU in the TUM-VI layout, written in {t1 - t0:.1f} s; sha256 {digest} "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    check(digest == SEQ19C_DIGEST, f"phase 19c: the sequence's digest {digest} is not the CPU's "
          f"{SEQ19C_DIGEST}")
    out, kf_out = os.path.join(tmp, "stereo_vi.txt"), os.path.join(tmp, "stereo_vi_kf.txt")
    argv = [os.path.join(seq, "settings.yaml"), seq, "--dataset", "tumvi", "--mode", "stereo-vi",
            "--out", out, "--kf-out", kf_out, "--kmax", str(RUNNER_KMAX), "--pmax",
            str(RUNNER_PMAX)]
    with _stage_syncs({}) as stage_syncs:
        res, rows, launches, sites, _, calls = _run_runner(argv)
    slam, summ = res["system"], {k: v for k, v in res.items() if k not in ("system", "spans")}
    states = [r.state for r in rows]
    stages = E.imu_stage_frames(rows)
    init, viba1 = stages.get("imu_init"), stages.get("viba1")
    init_kfs = rows[init].n_kf if init is not None else None
    gt = datasets.load_groundtruth_euroc(seq)
    ts, pos = slam.get_trajectory()
    ate_se3 = ate_rmse(ts, pos, gt[0], gt[1], with_scale=False)
    scale = ate_scale(ts, pos, gt[0], gt[1])
    after = [k for k in range(init + 1, N19C) if states[k] == "OK"] if init is not None else []
    share = sum(rows[k].pi_taken for k in after) / max(len(after), 1)
    gate = max(2 * jx["ate_se3"], 0.01)
    print(f"phase 19c outcome (the runner at its defaults: {summ['mapping']} mapping, place "
          f"recognition, the Atlas): IMU at frame {init} with {init_kfs} keyframes (JAX runner "
          f"{jx['imu_init_frame']}, {jx['imu_init_kfs']}), VIBA1 at frame {viba1} (JAX "
          f"{jx['viba1_frame']}); {summ['n_kf']} keyframes, {summ['n_loops']} loops, "
          f"{summ['merges']} merges; SE3 ATE {ate_se3:.6f} m (gate {gate:.6f}: 2 x JAX's "
          f"{jx['ate_se3']}, or 0.01), Sim3 scale {scale:.5f}; pose-inertial result on "
          f"{share:.4f} of {len(after)} frames after the IMU initialization; states "
          f"{ {x: states.count(x) for x in sorted(set(states))} }", flush=True)
    check(summ["mapping"] == "asynchronous" and summ["mapper_idle"],
          f"phase 19c: mapping {summ['mapping']}, idle after shutdown {summ['mapper_idle']}")
    check(all(x == "OK" for x in states), f"phase 19c: a frame not OK: {states}")
    check(init_kfs is not None and abs(init_kfs - jx["imu_init_kfs"]) <= 2,
          f"phase 19c: IMU initialized with {init_kfs} keyframes, JAX {jx['imu_init_kfs']}")
    check(viba1 is not None, "phase 19c: VIBA1 did not run")
    check(np.isfinite(pos).all() and ate_se3 <= gate, f"phase 19c: SE3 ATE {ate_se3} above {gate}")
    _vi_runner_lines(summ, rows, stages, stage_syncs, calls, Tracker.HOST_SYNCS_PER_STEREO_FRAME,
                     Tracker.HOST_SYNCS_PER_STEREO_INERTIAL_FRAME, "phase 19c", card, None)
    c20 = _c20_line(rows, "phase 19c", jx)
    check(not c20["shows"], f"phase 19c: the IMU prediction after {c20['shows']} (fault C20)")
    check(launches["fast_nms"] == 2 * N19C and sites.get("local map", 0) > 0,
          f"phase 19c: launches {launches}, B1 by site {sites}")
    print(f"phase 19c launches on the main path {launches}; B1 by site {sites}")
    print(f"phase 19c kernels vs plain: {_plain_prefix(argv, rows, init + PREFIX19, 'phase 19c')}")
    return launches


DIST_RANKS = 2
DIST_TIMEOUT = 300
DIST_WALL = 600  # s for the whole two-rank replay
DIST_ATE_TOL = 5e-3  # |ATE(2 ranks) - ATE(phase 15)|, scripts/drive_multimap_distributed.py's


def _collective_line(stats: dict) -> str:
    return "; ".join(f"{name} {c} calls, {b / c / 1e6:.3f} MB and {ms / c:.3f} ms each"
                     for name, (c, b, ms) in sorted(stats.items()))


def phase18a_dryrun(dev, card: str) -> dict:
    """Phase 18a: `entry.dryrun_multichip(2)`, the sharded BA at the
    production GBA shape on two ranks of the card, both layouts, each against
    the one-device solve on the card (its gates raise inside)."""
    from orbslam3_tpu_torch import entry as E

    t0 = time.perf_counter()
    out = E.dryrun_multichip(DIST_RANKS, device=dev, timeout=DIST_TIMEOUT)
    sh = out["shape"]
    print(f"phase 18a dryrun_multichip({DIST_RANKS}): C {sh['C']}, P {sh['P']}, "
          f"{sh['obs_per_cam']} observations a keyframe, {sh['iters']} LM iterations, "
          f"pcg_iters {sh['pcg_iters']}; {time.perf_counter() - t0:.1f} s wall [{card}]")
    for layout, what in (("obs", "observations sharded (PCG)"),
                         ("point", "points block-partitioned (dense Schur)")):
        o = out[layout]
        check(np.isfinite(o["cost"]) and o["same_ranks"], f"phase 18a {layout}: {o}")
        print(f"phase 18a {what}: ms per LM iteration {[round(x, 2) for x in o['ms_per_iter']]}"
              f" per rank against {o['single_ms_per_iter']:.2f} on one device; cost "
              f"{o['cost']:.4f} (one device {o['single_cost']:.4f}); poses within "
              f"{o['d_pose']:.2e}, points seen 4+ times within {o['d_points']:.2e} (every point "
              f"{o['d_points_all']:.2e}), inliers flipped {o['inlier_flips']:.4f}; ranks equal; "
              f"collectives per solve: {_collective_line(o['collectives'])}; peak memory per rank "
              f"{[None if x is None else round(x / 2**20, 1) for x in o['peak']]} MiB against "
              f"{o['single_peak'] / 2**20:.1f} MiB on one device")
    pk = out["point"]
    check(max(pk["peak"]) < pk["single_peak"],
          f"phase 18a: a point-sharded rank's peak {pk['peak']} not below one device's "
          f"{pk['single_peak']}")
    return out


def phase18b_config5(dev, card: str, p15: dict) -> dict:
    """Phase 18b: phase 15's multi-map lap as two SPMD replicas with
    `enable_distributed()` (`parallel/launch.py::replay`), held against phase
    15's one-device run: map 0 stored within 2 frames of it, as many merges
    and the first within 2 keyframes, every GBA chunk over the group, every
    merge query sharded, |dATE| < DIST_ATE_TOL and the ATE under phase 15's
    gate, both ranks' map digests equal at every GBA start and at the end,
    the ranks equal, 2 host syncs and no collective per tracked frame."""
    from orbslam3_tpu_torch.parallel import launch
    from orbslam3_tpu_torch.parallel.context import digests_equal
    from orbslam3_tpu_torch.pipeline.tracking import Tracker

    import tempfile

    from orbslam3_tpu_torch import entry as E

    rep15 = p15["rep"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="_chip_smoke_frames_",
                                     dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        frames = os.path.join(tmp, "lap.npz")  # phase 15's lap, rendered once in this process
        E.save_frames(frames, MM_FRAMES, 0, t_loop=MM_T_LOOP, blind=MM_BLIND)
        saved_s = time.perf_counter() - t0
        ranks = launch.replay(DIST_RANKS, dev, timeout=DIST_TIMEOUT, wall=DIST_WALL,
                              sensor="mono", n_frames=MM_FRAMES, vocabulary=VOC_100K,
                              t_loop=MM_T_LOOP, multimap=True, blind=MM_BLIND,
                              frames_file=frames)
    wall_s = time.perf_counter() - t0
    r0 = ranks[0]
    med = lambda xs: statistics.median(xs) if xs else float("nan")  # noqa: E731
    for r in ranks:
        check(r["n_shards"] == DIST_RANKS, f"phase 18b: {r['n_shards']} shards")
    check(all(r["states"] == r0["states"] and r["ate"] == r0["ate"]
              and r["merges"] == r0["merges"] for r in ranks),
          "phase 18b: the ranks' replays differ")
    print(f"phase 18b outcome (rank 0): initialized at frame {r0['states'].index('OK')}; "
          f"stored {r0['stored']}; merges "
          f"{[{k: v for k, v in m.items() if k not in ('R', 't')} for m in r0['merges']]}; "
          f"GBA {r0['gba_finished']} finished, {r0['n_chunks']} chunks, {r0['n_dist_solves']} "
          f"over the group; merge queries {r0['n_queries']}, sharded {r0['n_sharded_queries']}; "
          f"ATE {r0['ate']:.6f} m (phase 15 {rep15.ate:.6f}); {wall_s:.1f} s wall, of which "
          f"{saved_s:.1f} s writing phase 15's frames for the ranks to read")
    check(len(r0["stored"]) >= 1 and len(rep15.stored) >= 1, "phase 18b: no map stored")
    f0, f15 = r0["stored"][0]["frame"], rep15.stored[0]["frame"]
    check(abs(f0 - f15) <= 2 and r0["n_maps"][f0] == 2,
          f"phase 18b: map 0 stored at frame {f0}, phase 15 at {f15}")
    check(len(r0["merges"]) == len(rep15.merges) >= 1,
          f"phase 18b: {len(r0['merges'])} merges, phase 15 {len(rep15.merges)}")
    m0, m15 = r0["merges"][0], rep15.merges[0]
    check(abs(m0["n_kf_active"] - m15["n_kf_active"]) <= 2,
          f"phase 18b: merged with {m0['n_kf_active']} keyframes, phase 15 {m15['n_kf_active']}")
    check(r0["n_chunks"] > 0 and r0["n_dist_solves"] == r0["n_chunks"] and r0["gba_finished"] >= 1,
          f"phase 18b: GBA chunks {r0['n_chunks']}, over the group {r0['n_dist_solves']}")
    check(r0["n_queries"] > 0 and r0["n_sharded_queries"] == r0["n_queries"],
          f"phase 18b: merge queries {r0['n_queries']}, sharded {r0['n_sharded_queries']}")
    d_ate = abs(r0["ate"] - rep15.ate)
    check(np.isfinite(r0["ate"]) and d_ate < DIST_ATE_TOL and r0["ate"] <= MM_ATE_GATE,
          f"phase 18b: ATE {r0['ate']} m, phase 15 {rep15.ate} m, gate {MM_ATE_GATE} m")
    checks = r0["replica_checks"]
    check(digests_equal(checks) and sum(w == "gba start" for w, _, _ in checks) >= 1
          and checks[-1][0] == "end" and all(r["replica_checks"] == checks for r in ranks),
          f"phase 18b: replica digests {checks}")

    kinds = r0["kinds"]
    by_kind = {}
    try_merge = {f_ for f_, _, _ in r0["multimap_ms"].get("try merge", [])}
    for k, (kind, n_sync, (n_coll, c_ms), m) in enumerate(zip(kinds, r0["syncs"],
                                                              r0["collectives"], r0["ms"])):
        if k in try_merge and kind not in ("init", "lost"):
            kind = f"{kind} + merge query"
        by_kind.setdefault(kind, []).append((n_sync, n_coll, c_ms, m))
    tracked = by_kind.get("tracked", [])
    check(tracked and {(n, c) for n, c, _, _ in tracked} == {(Tracker.HOST_SYNCS_PER_FRAME, 0)},
          "phase 18b: (host syncs, collectives) per tracked frame "
          f"{sorted({(n, c) for n, c, _, _ in tracked})}")
    chunk = [dv for _, _, dv in r0["multimap_ms"].get("gba/chunk", []) if dv is not None]
    chunk15 = [dv for _, _, dv in rep15.multimap_ms.get("gba/chunk", []) if dv is not None]
    print(f"phase 18b gates: map 0 stored at frame {f0} (phase 15 {f15}), merged with "
          f"{m0['n_kf_active']} keyframes at frame {m0['frame']} (phase 15 {m15['n_kf_active']} at "
          f"{m15['frame']}), |dATE| {d_ate:.6f} m < {DIST_ATE_TOL}; digests equal at "
          f"{[w for w, _, _ in checks]}; backend {launch.backend_for(dev, DIST_RANKS)}, ranks on "
          f"{[str(launch.rank_device(dev, r)) for r in range(DIST_RANKS)]}")
    print("phase 18b host waits per frame kind (rank 0; syncs seen by the sync-debug mode, "
          "collectives over the group, both summed): " + "; ".join(
              f"{kind} {len(v)} frames, syncs median {med([n for n, _, _, _ in v])} (max "
              f"{max(n for n, _, _, _ in v)}), collectives median {med([c for _, c, _, _ in v])} "
              f"(max {max(c for _, c, _, _ in v)}; median {med([x for _, _, x, _ in v]):.2f} ms "
              f"a frame), host waits median {med([n + c for n, c, _, _ in v])} (max "
              f"{max(n + c for n, c, _, _ in v)}), ms median {med([m for _, _, _, m in v]):.2f}"
              for kind, v in sorted(by_kind.items())))
    print(f"phase 18b GBA chunk device ms: median {med(chunk):.2f} over {len(chunk)} chunks "
          f"(phase 15, one device: {med(chunk15):.2f} over {len(chunk15)})")
    for i, r in enumerate(ranks):
        print(f"phase 18b rank {i}: B1 {sum(r['b1'])} launches, B2 {sum(r['b2'])}; collectives: "
              f"{_collective_line(r['collective_stats'])} [{card}]")
    launches = {"fast_nms": sum(sum(r["b2"]) for r in ranks),
                "hamming_top2": sum(sum(r["b1"]) for r in ranks)}
    return dict(ranks=ranks, launches=launches, wall_s=wall_s)


# Phase 20: the inertial Atlas. Config 3 (IMU_MONOCULAR, `EUROC_MONO_VI`, 200 Hz IMU) with
# place recognition and the Atlas on phase 15's 16 s lap, its lens covered for frames
# 100-209 (phase 15 covers 80-189: at frame 80 the port's map 0, started 11 frames after
# JAX's by the two-view draws (C16), holds 10 keyframes, and a map of 10 is reset, not
# stored): map 0's IMU initializes, the tracker spends 5 s RECENTLY_LOST on the IMU, map 0
# is stored, map 1 initializes its own IMU and is merged back through the inertial gate.
# The JAX System on the same lap on a CPU (`JAX_PLATFORMS=cpu python
# tests/jax_multimap_lap.py --mode mono-vi --t-loop 16 --frames 420 --track 360
# --blind-at 100 --blind-n 110`, 1926 s on 8 cores): map 0's IMU initialized at frame 64
# with 10 keyframes, map 0 stored at frame 205 with 19; map 1 from frame 212, its IMU at
# frame 252 with 10 keyframes; merged at frame 311 (keyframe 27 of the 28-keyframe map onto
# 1, imu_metric, s 0.953080, the rotation yaw only, the inertial weld over 16 keyframes, the
# 4-DoF graph); no frame lost after map 1's initialization; 2 GBA runs finished; SE3 ATE
# 0.067729 m, Sim3 0.055033 m, scale 0.982491 over the frames that are not blind. (All 420
# frames, 2025 s: the same events, SE3 ATE 0.067225 m.)
MMVI_FRAMES = 420
MMVI_TRACK = 360  # frames tracked: the merge and its GBA, without the lap's last 60 frames
MMVI_BLIND = (100, 110)  # frames 100-209: a uniform grey 35 image
MMVI_PREFIX = 20  # frames after the map's initialization in the kernels-vs-plain prefix
JAX_MMVI_IMU = ((64, 10), (252, 10))  # per map: (IMU init frame, its keyframes)
JAX_MMVI_STORED = (205, 19)  # frame, keyframes of the stored map
JAX_MMVI_MERGE = (311, 28, 27, 1)  # frame, keyframes of the active map, the keyframe pair
JAX_MMVI_S = 0.953080  # the merge's solved scale
JAX_MMVI_LOST = ()  # frames after map 1's initialization, not blind, that JAX's ended not OK
JAX_MMVI_ATE_SE3 = 0.067729
JAX_MMVI_ATE = 0.055033
JAX_MMVI_SCALE = 0.982491
MM_FLOATS = ("kf_R", "kf_t", "kf_vel", "kf_bias_g", "kf_bias_a", "mp_pos")


def _store_to(store, device):
    """A copy of a `MapStore` on `device` (host bookkeeping its own)."""
    c = _clone_store(store)
    c.state = type(store.state)(*(x.to(device) for x in c.state))
    c.device = torch.device(device)
    return c


def _merge_again(mm, m0: dict, device, samples=None) -> dict:
    """The merge at `m0` (captured by phase 20 before `_do_merge`) run again on
    copies of its two maps on `device` through `mm`: `_merge_sim3` (its
    RANSAC draws `samples` when given, else its own; the draws are kept),
    then from the lap's world Sim3 (as phase 15 does: a point 100 m out
    turns float32 rounding of the Sim3 into 1e-3 m) `merge_maps`, the weld
    fuse, and `_weld_and_distribute` (the weld BA, the essential graph) with
    the mapper's preintegrations copied and re-keyed as `_do_merge` re-keys
    them. The map after each stage is kept."""
    from orbslam3_tpu_torch.ops import imu as imu_ops
    from orbslam3_tpu_torch.ops import ransac
    from orbslam3_tpu_torch.pipeline import map_merging

    act, tgt = _store_to(m0["act"], device), _store_to(m0["tgt"], device)
    v0 = m0["verify"]
    draw, drawn = ransac._draw, []

    def recording(valid, n_hyp, k, generator, given):
        idx = draw(valid, n_hyp, k, generator,
                   given if samples is None else samples.to(valid.device))
        drawn.append(idx.clone())
        return idx

    ransac._draw = recording
    try:
        S = mm._merge_sim3(act, tgt, v0["kf"], v0["cand"])
    finally:
        ransac._draw = draw
    out = dict(S=S, v=dict(mm.last_verify), samples=drawn[0] if drawn else None)
    if S is None:
        return out
    kf_remap, _ = map_merging.merge_maps(tgt, act, m0["R"], m0["t"], m0["s"])
    mm._weld_fuse(tgt, list(kf_remap.values()), m0["pre"])
    stages = {"merge maps + weld fuse": _clone(tgt.state)}
    mapper = mm.system.mapper
    saved = mapper.preints
    mapper.preints = {kf_remap[k]: imu_ops.Preintegrated(*(x.to(device) for x in p))
                      for k, p in m0["preints"].items() if k in kf_remap}
    weld_ba = mapper._local_inertial_ba

    def snapshot(*a, **kw):
        weld_ba(*a, **kw)
        stages["weld BA"] = _clone(mapper.store.state)

    mapper._local_inertial_ba = snapshot
    try:
        mm._weld_and_distribute(tgt, kf_remap.get(m0["ref_kf"], max(kf_remap.values())))
    finally:
        mapper.preints = saved
        del mapper._local_inertial_ba
    stages["essential graph"] = tgt.state
    out.update(tgt=tgt, weld=dict(mm.last_weld), n_preints=len(kf_remap), stages=stages)
    return out


def _same_merge(a: dict, b: dict, what: str, points_tol: float = 1e-4) -> tuple:
    """Gate two runs of `_merge_again`: the same matches, Sim3 inliers and
    weld; the Sim3, and every pose, velocity and bias within 1e-4, every
    point within `points_tol`; `kf_mp` equal. Returns (Sim3 difference, the
    largest difference but the points', by stage {stage: {field: difference}})."""
    va, vb = a["v"], b["v"]
    check(a["S"] is not None and b["S"] is not None, f"{what}: the merge did not verify again")
    check(np.array_equal(va["valid"], vb["valid"])
          and np.array_equal(va["idx"][va["valid"]], vb["idx"][vb["valid"]])
          and va["sim3_inliers"] == vb["sim3_inliers"] and a["weld"] == b["weld"],
          f"{what}: matches {va['matches']} / {vb['matches']}, Sim3 inliers "
          f"{va['sim3_inliers']} / {vb['sim3_inliers']}, weld {a['weld']} / {b['weld']}")
    dS = max(float(np.abs(np.asarray(x) - np.asarray(y)).max()) for x, y in zip(a["S"], b["S"]))
    sa, sb = a["tgt"].state, b["tgt"].state
    check(torch.equal(sa.kf_mp.cpu(), sb.kf_mp.cpu()) and torch.equal(sa.mp_valid.cpu(),
                                                                         sb.mp_valid.cpu()),
          f"{what}: kf_mp rows or point validity differ")
    kf, mp = sa.kf_valid.cpu(), sa.mp_valid.cpu()
    by_stage = {}
    for stage, xa in a["stages"].items():
        xb = b["stages"][stage]
        by_stage[stage] = {f: float((getattr(xa, f).cpu()[mp if f == "mp_pos" else kf]
                                     - getattr(xb, f).cpu()[mp if f == "mp_pos" else kf])
                                    .abs().max()) for f in MM_FLOATS}
    end = by_stage["essential graph"]
    dW = max(v for f, v in end.items() if f != "mp_pos")
    check(dS <= 1e-4 and dW <= 1e-4 and end["mp_pos"] <= points_tol,
          f"{what}: Sim3 within {dS}, poses, velocities and biases within {dW}, points within "
          f"{end['mp_pos']} (tolerance {points_tol}); by stage {by_stage}")
    return dS, dW, by_stage


def _mmvi_kinds(rep, merge_frame: int, ms: list, captures: set) -> dict:
    """{frame kind: [(syncs, ms, frame)]}: blind frames, RECENTLY_LOST and LOST
    frames, the merging frame, a tracked frame that captured a pose solve's
    CUDA graph, and the other tracked frames split at their map's IMU
    initialization."""
    blind = range(MMVI_BLIND[0], sum(MMVI_BLIND))
    by_kind = {}
    for k, (kind, n_sync, m) in enumerate(zip(rep.frame_kinds(), rep.syncs, ms)):
        imu = next(x for x in reversed(rep.imu_maps) if x["first_frame"] <= k)
        if k in blind:
            kind = "blind"
        elif k == merge_frame:
            kind = "merge"
        elif rep.states[k] in ("RECENTLY_LOST", "LOST"):
            kind = rep.states[k].lower().replace("_", " ")
        elif kind == "tracked" and k in captures:
            kind = "tracked, graph captured"
        elif kind == "tracked":
            after = imu["init"] is not None and k > imu["init"]
            kind = "tracked after IMU init" if after else "tracked before IMU init"
        by_kind.setdefault(kind, []).append((n_sync, m, k))
    return by_kind


def _window_recorder(into: dict, n: int):
    """An `on_frame` that keeps each frame's associations and pose from the
    first OK frame ("start") through n frames after it, and the map's
    keyframe rows and points at the last of them."""
    def on_frame(k, slam):
        if "start" not in into and slam.tracking_state.name == "OK":
            into["start"] = k
        start = into.get("start")
        if start is None or k > start + n:
            return
        f = slam.tracker.last_frame
        into.setdefault("frames", []).append((f.mp_assoc.copy(), np.array(f.R), np.array(f.t)))
        if k == start + n:
            s = slam.store.state
            into["map"] = {name: getattr(s, name).cpu().numpy() for name in (
                "kf_valid", "kf_ur", "kf_mp", "kf_R", "kf_t", "mp_valid", "mp_pos")}
    return on_frame


def phase20_inertial_multimap(dev, card: str) -> dict:
    """Phase 20: the inertial Atlas (`entry.replay(cuda, "mono_vi", MMVI_FRAMES,
    vocabulary=VOC_100K, t_loop=MM_T_LOOP, multimap=True, blind=MMVI_BLIND,
    n_track=MMVI_TRACK)`)
    with the gates and lines of the module docstring. Returns the kernels'
    launches on the main path and the B1 calls by site."""
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch import spans
    from orbslam3_tpu_torch.ops import _build, cuda_fast, cuda_match
    from orbslam3_tpu_torch.ops import imu as imu_ops
    from orbslam3_tpu_torch.optim import graphed
    from orbslam3_tpu_torch.pipeline import multimap as mm_mod
    from orbslam3_tpu_torch.pipeline.tracking import Tracker

    frame = [0]
    found, extra_ms, gba_at_merge = {}, {}, []
    orig_do_merge = mm_mod.MultiMapManager._do_merge
    rec_k = {}
    window = _window_recorder(rec_k, MMVI_PREFIX)
    captures, graph_run = set(), graphed.run

    def run_graph(*a, **kw):
        n = graphed.CAPTURES
        out = graph_run(*a, **kw)
        if graphed.CAPTURES > n and spans._active is not None:
            captures.add(spans._active.frame)
        return out

    def do_merge(self, act, target, R, t, s):
        if "merge" not in found:  # copies of both maps for the re-runs
            sysm = self.system
            with _comparing() as took:
                found["merge"] = dict(
                    act=_clone_store(act), tgt=_clone_store(target), R=R, t=t, s=s,
                    verify=dict(self.last_verify), frame=frame[0], ref_kf=sysm.tracker.ref_kf,
                    imu_ready=sysm.tracker.imu_ready,
                    pre=target.state.mp_valid.cpu().numpy().copy(),
                    preints={k: imu_ops.Preintegrated(*(x.clone() for x in p))
                             for k, p in sysm.mapper.preints.items()})
            extra_ms[frame[0]] = extra_ms.get(frame[0], 0.0) + took[0]
        out = orig_do_merge(self, act, target, R, t, s)
        gba_at_merge.append(self.system.loop_closer.gba_async.n_finished)
        return out

    preds, pred_err = {}, {}  # the IMU prediction of each frame; its distance from the result
    imu_predict = Tracker._imu_predict

    def predicted(self, last):
        out = imu_predict(self, last)
        preds[frame[0]] = out
        return out

    def on_frame(k, slam):
        frame[0] = k + 1
        window(k, slam)
        f = slam.tracker.last_frame
        if k in preds and slam.tracking_state.name == "OK" and f is not None:
            (Rp, tp, _), R, t = preds[k], np.asarray(f.R), np.asarray(f.t)
            pred_err[k] = float(np.linalg.norm(Rp.T @ tp - R.T @ t))

    torch.cuda.synchronize()
    cuda_fast.LAUNCHES = 0
    cuda_match.LAUNCHES = 0
    t0 = time.perf_counter()
    mm_mod.MultiMapManager._do_merge = do_merge
    graphed.run = run_graph
    Tracker._imu_predict = predicted
    try:
        with _b1_calls([], keep_args=False) as calls, _graph_watch([]) as graphs:
            rep = E.replay(dev, "mono_vi", MMVI_FRAMES, vocabulary=VOC_100K, t_loop=MM_T_LOOP,
                           multimap=True, blind=MMVI_BLIND, on_frame=on_frame,
                           n_track=MMVI_TRACK)
    finally:
        mm_mod.MultiMapManager._do_merge = orig_do_merge
        graphed.run = graph_run
        Tracker._imu_predict = imu_predict
    wall_s = time.perf_counter() - t0
    sites = {site: sum(c[0] == site for c in calls)
             for site in (list(B1_SITES.values()) + list(B1_PR_SITES.values())
                          + list(B1_MM_SITES.values()) + ["comparison", "other"])}
    launches = {"fast_nms": cuda_fast.LAUNCHES,
                "hamming_top2": cuda_match.LAUNCHES - sites["comparison"]}
    check(sum(sites.values()) == cuda_match.LAUNCHES and sites["other"] == 0,
          f"phase 20 B1 calls by site {sites}")
    sysm = rep.system
    mm = sysm.multimap
    states = rep.states
    print(f"phase 20 outcome: stored {rep.stored}; merges "
          f"{[{k: v for k, v in m.items() if k not in ('R', 't')} for m in rep.merges]}; IMU "
          f"per map {rep.imu_maps}; maps at the end {mm.atlas.n_maps}, {rep.n_kf} keyframes, "
          f"{rep.n_mp} points; GBA {rep.gba_finished} finished, {rep.gba_aborted} aborted; SE3 "
          f"ATE {rep.ate_se3:.6f} m, Sim3 ATE {rep.ate:.6f} m, scale {rep.scale:.5f}; states "
          f"{ {x: states.count(x) for x in sorted(set(states))} }", flush=True)
    # Gates: the stages of both maps, the store, the merge.
    check(len(rep.imu_maps) >= 2 and len(rep.stored) >= 1,
          f"phase 20: maps {rep.imu_maps}, stored {rep.stored}")
    for i, (m, (jf, jk)) in enumerate(zip(rep.imu_maps, JAX_MMVI_IMU)):
        check(m["init_kfs"] is not None and abs(m["init_kfs"] - jk) <= 2,
              f"phase 20: map {i}'s IMU initialized with {m['init_kfs']} keyframes at frame "
              f"{m['init']}, JAX {jk} at {jf}")
    st0 = rep.stored[0]
    check(abs(st0["frame"] - JAX_MMVI_STORED[0]) <= 2 and rep.n_maps[st0["frame"]] == 2,
          f"phase 20: map 0 stored at frame {st0['frame']}, JAX {JAX_MMVI_STORED}")
    check(len(rep.merges) >= 1, f"phase 20: no merge: states {states[185:]}")
    mg = rep.merges[0]
    log_R = mg["log_R"]
    check(abs(mg["n_kf_active"] - JAX_MMVI_MERGE[1]) <= 2 and rep.n_maps[mg["frame"]] == 1,
          f"phase 20: merge at frame {mg['frame']} with {mg['n_kf_active']} keyframes in the "
          f"active map, JAX {JAX_MMVI_MERGE}")
    check(mg["imu_metric"] and 0.9 < mg["s"] < 1.1 and abs(log_R[0]) < 1e-6
          and abs(log_R[1]) < 1e-6, f"phase 20: the merge's gate: imu_metric "
          f"{mg['imu_metric']}, s {mg['s']}, log R {log_R}")
    check(mg["weld"] == "inertial" and mg["weld_window"] == 16 and mg["dof4"],
          f"phase 20: weld {mg['weld']} over {mg['weld_window']}, dof4 {mg['dof4']}")
    check(rep.gba_finished > gba_at_merge[0], f"phase 20: the post-merge GBA did not finish "
          f"({rep.gba_finished} finished, {gba_at_merge[0]} before the merge)")
    blind = set(range(MMVI_BLIND[0], sum(MMVI_BLIND)))
    map1_ok = next(k for k in range(st0["frame"] + 1, MMVI_TRACK) if states[k] == "OK")
    bad = [k for k in range(map1_ok, MMVI_TRACK)
           if states[k] != "OK" and k not in blind and k not in JAX_MMVI_LOST]
    check(not bad, f"phase 20: frames not OK after map 1's initialization (frame {map1_ok}) "
          f"that JAX tracked: {bad} ({[states[k] for k in bad]})")
    shares = []
    ends = [MMVI_BLIND[0], MMVI_TRACK]
    for i, m in enumerate(rep.imu_maps[:2]):
        after = [k for k in range(m["init"] + 1, ends[i]) if states[k] == "OK"]
        shares.append((sum(rep.pi_taken[k] for k in after) / max(len(after), 1), len(after)))
        check(after and shares[-1][0] >= 0.8, f"phase 20: map {i}: the pose-inertial result "
              f"taken on {shares[-1][0]:.4f} of {len(after)} frames after its IMU initialization")
    gates = dict(se3=max(2 * JAX_MMVI_ATE_SE3, 0.01), sim3=max(2 * JAX_MMVI_ATE, 0.01),
                 scale=max(2 * abs(1 - JAX_MMVI_SCALE), 0.02))
    check(np.isfinite(rep.pos).all() and rep.ate_se3 <= gates["se3"]
          and rep.ate <= gates["sim3"] and abs(rep.scale - 1) <= gates["scale"],
          f"phase 20: SE3 ATE {rep.ate_se3}, Sim3 ATE {rep.ate}, scale {rep.scale} outside "
          f"{gates}")
    for g in graphs:  # the graph watch's reads are not the frame's
        if g["frame"] is not None:
            extra_ms[g["frame"]] = extra_ms.get(g["frame"], 0.0) + g["took"]
    ms = [m - extra_ms.get(k, 0.0) for k, m in enumerate(rep.ms)]
    by_kind = _mmvi_kinds(rep, mg["frame"], ms, captures)
    _check_tracked_syncs(by_kind, {"tracked before IMU init": Tracker.HOST_SYNCS_PER_FRAME,
                                   "tracked after IMU init": Tracker.HOST_SYNCS_PER_INERTIAL_FRAME},
                         calls, "phase 20")
    check(launches["fast_nms"] == MMVI_TRACK and all(n == 1 for n in rep.b2),
          f"phase 20: B2 launches {launches['fast_nms']}, per frame {sorted(set(rep.b2))}")
    for site in B1_MM_SITES.values():
        check(sites[site] > 0, f"phase 20: B1 never launched at {site}: {sites}")

    # The merge again at its keyframe: kernels against plain, then the card against the CPU.
    m0 = found["merge"]
    with _comparing():
        run_k = _merge_again(mm, m0, dev)
        with _build.force_plain():
            run_p = _merge_again(mm, m0, dev)
    dS_kp, dW_kp, st_kp = _same_merge(run_k, run_p, "phase 20 merge, kernels vs plain")
    dW_kp = max(dW_kp, st_kp["essential graph"]["mp_pos"])
    dS0 = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
              for a, b in zip(run_k["S"], (m0["R"], m0["t"], m0["s"])))
    check(dS0 <= 1e-4, f"phase 20 merge: the Sim3 again {dS0} from the lap's")
    cpu = torch.device("cpu")
    cpu_sys = E.make_system(cpu, "mono_vi")
    cpu_sys.tracker.imu_ready = m0["imu_ready"]
    cpu_sys.mapper.imu_init.initialized = True
    cpu_mm = mm_mod.MultiMapManager(cpu_sys, mm.voc)
    # The CPU at its threads and at one: the points of a float32 solve of this window move by
    # their conditioning (a far point seen from keyframes close together), so the two CPU
    # runs set the points' tolerance (fault C19), and the rest holds to 1e-4.
    n_threads = torch.get_num_threads()
    runs_c = {}
    for threads in (max(n_threads, 2), 1):
        torch.set_num_threads(threads)
        t1 = time.perf_counter()
        runs_c[threads] = (_merge_again(cpu_mm, m0, cpu, samples=run_k["samples"]),
                           time.perf_counter() - t1)
    torch.set_num_threads(n_threads)
    (run_c, cpu_s), (run_c1, cpu1_s) = runs_c.values()
    _, dW_cc, st_cc = _same_merge(run_c, run_c1, "phase 20 merge, CPU vs CPU", points_tol=1.0)
    spread = st_cc["essential graph"]["mp_pos"]
    dS_kc, dW_kc, st_kc = _same_merge(run_k, run_c, "phase 20 merge, card vs CPU",
                                      points_tol=max(1e-4, 2 * spread))

    # A prefix through the kernels against the same through the plain versions: from the
    # map's initialization through MMVI_PREFIX frames after it.
    rec_p = {}
    start = rec_k["start"]
    with _build.force_plain():
        pre_p = E.replay(dev, "mono_vi", MMVI_FRAMES, vocabulary=VOC_100K, t_loop=MM_T_LOOP,
                         multimap=True, blind=MMVI_BLIND, n_track=start + MMVI_PREFIX + 1,
                         on_frame=_window_recorder(rec_p, MMVI_PREFIX))
    check(pre_p.states == states[:start + MMVI_PREFIX + 1] and rec_p.get("start") == start,
          f"phase 20 prefix: states {pre_p.states} vs {states[:start + MMVI_PREFIX + 1]}")
    line = _same_prefix(rec_k, rec_p, states[start:], pre_p.states[start:], "phase 20 prefix")

    med = lambda xs: statistics.median(xs) if xs else float("nan")  # noqa: E731
    spans_ms = rep.multimap_ms
    print(f"phase 20 inertial lap: the first {MMVI_TRACK} of {MMVI_FRAMES} frames of config 3 "
          f"with a {MM_T_LOOP:g} s lap, "
          f"frames {MMVI_BLIND[0]}-{sum(MMVI_BLIND) - 1} blind, 200 Hz IMU; launches {launches}; "
          f"{MMVI_TRACK / (sum(ms) / 1e3):.2f} frames/s over the replay ({wall_s:.1f} s wall, "
          f"{rep.render_s:.1f} s of rendering) [{card}]")
    print(f"phase 20 map 0: IMU initialized at frame {rep.imu_maps[0]['init']} with "
          f"{rep.imu_maps[0]['init_kfs']} keyframes (JAX {JAX_MMVI_IMU[0]}), stored at frame "
          f"{st0['frame']} with {st0['n_kf']} keyframes (JAX {JAX_MMVI_STORED}); map 1 from "
          f"frame {map1_ok}: IMU initialized at frame {rep.imu_maps[1]['init']} with "
          f"{rep.imu_maps[1]['init_kfs']} keyframes (JAX {JAX_MMVI_IMU[1]}); merged at frame "
          f"{mg['frame']}: keyframe {mg['kf']} of the {mg['n_kf_active']}-keyframe map onto "
          f"{mg['cand']} (JAX {JAX_MMVI_MERGE}), imu_metric {mg['imu_metric']}, s {mg['s']:.6f} "
          f"(JAX {JAX_MMVI_S}), gated rotation log {[round(x, 8) for x in log_R]}, weld "
          f"{mg['weld']} BA over {mg['weld_window']} keyframes, essential graph dof4 "
          f"{mg['dof4']}; {mg['n_kf']} keyframes after it; GBA {rep.gba_finished} finished")
    print(f"phase 20 gates: pose-inertial result taken on {shares} (share, frames) after each "
          f"map's IMU initialization; SE3 ATE {rep.ate_se3:.6f} m (gate {gates['se3']:.6f}: 2 x "
          f"JAX's {JAX_MMVI_ATE_SE3}), Sim3 ATE {rep.ate:.6f} m (gate {gates['sim3']:.6f}), scale "
          f"{rep.scale:.5f} (tolerance {gates['scale']:.4f}); frames not OK after map 1's "
          f"initialization outside the blind interval: "
          f"{[k for k in range(map1_ok, MMVI_TRACK) if states[k] != 'OK' and k not in blind]} "
          f"(JAX {list(JAX_MMVI_LOST)})")
    print(f"phase 20 host syncs and ms per frame kind: {_kind_line(by_kind)} [{card}]")
    print(f"phase 20 merging frame {mg['frame']} ({ms[mg['frame']]:.2f} ms, host clock; "
          f"{rep.syncs[mg['frame']]} syncs): " + "; ".join(
              f"{name[len('merge: '):]} host {h:.2f} / device {dv:.2f} ms"
              for name in ("merge: merge maps", "merge: weld fuse", "merge: weld BA",
                           "merge: essential graph", "merge: GBA start")
              for f_, h, dv in spans_ms.get(name, []) if f_ == mg["frame"]) + f" [{card}]")
    tm = spans_ms.get("try merge", [])
    print(f"phase 20 try merge: {len(tm)} calls, host ms median {med([h for _, h, _ in tm]):.2f}"
          f", device ms median {med([d for _, _, d in tm if d is not None]):.2f} [{card}]")
    print(f"phase 20 merge again at keyframe {m0['verify']['kf']} onto {m0['verify']['cand']}: "
          f"kernels vs plain: {run_k['v']['matches']} matches equal, "
          f"{run_k['v']['sim3_inliers']} Sim3 inliers, Sim3 within {dS_kp:.1e} (the lap's within "
          f"{dS0:.1e}), {run_k['n_preints']} keyframes migrated, weld {run_k['weld']}, kf_mp "
          f"equal, poses, velocities, biases and points within {dW_kp:.1e}; card vs CPU "
          f"({cpu_s:.1f} s on the CPU at {max(n_threads, 2)} threads): Sim3 within {dS_kc:.1e}, "
          f"poses, velocities and biases within {dW_kc:.1e}, points within "
          f"{st_kc['essential graph']['mp_pos']:.1e} (by stage "
          f"{[(k, round(v['mp_pos'], 7)) for k, v in st_kc.items()]}); the CPU at 1 thread "
          f"({cpu1_s:.1f} s) against it: poses, velocities and biases within {dW_cc:.1e}, points "
          f"within {spread:.1e} (by stage {[(k, round(v['mp_pos'], 7)) for k, v in st_cc.items()]}"
          f"), so the card's points are held within max(1e-4, 2 x {spread:.1e})")
    nxt = mg["frame"] + 1
    after = {k: e for k, e in pred_err.items() if k > rep.imu_maps[1]["init"] and k != nxt}
    worst = sorted(after.items(), key=lambda x: -x[1])[:3]
    print(f"phase 20 IMU prediction against the tracked camera centre (fault C20): the frame "
          f"after the merge {pred_err.get(nxt, float('nan')):.6f} m; the other tracked frames "
          f"after map 1's IMU initialization median {med(list(after.values())):.6f} m, the "
          f"largest (frame, m) {[(k, round(e, 4)) for k, e in worst]}; loop closures at frames "
          f"{[lp['frame'] for lp in rep.loops]}")
    for g in graphs:
        print(f"phase 20 essential graph at frame {g['frame']} (dof4 {g['dof4']}, turned about "
              f"the world's z axis, fault C22): largest keyframe rotation change {g['turn']:.6f} "
              f"rad ({np.degrees(g['turn']):.4f} deg), largest |R_new z - R_old z| "
              f"{g['gravity']:.2e}")
    print(f"phase 20 kernels vs plain prefix: {line}")
    print(f"phase 20 launches on the main path {launches}; B1 by site {sites}")
    return dict(rep=rep, launches=launches, sites=sites)


# Phase 21: config 3 through the runner at its defaults (asynchronous mapping,
# place recognition with the 97k-word vocabulary, the Atlas; Kmax 256, Pmax
# 16384) on phase 10's 8 s lap (the sequence phase 16 writes, with its IMU),
# which closes an inertial loop. The JAX runner on the same files on a CPU
# (`python tests/jax_runner_lap.py --seq DIR --frames 260 --t-loop 8 --mode
# mono-vi --kmax 256 --pmax 16384 --c13`, 1338 s on 8 shared cores): the map
# initialized at frame 1, the IMU in the tick of frame 48 with 10 keyframes,
# VIBA1 at 107 with 21, no VIBA2; the loop closed in frame 175's tick, keyframe
# 32 onto 2 with 33 keyframes, Sim3 scale 1; its GBA (dense path) finished in
# frame 179's tick, none aborted; every frame OK after the initialization, 49
# keyframes; SE3 ATE 0.055742 m, Sim3 0.036147 m, scale 1.017502. Its graph is
# the unrepaired 4-DoF one (fault C22) and its loop leaves the velocities
# (C20): the IMU prediction on the frame after the loop's tick 0.075186 m and
# after the GBA's finish 0.026673 m from the tracked centre, against a median
# of 1.23e-05 m over the other frames after the IMU initialization. So the
# phase gates outcomes, not poses.
N21 = SEQ16_FRAMES
JAX_VI_LAP = dict(imu_init_frame=48, imu_init_kfs=10, viba1_frame=107, viba1_kfs=21,
                  loop=dict(frame=175, kf=32, loop_kf=2, n_kf=33, scale=1.0, gba_finish=179),
                  ate_se3=0.055742, ate_sim3=0.036147, scale=1.017502,
                  c20=dict(after={"loop 1": 0.075186, "GBA 1": 0.026673}, median=1.23e-05))
# The parent checkout (a516a17, before the C20 and C22 repairs of the loop) on
# the same files, on the card: the frame after the loop's tick and after the
# GBA's finish, m (`tests/c20_runner.py --seq DIR --frames 260 --t-loop 8
# --repo PARENT`; PERF.md).
PARENT_C20 = {"loop 1": 0.001719, "GBA 1": 0.027099}
YAW_RESIDUAL_MIN = 1e-3  # rad: a loop edge residual above it must at least halve
GRAVITY_TOL = 1e-4  # |R_new z - R_old z| per corrected keyframe


@contextlib.contextmanager
def _graph_watch(into: list):
    """Within the block, every `solve_pose_graph` call appends dict(frame,
    dof4, turn: the largest rotation change (rad) over the free vertices,
    gravity: the largest |R_new z - R_old z| over them, edge: the last edge
    (i, j), residual_before / residual_after: the angle (rad) of that edge's
    M^-1 S_j S_i^-1 rotation at the graph's input and output, and took: the
    ms of those reads, which are not counted as the run's host syncs)."""
    from orbslam3_tpu_torch import spans
    from orbslam3_tpu_torch.optim import pose_graph as pg

    solve = pg.solve_pose_graph

    def angle(R):
        return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)))

    def watched(g, *a, **kw):
        out = solve(g, *a, **kw)
        with _comparing() as took:
            R0 = g.R.cpu().double().numpy()
            R1 = out[0].cpu().double().numpy()
            free = ~g.fixed.cpu().numpy()
            i, j = int(g.edge_i[-1]), int(g.edge_j[-1])
            Rm = g.edge_R[-1].cpu().double().numpy()
        z = np.asarray([0.0, 0.0, 1.0])
        into.append(dict(
            frame=None if spans._active is None else spans._active.frame,
            dof4=bool(kw.get("dof4", False)),
            turn=max((angle(R1[k] @ R0[k].T) for k in np.flatnonzero(free)), default=0.0),
            gravity=float(np.abs(R1[free] @ z - R0[free] @ z).max()) if free.any() else 0.0,
            edge=(i, j), residual_before=angle(Rm.T @ R0[j] @ R0[i].T),
            residual_after=angle(Rm.T @ R1[j] @ R1[i].T), took=took[0]))
        return out

    pg.solve_pose_graph = watched
    try:
        yield into
    finally:
        pg.solve_pose_graph = solve


def _correct_again(lc, cap: dict, device) -> dict:
    """The loop correction captured by phase 21 (`cap`: the map before it,
    the loop edges so far, the closing pair and its Sim3) run again on a copy
    of the map on `device` by a closer like `lc` (no GBA, no mapper). The
    state after the graph and the point correction, and after SearchAndFuse."""
    from orbslam3_tpu_torch.pipeline.loop_closing import LoopCloser

    store = _store_to(cap["store"], device)

    def to(x):
        return None if x is None else x.to(device)

    c = LoopCloser(lc.model, to(lc.params), store, None, to(lc.sigma2_table), run_gba=False,
                   inertial=lc.inertial, img_wh=to(lc.img_wh), scale_table=to(lc.scale_table),
                   bf=lc.bf)
    c.loop_edges = list(cap["loop_edges"])
    stages = {}
    fuse = c._search_and_fuse

    def snapshot(*a, **kw):
        stages["graph + points"] = _clone(store.state)
        return fuse(*a, **kw)

    c._search_and_fuse = snapshot
    c._correct_loop(*cap["args"])
    stages["search and fuse"] = store.state
    return stages


LOOP_FLOATS = ("kf_R", "kf_t", "kf_vel", "mp_pos")


def _same_correction(a: dict, b: dict, what: str, points_tol: float) -> dict:
    """Gate two states of `_correct_again` (or the lap's) stage by stage:
    `kf_mp` and point validity equal, poses and velocities within 1e-4,
    points within `points_tol`. Returns {stage: {field: difference}}."""
    out = {}
    for stage, xa in a.items():
        xb = b[stage]
        kf, mp = xa.kf_valid.cpu(), xa.mp_valid.cpu()
        check(torch.equal(xa.kf_mp.cpu(), xb.kf_mp.cpu())
              and torch.equal(xa.mp_valid.cpu(), xb.mp_valid.cpu()),
              f"{what}: kf_mp rows or point validity differ after {stage}")
        out[stage] = {f: float((getattr(xa, f).cpu()[mp if f == "mp_pos" else kf]
                                - getattr(xb, f).cpu()[mp if f == "mp_pos" else kf])
                               .abs().max()) for f in LOOP_FLOATS}
    end = out["search and fuse"]
    dW = max(v for f, v in end.items() if f != "mp_pos")
    check(dW <= 1e-4 and end["mp_pos"] <= points_tol, f"{what}: poses and velocities within "
          f"{dW}, points within {end['mp_pos']} (tolerance {points_tol}); by stage {out}")
    return out


def phase21_inertial_loop(dev, card: str, lap: str | None = None) -> dict:
    """Phase 21: config 3 through the runner at its defaults on phase 10's 8 s
    lap (at `lap` when phase 16 wrote it there), which closes an inertial
    loop; gates and lines in the module docstring. Returns the launches of
    the runner's run."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="_chip_smoke_seq_21_", dir=root) as tmp:
        return _phase21_in(dev, card, lap or os.path.join(tmp, "lap"), tmp)


def _phase21_in(dev, card: str, seq: str, tmp: str) -> dict:
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch.ate import ate_rmse, ate_scale
    from orbslam3_tpu_torch.io import datasets
    from orbslam3_tpu_torch.ops import _build
    from orbslam3_tpu_torch.pipeline import loop_closing as lc_mod
    from orbslam3_tpu_torch.pipeline.tracking import Tracker

    jx = JAX_VI_LAP
    _lap_sequence(seq, "phase 21")
    closures, found, extra_ms = [], {}, {}
    correct = lc_mod.LoopCloser._correct_loop

    def watched(self, kf_id, loop_kf, R21, t21, s21):
        from orbslam3_tpu_torch import spans

        k = spans._active.frame
        closures.append(dict(frame=k, kf=int(kf_id), loop_kf=int(loop_kf),
                             n_kf=int(self.store.n_kf), scale=float(s21)))
        if "cap" not in found:  # the closing pair again, and the correction's inputs
            runs = {}
            with _comparing() as took:
                for mode in ("kernels", "plain"):
                    with _build.force_plain() if mode == "plain" else contextlib.nullcontext():
                        out = self._verify_sim3_impl(kf_id, loop_kf)
                    runs[mode] = (out, dict(self.last_verify))
                found["cap"] = dict(store=_store_to(self.store, "cpu"),
                                    loop_edges=list(self.loop_edges),
                                    args=(kf_id, loop_kf, R21, t21, s21), frame=k)
            found["verify"] = runs
            extra_ms[k] = extra_ms.get(k, 0.0) + took[0]
        out = correct(self, kf_id, loop_kf, R21, t21, s21)
        if "lap" not in found:
            with _comparing() as took:
                found["lap"] = _clone(self.store.state)
            extra_ms[k] = extra_ms.get(k, 0.0) + took[0]
        return out

    out, kf_out = os.path.join(tmp, "lap_vi.txt"), os.path.join(tmp, "lap_vi_kf.txt")
    argv = [os.path.join(seq, "settings.yaml"), seq, "--dataset", "euroc", "--mode", "mono-vi",
            "--out", out, "--kf-out", kf_out, "--kmax", str(RUNNER_KMAX), "--pmax",
            str(RUNNER_PMAX)]
    lc_mod.LoopCloser._correct_loop = watched
    try:
        with _stage_syncs({}) as stage_syncs, _graph_watch([]) as graphs:
            res, rows, launches, sites, _, calls = _run_runner(argv)
    finally:
        lc_mod.LoopCloser._correct_loop = correct
    for g in graphs:
        if g["frame"] is not None:
            extra_ms[g["frame"]] = extra_ms.get(g["frame"], 0.0) + g["took"]
    for k, m in extra_ms.items():  # the re-runs and reads above are not the frame's
        res["frame_ms"][k] -= m
    slam, summ = res["system"], {k: v for k, v in res.items() if k not in ("system", "spans")}
    states = [r.state for r in rows]
    first_ok = states.index("OK") if "OK" in states else None
    stages = E.imu_stage_frames(rows)
    events = E.map_event_frames(rows)
    init, viba1 = stages.get("imu_init"), stages.get("viba1")
    init_kfs = rows[init].n_kf if init is not None else None
    viba1_kfs = rows[viba1].n_kf if viba1 is not None else None
    gt = datasets.load_groundtruth_euroc(seq)
    ts, pos = slam.get_trajectory()
    ate_se3 = ate_rmse(ts, pos, gt[0], gt[1], with_scale=False)
    ate_sim3 = ate_rmse(ts, pos, gt[0], gt[1], with_scale=True)
    scale = ate_scale(ts, pos, gt[0], gt[1])
    loop_graphs = [g for g in graphs if g["dof4"]]
    after = [k for k in range(init + 1, N21) if states[k] == "OK"] if init is not None else []
    share = sum(rows[k].pi_taken for k in after) / max(len(after), 1)
    lp = closures[0] if closures else None
    after_loop = ([k for k in range(lp["frame"] + 1, N21) if states[k] == "OK"]
                  if lp is not None else [])
    share_loop = sum(rows[k].pi_taken for k in after_loop) / max(len(after_loop), 1)
    gba_done = [k for name, k in events.items() if name.startswith("GBA")]
    print(f"phase 21 outcome (the runner at its defaults: {summ['mapping']} mapping, place "
          f"recognition, the Atlas): map initialized at frame {first_ok}, IMU at frame {init} with "
          f"{init_kfs} keyframes (JAX runner {jx['imu_init_frame']}, {jx['imu_init_kfs']}), VIBA1 "
          f"at frame {viba1} with {viba1_kfs} (JAX {jx['viba1_frame']}, {jx['viba1_kfs']}); loops "
          f"{[(c['frame'], c['kf'], c['loop_kf'], c['n_kf'], c['scale']) for c in closures]} "
          f"(frame, keyframe, loop keyframe, keyframes, Sim3 scale; JAX {jx['loop']}); GBA "
          f"finished at frames {gba_done} ({summ['gba_finished']} finished, {summ['gba_aborted']} "
          f"aborted, {summ['gba_path']} path); {summ['n_kf']} keyframes; SE3 ATE {ate_se3:.6f} m "
          f"(JAX {jx['ate_se3']}), Sim3 ATE {ate_sim3:.6f} m (JAX {jx['ate_sim3']}), scale "
          f"{scale:.5f} (JAX {jx['scale']}); pose-inertial result on {share:.4f} of {len(after)} "
          f"frames after the IMU initialization, {share_loop:.4f} of {len(after_loop)} after the "
          f"loop's tick; states { {x: states.count(x) for x in sorted(set(states))} }", flush=True)
    for g in graphs:
        print(f"phase 21 essential graph at frame {g['frame']} (dof4 {g['dof4']}): loop edge "
              f"{g['edge']} rotation residual {g['residual_before']:.6f} -> "
              f"{g['residual_after']:.6f} rad, largest keyframe rotation change {g['turn']:.6f} "
              f"rad ({np.degrees(g['turn']):.4f} deg), largest |R_new z - R_old z| "
              f"{g['gravity']:.2e}")
    check(summ["mapping"] == "asynchronous" and summ["mapper_idle"],
          f"phase 21: mapping {summ['mapping']}, idle after shutdown {summ['mapper_idle']}")
    check(first_ok is not None and all(x == "OK" for x in states[first_ok:]),
          "phase 21: a frame not OK after the map's initialization")
    check(init_kfs is not None and abs(init_kfs - jx["imu_init_kfs"]) <= 2,
          f"phase 21: IMU initialized with {init_kfs} keyframes, JAX {jx['imu_init_kfs']}")
    check(viba1_kfs is not None and abs(viba1_kfs - jx["viba1_kfs"]) <= 2,
          f"phase 21: VIBA1 with {viba1_kfs} keyframes, JAX {jx['viba1_kfs']}")
    check(lp is not None and abs(lp["n_kf"] - jx["loop"]["n_kf"]) <= 2,
          f"phase 21: first loop {lp}, JAX's with {jx['loop']['n_kf']} keyframes")
    check(all(c["scale"] == 1.0 for c in closures), f"phase 21: a Sim3 scale not 1: {closures}")
    check(len(loop_graphs) >= len(closures), f"phase 21: {len(loop_graphs)} 4-DoF graphs for "
          f"{len(closures)} loops: {graphs}")
    for g in loop_graphs:
        check(g["gravity"] <= GRAVITY_TOL, f"phase 21: a corrected keyframe's R z moved "
              f"{g['gravity']} (gate {GRAVITY_TOL})")
        check(g["residual_before"] <= YAW_RESIDUAL_MIN
              or g["residual_after"] <= g["residual_before"] / 2,
              f"phase 21: the loop edge's rotation residual {g['residual_before']} -> "
              f"{g['residual_after']} rad did not halve (fault C22)")
    check(gba_done and gba_done[0] > lp["frame"], f"phase 21: no GBA finished after the loop: "
          f"{events}")
    check(after and share >= 0.8 and after_loop and share_loop >= 0.8,
          f"phase 21: pose-inertial result on {share:.4f} after the IMU initialization, "
          f"{share_loop:.4f} after the loop's tick")
    gate = max(2 * jx["ate_se3"], 0.01)
    check(np.isfinite(pos).all() and ate_se3 <= gate, f"phase 21: SE3 ATE {ate_se3} above {gate}")
    _vi_runner_lines(summ, rows, {**stages, **events}, stage_syncs, calls,
                     Tracker.HOST_SYNCS_PER_FRAME, Tracker.HOST_SYNCS_PER_INERTIAL_FRAME,
                     "phase 21", card, None)
    c20 = _c20_line(rows, "phase 21", jx)
    e_loop = c20["after"].get("loop 1")
    print(f"phase 21 C20 on the frame after the loop's tick: {e_loop} m, after the GBA's finish "
          f"{c20['after'].get('GBA 1')} m (the unrepaired JAX runner {jx['c20']['after']}; the "
          f"parent checkout {PARENT_C20} on the same files); gate: under {C20_FACTOR:g} x the "
          f"median {c20['median']} or {C20_FLOOR} m")
    check(e_loop is not None and not c20["shows"],
          f"phase 21: the IMU prediction after {c20['shows']} (fault C20): {c20['after']}")
    spans_ = res["spans"]
    for name in ("loop: verify Sim3", "loop: essential graph", "loop: correct points",
                 "loop: search and fuse", "gba/chunk"):
        v = spans_.get(name, [])
        check(v, f"phase 21: no span {name!r}")
        top = [(f, round(h, 2), None if d is None else round(d, 2))
               for f, h, d in sorted(v, key=lambda x: -x[1])[:6]]
        print(f"phase 21 {name}: {len(v)} calls, host ms median "
              f"{statistics.median([h for _, h, _ in v]):.2f}; the longest (frame, host ms, "
              f"device ms) {top} [{card}]")

    # The closing pair's verification through the kernels and the plain versions (exact), and
    # the correction again on the CPU at its threads and at one from the captured inputs.
    (S_k, st_k), (S_p, st_p) = found["verify"]["kernels"], found["verify"]["plain"]
    check(S_k is not None and S_p is not None and st_k == st_p
          and all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(S_k, S_p)),
          f"phase 21 verify at the closing pair, kernels vs plain: {st_k} vs {st_p}, {S_k} vs "
          f"{S_p}")
    cap = found["cap"]
    lc = slam.loop_closer
    n_threads = torch.get_num_threads()
    runs_c, secs = {}, {}
    for threads in (max(n_threads, 2), 1):
        torch.set_num_threads(threads)
        t2 = time.perf_counter()
        runs_c[threads] = _correct_again(lc, cap, torch.device("cpu"))
        secs[threads] = time.perf_counter() - t2
    torch.set_num_threads(n_threads)
    run_c, run_c1 = runs_c.values()
    st_cc = _same_correction(run_c, run_c1, "phase 21 correction, CPU vs CPU", points_tol=1.0)
    spread = st_cc["search and fuse"]["mp_pos"]
    st_kc = _same_correction({"search and fuse": found["lap"]},
                             {"search and fuse": run_c["search and fuse"]},
                             "phase 21 correction, card vs CPU", points_tol=max(1e-4, 2 * spread))
    end = st_kc["search and fuse"]
    many = max(n_threads, 2)
    print(f"phase 21 kernels vs plain at the closing pair (keyframe {cap['args'][0]} onto "
          f"{cap['args'][1]}, frame {cap['frame']}): gate counts equal {st_k}, the Sim3 equal "
          f"(scale {float(S_k[2])}); the correction again on the CPU ({secs[many]:.1f} s at "
          f"{many} threads, {secs[1]:.1f} s at 1) from its inputs: kf_mp equal, "
          f"poses within {max(end['kf_R'], end['kf_t']):.1e}, velocities within "
          f"{end['kf_vel']:.1e}, points within {end['mp_pos']:.1e} (the two CPU runs' points "
          f"{spread:.1e}, so the gate is {max(1e-4, 2 * spread):.1e}; by stage "
          f"{[(k, round(v['mp_pos'], 7)) for k, v in st_cc.items()]})")
    check(launches["fast_nms"] == N21 and sites.get("local map", 0) > 0
          and sites.get("loop verify match", 0) > 0, f"phase 21: launches {launches}, B1 by site "
          f"{sites}")
    print(f"phase 21 launches on the main path {launches}; B1 by site {sites}; B2 once a frame")
    print(f"phase 21 kernels vs plain: {_plain_prefix(argv, rows, init + PREFIX19, 'phase 21')}")
    return launches


def check(ok, what: str) -> None:
    """Fail the run (every phase's checks are hard failures)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save-inputs", metavar="FILE",
                    help="write phase 7's kernel inputs to FILE (torch.save)")
    ap.add_argument("--only", choices=["15", "16", "17", "18", "19", "20", "21"],
                    help="build, then run this phase alone (its B1 rows in the record)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    return run(opts)


def run(opts) -> int:
    """The phases (`main` has checked for the card)."""
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
    card = smi.stdout.strip().splitlines()[0]
    if opts.only in ("15", "16", "17", "18", "19", "20", "21"):
        err, rows = 0.0, []
        if opts.only == "15":
            err, rows, launches = phase15_rows(phase15_multimap(dev), card)
        elif opts.only == "18":  # phase 15 is 18b's one-device side
            p15 = phase15_multimap(dev)
            err, rows, launches = phase15_rows(p15, card)
            walls["phase 15"] = time.perf_counter()
            phase18a_dryrun(dev, card)
            walls["phase 18a"] = time.perf_counter()
            p18 = phase18b_config5(dev, card, p15)
            launches = {k: launches[k] + p18["launches"][k] for k in launches}
        elif opts.only == "16":
            p16 = phase16_runner(dev, card)
            err, rows, launches = p16["err"], [p16["row"]], p16["launches"]
        elif opts.only == "17":
            launches = phase17_stream_viewer(dev, card)["launches"]
        elif opts.only == "20":
            launches = phase20_inertial_multimap(dev, card)["launches"]
        elif opts.only == "21":
            launches = phase21_inertial_loop(dev, card)
        else:
            launches = phase19_runner_modes(dev, card)
        walls[f"phase {opts.only}"] = time.perf_counter()
        record = {"kernels": [{"name": "fast_nms", "route": "cuda",
                               "source": "orbslam3_tpu_torch/csrc/fast_nms.cu",
                               "replaces": "orbslam3_tpu/ops/pallas_fast.py:141",
                               "launches": launches["fast_nms"]},
                              {"name": "hamming_top2", "route": "cuda",
                               "source": "orbslam3_tpu_torch/csrc/hamming_top2.cu",
                               "replaces": "orbslam3_tpu/ops/pallas_match.py:155",
                               "launches": launches["hamming_top2"], "max_abs_err": err,
                               "calls": rows}]}
        return finish(walls, record)

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
    b1_shapes = {c[0]: c[1] for c in frame_calls if c[1] is not None}
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
    keys = [c[2] for c in wide_calls]
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
    # --- Phase 15: the Atlas: a map stored, a merge, save and load ----------
    p15 = phase15_multimap(dev)
    err15, rows15, launches15 = phase15_rows(p15, card)
    err_b1 = max(err_b1, err15)
    b1_rows.extend(rows15)
    walls["phase 15"] = time.perf_counter()
    # --- Phase 16: the runner at its defaults; phase 17: the stream server ---
    # Phases 16 and 21 replay the same files (phase 10's lap with its IMU).
    lap_tmp = tempfile.TemporaryDirectory(prefix="_chip_smoke_seq_lap_",
                                          dir=os.path.dirname(os.path.abspath(__file__)))
    lap = os.path.join(lap_tmp.name, "lap")
    p16 = phase16_runner(dev, card, lap)
    err_b1 = max(err_b1, p16["err"])
    b1_rows.append(p16["row"])
    walls["phase 16"] = time.perf_counter()
    p17 = phase17_stream_viewer(dev, card)
    walls["phase 17"] = time.perf_counter()
    # --- Phase 18: config 5 on two ranks of the card -------------------------
    phase18a_dryrun(dev, card)
    walls["phase 18a"] = time.perf_counter()
    p18 = phase18b_config5(dev, card, p15)
    walls["phase 18b"] = time.perf_counter()
    # --- Phase 19: the runner's sensor modes; config 3 to the scale refinement
    p19 = phase19_runner_modes(dev, card)
    walls["phase 19"] = time.perf_counter()
    # --- Phase 20: the inertial Atlas: an inertial merge ------------------------
    p20 = phase20_inertial_multimap(dev, card)
    walls["phase 20"] = time.perf_counter()
    # --- Phase 21: config 3's inertial loop at the runner's defaults ------------
    p21 = phase21_inertial_loop(dev, card, lap)
    lap_tmp.cleanup()
    walls["phase 21"] = time.perf_counter()

    if opts.save_inputs:
        per_replay = {**per_site, **p10["sites"]}
        torch.save({"b2": {"atlas": atlas.cpu(), "min_th": orb.min_th, "ini_th": orb.ini_th},
                    "b1": [KB.b1_record(site, a, per_replay.get(site))
                           for site, a in b1_shapes.items()]},
                   opts.save_inputs)

    for k in launches:
        launches[k] += sum(run[k] for run in (launches5, launches6, launches8, p10["launches"],
                                              p11["launches"], p12["rgbd"], p12["raw"],
                                              p13["launches"], p14["launches"], launches15,
                                              p16["launches"], p17["launches"],
                                              p18["launches"], p19, p20["launches"], p21))
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
    return finish(walls, record)


def phase15_rows(p15: dict, card: str):
    """B1 at phase 15's two new calls (the merge's verification match, the
    weld fuse; `p15` is `phase15_multimap`'s result) exact against plain and
    timed. Returns (the largest B1 difference, the rows, the phase's
    launches)."""
    from orbslam3_tpu_torch import kernel_bench as KB
    from orbslam3_tpu_torch.ops import _build, cuda_match

    err, rows = 0.0, []
    n_kf = sum(p15["rep"].keyframe)
    for site, a in p15["args"].items():
        got = cuda_match.hamming_top2(*a)
        with _build.force_plain():
            ref = cuda_match.hamming_top2(*a)
        torch.cuda.synchronize()
        for what, k_, p_ in zip(("d1", "d2", "j1"), got, ref):
            check(torch.equal(k_, p_), f"B1 {site} (phase 15): {what} differs from plain")
        err = max(err, float((got[0] - ref[0]).abs().max()), float((got[1] - ref[1]).abs().max()))
        t = KB.time_b1(a)
        with _build.force_plain():
            plain_ms = KB.call_us(lambda: cuda_match.hamming_top2(*a), iters=10) / 1e3
        bd = KB.b1_bound(*a)
        n15 = p15["sites"][site]
        rows.append({"call": site, "shape": [a[0].shape[0], a[1].shape[0]],
                     "windowed": a[3] is not None, **t, "plain_ms": plain_ms,
                     "bound_us": bd["bound_us"], "bound_by": bd["bound_by"],
                     "in_window_pairs": bd["pairs"], "launches_per_replay": n15,
                     "replay": "phase 15", "keyframes": n_kf})
        print(f"phase 15 B1 {site} {a[0].shape[0]}x{a[1].shape[0]} "
              f"{'windowed' if a[3] is not None else 'unwindowed'}: exact vs plain; device "
              f"{t['device_us']:.2f} us (graph of {KB.GRAPH_CALLS}), call {t['call_us']:.2f} us, "
              f"profiler {t['profiler_us']} us, bound {bd['bound_us']:.3f} us ({bd['bound_by']}; "
              f"{bd['bytes']} bytes, {bd['pairs']} pairs to popcount), plain {plain_ms:.4f} ms; "
              f"{n15} launches in the phase-15 replay [{card}]")
    for site in ("motion model", "local map", "fuse into a neighbour", "fuse into the keyframe",
                 "cross-check", "loop verify match", "reloc reference-keyframe match"):
        print(f"phase 15 B1 {site}: {p15['sites'][site]} launches in the phase-15 replay")
    return err, rows, p15["launches"]


def finish(walls: dict, record: dict) -> int:
    """The wall time per phase, the kernels' record, the last line."""
    names = list(walls)
    from orbslam3_tpu_torch.optim import graphed

    print(f"pose solves: {graphed.CAPTURES} CUDA graphs captured, {graphed.REPLAYS} replays")
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
