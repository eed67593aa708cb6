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
initialization, tracking, keyframes and their mapping passes) over 120
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
version's time and the bound (`orbslam3_tpu_torch/kernel_bench.py`). Every
phase prints its lines; any failure ends the run with a non-zero exit.
Without a CUDA device it exits non-zero and prints no result.

    python3 chip_smoke.py --save-inputs FILE

also writes phase 7's inputs to FILE, for `python -m
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
N_REPLAY = 120  # frames of the monocular replay in phase 6 (6 s of camera)
N_PREFIX = 20  # frames of its kernels-vs-plain prefix
# Sim3 ATE gate of the replay: max(2 x the JAX System's ATE on the same 120
# frames on a CPU, 0.01 m) (PERF.md, phase 6).
ATE_GATE = 0.0186


N_WIDE = 20  # frames of the 2000-feature System in phase 8
N_WIDE_FEATURES = 2000

# The main path's B1 calls, by the function that makes them.
B1_SITES = {"_track_last_frame": "motion model", "_track_local_map_match": "local map",
            "_track_reference_kf": "cross-check", "_fuse_batch": "fuse into a neighbour",
            "_fuse_neighbors": "fuse into the keyframe"}


@contextlib.contextmanager
def _b1_calls(calls: list, keep_args: bool):
    """Within the block, append (call site, arguments or None, key count)
    for every B1 wrapper call. The wrapper itself runs unchanged, launch
    count included."""
    from orbslam3_tpu_torch.ops import cuda_match

    wrapped = cuda_match.hamming_top2

    def recording(*args):
        f, site = sys._getframe(1), "other"
        while f is not None and site == "other":
            site = B1_SITES.get(f.f_code.co_name, "other")
            f = f.f_back
        calls.append((site, tuple(_clone(a) for a in args) if keep_args else None,
                      args[1].shape[0]))
        return wrapped(*args)

    cuda_match.hamming_top2 = recording
    try:
        yield calls
    finally:
        cuda_match.hamming_top2 = wrapped


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

    # --- Phase 7: device-only times, call times and bounds ------------------
    if opts.save_inputs:
        torch.save({"b2": {"atlas": atlas.cpu(), "min_th": orb.min_th, "ini_th": orb.ini_th},
                    "b1": [KB.b1_record(site, a) for site, a in b1_shapes.items()]},
                   opts.save_inputs)
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

    launches["fast_nms"] += launches6["fast_nms"] + launches8["fast_nms"]
    launches["hamming_top2"] += (launches5["hamming_top2"] + launches6["hamming_top2"]
                                 + launches8["hamming_top2"])
    lm = next(r for r in b1_rows if r["call"] == "local map")  # the kernel's headline call
    record = {"kernels": [
        {"name": "fast_nms", "route": "cuda", "source": "orbslam3_tpu_torch/csrc/fast_nms.cu",
         "replaces": "orbslam3_tpu/ops/pallas_fast.py:141", "launches": launches["fast_nms"],
         "max_abs_err": err_b2, "ms": b2_t["device_us"] / 1e3, "plain_ms": b2_plain_ms,
         "bound_ms": b2_b["bound_us"] / 1e3, "bound_by": b2_b["bound_by"], "library_ms": None,
         "device_us": b2_t["device_us"], "call_us": b2_t["call_us"],
         "bound_us": b2_b["bound_us"], "launches_per_replay": launches6["fast_nms"]},
        {"name": "hamming_top2", "route": "cuda",
         "source": "orbslam3_tpu_torch/csrc/hamming_top2.cu",
         "replaces": "orbslam3_tpu/ops/pallas_match.py:155",
         "launches": launches["hamming_top2"], "max_abs_err": err_b1,
         "ms": lm["device_us"] / 1e3, "plain_ms": lm["plain_ms"],
         "bound_ms": lm["bound_us"] / 1e3, "bound_by": lm["bound_by"], "library_ms": None,
         "device_us": lm["device_us"], "call_us": lm["call_us"], "bound_us": lm["bound_us"],
         "launches_per_replay": launches6["hamming_top2"], "calls": b1_rows},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
