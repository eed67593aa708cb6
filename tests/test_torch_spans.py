"""The port's spans and counters (`orbslam3_tpu_torch/spans.py`): the off
path's cost, nesting, counters, the profiler's ranges, the CUDA-graph
guard; the span families of a monocular System's frames on the 12-frame
scene of `tests/test_e2e_mono.py` with asynchronous mapping and place
recognition; and the benchmark's readers of the new spans
(`benchmark/metrics/`), each on a hand-built `Record`."""

import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch import spans

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

ROOT = Path(__file__).resolve().parent.parent

# Names the benchmark's readers and `chip_smoke.py` read, spans the port
# had before the span families of tracking, extraction and place recognition.
READ_NAMES = {
    "preintegration", "pose-inertial (last frame)", "pose-inertial (last keyframe)",
    "loop: verify Sim3", "loop: essential graph", "loop: correct points",
    "loop: search and fuse", "gba/chunk", "try merge", "merge: merge maps", "merge: weld fuse",
    "merge: GBA start", "merge: weld BA", "merge: essential graph", "try_initialize",
    "scale refinement", "full VI-BA", "local inertial BA", "fisheye match",
    "pose solve with right rows",
}
NEW_SPANS = {
    "frame", "after-frame tick", "extract", "extract/atlas", "extract/fast_nms",
    "extract/select", "extract/describe", "track", "track/inputs", "track/motion_model",
    "track/ref_kf", "track/local_map", "track/fetch", "track/keyframe", "track/relocalize",
    "mapping stage", "GBA chunk", "loop closing",
    "atlas", "place/add", "place/query", "loop/verify/match", "loop/verify/ransac",
    "loop/verify/refine", "loop/verify/project",
}
NEW_COUNTERS = {"graph_capture", "mapping_queue"}


def _names_in_source(call: str) -> set:
    pat = re.compile(r"spans\." + call + r'\("([^"]+)"')
    out = set()
    for p in (ROOT / "orbslam3_tpu_torch").rglob("*.py"):
        out |= set(pat.findall(p.read_text()))
    return out


# --- the mechanism ---------------------------------------------------------


def test_off_span_is_one_shared_context_with_no_clock_and_no_event(monkeypatch):
    """With no recorder active, `span` returns the same no-op context every
    time, reads no clock, creates no CUDA event and records nothing."""
    assert spans._active is None

    def boom(*a, **kw):
        raise AssertionError("the off path read a clock or made an event")

    monkeypatch.setattr(spans.time, "perf_counter", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    a, b = spans.span("frame"), spans.span("track")
    assert a is b
    with a:
        with spans.span("extract"):
            pass
    spans.count("graph_capture")
    rec = spans.Recorder(cuda=False)
    assert rec.result() == {}


def test_on_spans_nest_and_counters_land_as_count_entries():
    rec = spans.Recorder(cuda=False)
    with rec:
        rec.frame = 3
        with spans.span("outer"):
            with spans.span("inner"):
                spans.count("graph_capture")
            spans.count("mapping_queue", 4)
        rec.frame = 4
        spans.count("mapping_queue", 2)
    with spans.span("outer"):  # after the block: nothing kept
        pass
    calls = rec.result()
    assert set(calls) == {"outer", "inner", "count/graph_capture", "count/mapping_queue"}
    (f_o, h_o, d_o), = calls["outer"]
    (f_i, h_i, d_i), = calls["inner"]
    assert f_o == f_i == 3 and h_o >= h_i >= 0.0 and d_o is None and d_i is None
    assert calls["count/graph_capture"] == [(3, 1, None)]
    assert calls["count/mapping_queue"] == [(3, 4, None), (4, 2, None)]
    assert set(spans.report(calls)) == {"outer", "inner"}
    assert spans.counters(calls) == {"graph_capture": dict(entries=1, sum=1, mean=1.0),
                                     "mapping_queue": dict(entries=2, sum=6, mean=3.0)}


def test_print_report_lists_counters_apart(capsys):
    calls = {"track": [(0, 2.0, None), (1, 4.0, None)],
             "count/mapping_queue": [(0, 1, None), (1, 3, None)]}
    spans.print_report(calls)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("track ") and "mean=    3.00ms" in out[0]
    assert out[1] == "counters (entries, sum, mean):"
    assert re.sub(r"=\s+", "=", out[2]).split() == ["count/mapping_queue", "entries=2", "sum=4",
                                                    "mean=2.00"]


def test_span_opens_a_profiler_range_around_its_work():
    from torch.profiler import ProfilerActivity, profile

    rec = spans.Recorder(cuda=False)
    with rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("track/local_map"):
            torch.ones(64).mul(3.0).sum()
    with spans.span("track/local_map"):  # the profiler off: no range needed
        pass
    events = prof.profiler.kineto_results.events()
    rng = [e for e in events if e.name() == "track/local_map"]
    ops = [e for e in events if e.name() == "aten::mul"]
    assert len(rng) == 1 and ops
    assert all(rng[0].start_ns() <= e.start_ns() and e.end_ns() <= rng[0].end_ns() for e in ops)
    assert len(rec.result()["track/local_map"]) == 1


def test_on_span_makes_no_event_while_the_stream_captures(monkeypatch):
    """A CUDA recorder takes two events around a span, and none while the
    current stream captures a CUDA graph (the events would fault the
    capture)."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            made.append(self)

        def record(self):
            pass

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    rec = spans.Recorder(cuda=True)
    with rec:
        with spans.span("free"):
            pass
        capturing[0] = True
        with spans.span("captured"):
            pass
    assert len(made) == 2 and rec.calls["free"][0][2] == tuple(made)
    assert rec.calls["captured"][0][2] is None


def test_new_names_keep_clear_of_the_read_ones():
    """No new span starts with `mapping/` (`mapping_stage_ms` averages every
    such span) or takes a name the readers or `chip_smoke.py` read; every
    read name is still at its call site, and the counters are the two."""
    src = _names_in_source("span")
    assert NEW_SPANS <= src and READ_NAMES <= src
    assert not any(n.startswith("mapping/") for n in NEW_SPANS)
    assert not NEW_SPANS & READ_NAMES
    assert not any(n.startswith(spans.COUNT) for n in src)
    assert _names_in_source("count") == NEW_COUNTERS


# --- a System's frames ------------------------------------------------------


@pytest.fixture(scope="module")
def mono_run():
    """The port's monocular System (400 features on 3 levels, Kmax 32,
    Pmax 4096) over the 12 frames with asynchronous mapping and place
    recognition on the 9,975-word tree, under a recorder; the mapper is
    drained at the end, so every keyframe reaches the loop closer."""
    import test_e2e_mono as scene
    from orbslam3_tpu_torch.io import vocab_io
    from orbslam3_tpu_torch.ops import cameras as cam_t
    from orbslam3_tpu_torch.ops import features as feat_t
    from orbslam3_tpu_torch.pipeline.tracking import TrackState
    from orbslam3_tpu_torch.system import Sensor, System

    params = cam_t.make_pinhole(scene.FOCAL, scene.FOCAL, scene.W / 2, scene.H / 2).numpy()
    pts, shades = scene.make_world(np.random.default_rng(0))
    imgs = [scene.render(params, R, t, pts, shades) for R, t in scene.camera_path(12)]
    slam = System(Sensor.MONOCULAR, cam_t.CameraModel.PINHOLE, params, (scene.W, scene.H),
                  orb_params=feat_t.OrbParams(n_features=400, n_levels=3), device="cpu",
                  Kmax=32, Pmax=4096)
    slam.enable_async_mapping()
    voc = vocab_io.load_binary_vocabulary(os.path.join(ROOT, "assets", "ORBvoc_synth.bin"), "cpu")
    slam.enable_place_recognition(voc)
    adds = []
    add = slam.loop_closer.kfdb.add
    slam.loop_closer.kfdb.add = lambda *a, **kw: adds.append(a[0]) or add(*a, **kw)
    tracked = []
    rec = spans.Recorder(cuda=False)
    with rec:
        for k, img in enumerate(imgs):
            rec.frame = k
            if slam.tracking_state == TrackState.OK:
                tracked.append(k)
            slam.track_monocular(img, k * 0.1)
        rec.frame = None
        slam.shutdown()
    return dict(calls=rec.result(), tracked=tracked, adds=adds, slam=slam)


def _frames_of(calls, name):
    return [f for f, _, _ in calls.get(name, [])]


def test_mono_frames_carry_the_span_families(mono_run):
    calls, tracked = mono_run["calls"], mono_run["tracked"]
    assert len(tracked) >= 8
    for name in ("frame", "extract", "extract/atlas", "extract/fast_nms", "extract/select",
                 "extract/describe", "track", "after-frame tick"):
        assert _frames_of(calls, name) == list(range(12)), name
    for name in ("track/inputs", "track/motion_model", "track/local_map", "track/fetch"):
        assert _frames_of(calls, name) == tracked, name
    assert set(_frames_of(calls, "track/keyframe")) == set(tracked)
    for f, h, d in calls["track"]:
        inner = sum(h2 for name in ("track/motion_model", "track/local_map", "track/fetch")
                    for f2, h2, _ in calls.get(name, []) if f2 == f)
        assert inner <= h and d is None


def test_mono_place_add_per_keyframe_and_mapping_counters(mono_run):
    calls, adds, slam = mono_run["calls"], mono_run["adds"], mono_run["slam"]
    assert len(adds) >= 3 and len(calls["place/add"]) == len(adds)
    assert len(calls["loop closing"]) == len(adds)
    assert len(adds) == slam.async_mapper.n_completed + 1  # and the initial map's keyframe
    queue = calls["count/mapping_queue"]
    assert len(queue) >= slam.async_mapper.n_completed and all(n >= 1 for _, n, _ in queue)
    assert len(calls["mapping stage"]) >= len(queue)
    assert "count/graph_capture" not in calls  # no CUDA graph on the CPU


# --- the benchmark's readers -------------------------------------------------


def _record(span_calls):
    from benchmark.record import Record

    frames = [dict(ms=100.0, kind="tracked", syncs=2, state="OK") for _ in range(4)]
    return Record(cell=None, frames=frames, spans=span_calls, window_s=0.0, busy_s=0.0,
                  profiled=(0, 0), device_s={}, idle_s={}, b1_bound_us=0.0, b1_calls=0,
                  b2_bound_us=0.0, b2_calls=0)


def _reader(name):
    from benchmark.cell import metric_reader

    return metric_reader(name)


SPANS = {
    "extract": [(0, 20.0, 1.0), (1, 24.0, None), (2, 18.0, None)],
    "extract/atlas": [(0, 3.0, None)],
    "track/motion_model": [(1, 30.0, 2.0), (2, 10.0, None)],
    "track/local_map": [(1, 40.0, None), (2, 44.0, None), (3, 50.0, None)],
    "track/fetch": [(1, 1.0, None), (2, 3.0, None), (3, 2.0, None), (3, 9.0, None)],
    "place/add": [(1, 2.0, None), (3, 4.0, None)],
    "place/query": [(3, 6.0, None)],
    "loop/verify/match": [(3, 5.0, None)],
    "loop/verify/ransac": [(3, 7.0, None)],
    "loop: verify Sim3": [(3, 100.0, None)],  # the enclosing span is not counted twice
    "mapping/fuse": [(2, 50.0, None)],
    "count/mapping_queue": [(2, 3, None)],
}


@pytest.mark.parametrize("name, expected", [
    ("extract_ms", 20.0),  # median of 20, 24, 18
    ("track_motion_model_ms", 20.0),
    ("track_local_map_ms", 44.0),
    ("track_fetch_ms", 2.5),
    ("loop_detect_ms", (2.0 + 4.0 + 6.0 + 5.0 + 7.0) / 2),
])
def test_reader_of_the_new_spans(name, expected):
    assert _reader(name).read(_record(SPANS)) == pytest.approx(expected)


@pytest.mark.parametrize("name", ["extract_ms", "track_motion_model_ms", "track_local_map_ms",
                                  "track_fetch_ms", "loop_detect_ms"])
def test_reader_without_its_spans_reads_none(name):
    without = {k: v for k, v in SPANS.items()
               if not k.startswith(("extract", "track/", "place/add"))}
    assert _reader(name).read(_record(without)) is None
    assert _reader(name).read(_record({})) is None


def test_readers_of_the_older_spans_ignore_the_new_ones():
    """`mapping_stage_ms` still averages the `mapping/*` spans alone, and a
    counter's entries reach no span reader."""
    assert _reader("mapping_stage_ms").read(_record(SPANS)) == pytest.approx(50.0)
    assert _reader("inertial_ms_per_frame").read(_record(SPANS)) is None
