"""Port parity: the host I/O of the system surface — `io/png.py` against
OpenCV, `config.py` and `io/datasets.py` against the JAX package, the EuRoC
writer against `scripts/make_synth_euroc.py`, and `ops/bow.py`'s training
against the JAX package's. Every comparison is exact.

* `png.imread` equals `cv2.imread` in IMREAD_GRAYSCALE and IMREAD_UNCHANGED
  on PNGs that OpenCV writes (8-bit grey and RGB, 16-bit grey and RGB, odd
  widths) and on PNGs written here under each of the five row filters;
  OpenCV reads the port's PNGs back exactly;
* `load_settings` field for field on every settings text of the repo's
  generators and tests, and on a `Key:value` line; lines outside the subset
  raise, naming the line;
* every loader on layouts written here (EuRoC with IMU and ground truth,
  KITTI with a right camera, TUM RGB-D with associations and 16-bit depth,
  TUM-VI);
* `write_euroc` (through `entry.write_euroc_sequence`) writes the files of
  `make_synth_euroc.py`, also its `--stereo` and `--fisheye` (TUM-VI) pairs,
  and `sequence_digest` names both alike;
* the 16-bit grey encode round-trips through `png.imread` and `cv2.imread`;
  `write_kitti`, `write_tum_rgbd` and the other layouts of
  `write_euroc_sequence` load through the JAX package's loaders into the
  timestamps and pixels written;
* `build_vocabulary` array for array, and an npz the JAX `load_npz` reads;
* `entry.euroc_frames`' in-process cache: a prefix, an extension, the IMU
  stream after an extension, blind and kidnapped variants that take the
  plain sequence's first frames, and a `save_frames` / `load_frames` round
  trip each equal a fresh render in an emptied cache (`clear_frames`).
"""

import dataclasses
import importlib.util
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("yaml")

from orbslam3_tpu import config as cfg_j  # noqa: E402
from orbslam3_tpu.io import datasets as ds_j  # noqa: E402
from orbslam3_tpu.ops import bow as bow_j  # noqa: E402
from orbslam3_tpu_torch import config as cfg_t  # noqa: E402
from orbslam3_tpu_torch import entry as E  # noqa: E402
from orbslam3_tpu_torch.io import datasets as ds_t  # noqa: E402
from orbslam3_tpu_torch.io import png  # noqa: E402
from orbslam3_tpu_torch.ops import bow as bow_t  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _synth():
    spec = importlib.util.spec_from_file_location("msynth", REPO / "scripts" / "make_synth_euroc.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CV_CASES = {
    "grey8": ((37, 53), np.uint8),
    "rgb8": ((21, 31, 3), np.uint8),
    "grey16": ((19, 23), np.uint16),
    "rgb16": ((17, 29, 3), np.uint16),
    "grey8_smooth": ((64, 75), np.uint8),
}


@pytest.mark.parametrize("case", sorted(CV_CASES))
def test_png_reads_what_opencv_writes(tmp_path, case):
    shape, dtype = CV_CASES[case]
    rng = np.random.default_rng(len(case))
    hi = np.iinfo(dtype).max + 1
    if case.endswith("smooth"):  # gradients: libpng picks other filters than for noise
        yy, xx = np.mgrid[: shape[0], : shape[1]]
        img = ((xx * 3 + yy * 5 + rng.integers(0, 3, shape)) % 256).astype(dtype)
    else:
        img = rng.integers(0, hi, shape).astype(dtype)
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, img)
    for flags in (cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED):
        ref = cv2.imread(path, flags)
        got = png.imread(path, flags)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def _filtered_png(img: np.ndarray, filt: int) -> bytes:
    """A PNG of an 8-bit grey or RGB image with every row under `filt`."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    raw = img.reshape(h, w * ch).astype(np.int64)
    bpp = ch
    rows = []
    prev = np.zeros(w * ch, np.int64)
    for y in range(h):
        cur = raw[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if filt == 0:
            f = cur
        elif filt == 1:
            f = cur - left
        elif filt == 2:
            f = cur - prev
        elif filt == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            f = cur - pred
        rows.append(bytes([filt]) + (f % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    hdr = struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr) + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", range(5))
@pytest.mark.parametrize("colour", ["grey", "rgb"])
def test_png_reads_each_row_filter(tmp_path, filt, colour):
    rng = np.random.default_rng(filt)
    shape = (13, 17) if colour == "grey" else (11, 9, 3)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_filtered_png(img, filt))
    for flags in (cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED):
        np.testing.assert_array_equal(png.imread(path, flags), cv2.imread(path, flags))


def test_opencv_reads_the_ports_pngs(tmp_path):
    rng = np.random.default_rng(3)
    for shape in ((7, 11), (480, 752), (5, 9, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / "p.png")
        png.imwrite(path, img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        ok, buf = cv2.imencode(".png", img)
        np.testing.assert_array_equal(png.decode(bytes(buf), png.IMREAD_UNCHANGED), img)
    enc = png.encode(np.zeros((4, 4), np.uint8), text={"state": "OK  kp=3"})
    assert b"tEXtstate\x00OK  kp=3" in enc
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(enc, np.uint8), -1), 0)


@pytest.mark.parametrize("shape", [(7, 11), (480, 752), (1, 3)])
def test_png_16_bit_grey_round_trips(tmp_path, shape):
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 65536, shape).astype(np.uint16)
    img.flat[:2] = (0, 65535)
    path = str(tmp_path / "d.png")
    png.imwrite(path, img)
    for read in (png.imread, cv2.imread):
        got = read(path, cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(png.imread(path, png.IMREAD_GRAYSCALE),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    ok, buf = cv2.imencode(".png", img)
    np.testing.assert_array_equal(png.decode(bytes(buf), png.IMREAD_UNCHANGED), img)


def test_png_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "pal.png")
    cv2.imwrite(path, np.zeros((4, 4, 4), np.uint8))  # RGBA: colour type 6
    with pytest.raises(ValueError, match="pal.png: PNG colour type 6"):
        png.imread(path)
    with pytest.raises(FileNotFoundError):
        png.imread(str(tmp_path / "missing.png"))


def _same(a, b, where="settings"):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, tuple) and hasattr(a, "_fields"):  # OrbParams
        assert tuple(a) == tuple(b), where
    elif hasattr(a, "value") and hasattr(b, "value"):  # the camera model enums
        assert a.value == b.value and a.name == b.name, where
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def _settings_texts():
    M = _synth()
    from test_runners import SETTINGS as runner_settings

    return {
        "synth": M.SETTINGS_YAML,
        "synth_stereo": M.SETTINGS_YAML + f"Camera.bf: {M.FX * M.BASELINE_M}\nThDepth: 35.0\n",
        "fisheye": M.FE_SETTINGS_YAML,
        "raw_stereo": M.raw_stereo_yaml(),
        "runners": runner_settings,
        "key_colon_value": M.SETTINGS_YAML.replace("Camera.fps: 20.0", "Camera.fps:20.0")
        + "DepthMapFactor:5000.0  # a comment\n",
    }


@pytest.mark.parametrize("name", ["synth", "synth_stereo", "fisheye", "raw_stereo", "runners",
                                  "key_colon_value"])
def test_load_settings_matches_reference(tmp_path, name):
    text = _settings_texts()[name]
    path = tmp_path / "s.yaml"
    path.write_text(text)
    _same(cfg_t.load_settings(str(path)), cfg_j.load_settings(str(path)))


def test_settings_reader_names_the_line_it_cannot_read(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("%YAML:1.0\nCamera.fx: 458.0\nCamera:\n  nested: 1\n")
    with pytest.raises(ValueError, match=r"bad.yaml:3"):
        cfg_t.load_settings(str(path))
    path.write_text("%YAML:1.0\nTbc: !!opencv-matrix\n   rows: 2\n   cols: 2\n   dt: f\n"
                    "   data: [1, 2,\n          3]\n")
    with pytest.raises(ValueError, match="3 values, not 2 x 2"):
        cfg_t.read_opencv_yaml(str(path))


def _same_seq(a, b):
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    assert a.paths == b.paths and a.paths_right == b.paths_right
    for k in range(len(a)):
        np.testing.assert_array_equal(a.read(k), b.read(k))
        assert a.read(k).dtype == b.read(k).dtype == np.float32


def test_loaders_match_reference(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (3, 12, 16)).astype(np.uint8)
    # EuRoC with a right camera, IMU and ground truth (and TUM-VI, the same layout)
    ns = [1403636579763555584 + 50_000_000 * k for k in range(3)]
    t_imu = [1403636579763555584 + 5_000_000 * j for j in range(11)]
    imu = (t_imu, rng.normal(0, 1, (11, 3)), rng.normal(0, 9, (11, 3)))
    gt = (rng.normal(0, 1, (3, 3)), rng.normal(0, 1, (3, 4)))
    euroc = str(tmp_path / "euroc")
    ds_t.write_euroc(euroc, ns, imgs, "%YAML:1.0\n", right=imgs[::-1], imu=imu, groundtruth=gt)
    _same_seq(ds_t.load_euroc_images(euroc), ds_j.load_euroc_images(euroc))
    _same_seq(ds_t.load_euroc_images(euroc, cam="cam1"), ds_j.load_euroc_images(euroc, cam="cam1"))
    _same_seq(ds_t.load_tumvi_images(euroc), ds_j.load_tumvi_images(euroc))
    stamps = tmp_path / "stamps.txt"
    stamps.write_text(f"{ns[2]}\n{ns[0]}\n")
    _same_seq(ds_t.load_euroc_images(euroc, str(stamps)), ds_j.load_euroc_images(euroc, str(stamps)))
    i_t, i_j = ds_t.load_euroc_imu(euroc), ds_j.load_euroc_imu(euroc)
    for f in ("timestamps", "gyro", "acc"):
        np.testing.assert_array_equal(getattr(i_t, f), getattr(i_j, f))
        assert getattr(i_t, f).dtype == getattr(i_j, f).dtype
    for a, b in zip(ds_t.load_groundtruth_euroc(euroc), ds_j.load_groundtruth_euroc(euroc)):
        np.testing.assert_array_equal(a, b)
    # KITTI with a right camera
    kitti = tmp_path / "kitti"
    for cam in ("image_0", "image_1"):
        (kitti / cam).mkdir(parents=True)
        for k in range(3):
            cv2.imwrite(str(kitti / cam / f"{k:06d}.png"), imgs[k])
    (kitti / "times.txt").write_text("0.0\n0.1\n0.2\n")
    _same_seq(ds_t.load_kitti(str(kitti)), ds_j.load_kitti(str(kitti)))
    s = ds_t.load_kitti(str(kitti))
    np.testing.assert_array_equal(s.read_right(1), ds_j.load_kitti(str(kitti)).read_right(1))
    # TUM RGB-D: colour images and 16-bit depth through an associations file
    tum = tmp_path / "tum"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir()
    lines = []
    for k in range(3):
        cv2.imwrite(str(tum / "rgb" / f"{k}.png"), rng.integers(0, 256, (12, 16, 3)).astype(np.uint8))
        cv2.imwrite(str(tum / "depth" / f"{k}.png"),
                    rng.integers(0, 65536, (12, 16)).astype(np.uint16))
        lines.append(f"{k * 0.1:.6f} rgb/{k}.png {k * 0.1 + 0.001:.6f} depth/{k}.png")
    assoc = tum / "assoc.txt"
    assoc.write_text("# associations\n" + "\n".join(lines) + "\n")
    r_t, r_j = ds_t.load_tum_rgbd(str(tum), str(assoc)), ds_j.load_tum_rgbd(str(tum), str(assoc))
    _same_seq(r_t, r_j)
    for k in range(3):
        np.testing.assert_array_equal(r_t.read_depth(k), r_j.read_depth(k))
        assert r_t.read_depth(k).max() > 255


def test_writer_matches_make_synth_euroc(tmp_path):
    """3 frames and their IMU stream, written by the script (OpenCV) and by
    the port (`io/png.py`): the same CSV and settings files byte for byte,
    the same pixels, the same digest."""
    ref, got = tmp_path / "script", tmp_path / "port"
    subprocess.run([sys.executable, str(REPO / "scripts" / "make_synth_euroc.py"), str(ref),
                    "--frames", "3", "--loop-seconds", "8"], check=True, capture_output=True)
    E.write_euroc_sequence(str(got), 3, 0, t_loop=8.0, imu=True)
    for rel in ("settings.yaml", "mav0/cam0/data.csv", "mav0/imu0/data.csv",
                "mav0/state_groundtruth_estimate0/data.csv"):
        assert (ref / rel).read_bytes() == (got / rel).read_bytes(), rel
    names = sorted(os.listdir(ref / "mav0" / "cam0" / "data"))
    assert names == sorted(os.listdir(got / "mav0" / "cam0" / "data"))
    for name in names:
        np.testing.assert_array_equal(cv2.imread(str(got / "mav0/cam0/data" / name), -1),
                                      cv2.imread(str(ref / "mav0/cam0/data" / name), -1))
    assert ds_t.sequence_digest(str(ref)) == ds_t.sequence_digest(str(got))


@pytest.mark.parametrize("pair", ["stereo", "fisheye"])
def test_pair_writer_matches_make_synth_euroc(tmp_path, pair):
    """2 frames of the script's `--stereo` and `--fisheye` (the TUM-VI layout):
    the same CSV and settings files byte for byte, the same pixels in cam0
    and cam1."""
    ref, got = tmp_path / "script", tmp_path / "port"
    subprocess.run([sys.executable, str(REPO / "scripts" / "make_synth_euroc.py"), str(ref),
                    "--frames", "2", f"--{pair}"], check=True, capture_output=True)
    E.write_euroc_sequence(str(got), 2, 0, imu=True, **{pair: True})
    for rel in ("settings.yaml", "mav0/cam0/data.csv", "mav0/cam1/data.csv",
                "mav0/imu0/data.csv", "mav0/state_groundtruth_estimate0/data.csv"):
        assert (ref / rel).read_bytes() == (got / rel).read_bytes(), rel
    for cam in ("cam0", "cam1"):
        names = sorted(os.listdir(ref / "mav0" / cam / "data"))
        assert names == sorted(os.listdir(got / "mav0" / cam / "data")) and len(names) == 2
        for name in names:
            np.testing.assert_array_equal(cv2.imread(str(got / "mav0" / cam / "data" / name), -1),
                                          cv2.imread(str(ref / "mav0" / cam / "data" / name), -1))
    assert ds_t.sequence_digest(str(ref)) == ds_t.sequence_digest(str(got))


def test_writers_load_through_reference(tmp_path):
    """Each new layout, read by the JAX package's loaders: the timestamps and
    pixels written (the depth as metres x DepthMapFactor, rounded), and the
    port's loaders read the same."""
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (3, 12, 16)).astype(np.uint8)
    right = rng.integers(0, 256, (3, 12, 16)).astype(np.uint8)
    ts = [0.0, 0.05, 0.1]
    kitti = str(tmp_path / "kitti")
    ds_t.write_kitti(kitti, ts, imgs, right=right)
    seq = ds_j.load_kitti(kitti)
    np.testing.assert_array_equal(seq.timestamps, ts)
    for k in range(3):
        np.testing.assert_array_equal(seq.read(k), imgs[k])
        np.testing.assert_array_equal(seq.read_right(k), right[k])
    _same_seq(ds_t.load_kitti(kitti), seq)
    depth = rng.uniform(0.3, 12.0, (3, 12, 16)).astype(np.float32)
    depth[0, 0, :4] = (0.0, -1.0, np.inf, np.nan)  # no measurement
    tum = str(tmp_path / "tum")
    assoc = ds_t.write_tum_rgbd(tum, ts, imgs, depth)
    seq = ds_j.load_tum_rgbd(tum, assoc)
    np.testing.assert_array_equal(seq.timestamps, ts)
    for k in range(3):
        np.testing.assert_array_equal(seq.read(k), imgs[k])
        raw = seq.read_depth(k)
        ok = np.isfinite(depth[k]) & (depth[k] > 0)
        np.testing.assert_array_equal(raw[ok], np.round(depth[k][ok].astype(np.float64) * 5000))
        assert (raw[~ok] == 0).all()
        np.testing.assert_array_equal(ds_t.load_tum_rgbd(tum, assoc).read_depth(k), raw)
    _same_seq(ds_t.load_tum_rgbd(tum, assoc), seq)
    for layout, kw in (("kitti", {}), ("tumrgbd", dict(depth=True)), ("euroc", dict(imu=True)),
                       ("kitti", dict(stereo=True))):
        out = str(tmp_path / f"{layout}_{len(kw)}_{sorted(kw)}")
        E.write_euroc_sequence(out, 2, 0, layout=layout, **kw)
        frames = E.euroc_frames(2, 0, **kw)
        left = frames[1][:, 0] if kw.get("stereo") else frames[1]
        seq = {"kitti": lambda: ds_j.load_kitti(out),
               "tumrgbd": lambda: ds_j.load_tum_rgbd(out, os.path.join(out, "associations.txt")),
               "euroc": lambda: ds_j.load_euroc_images(out)}[layout]()
        want_ts = frames[0] if layout != "euroc" else (
            np.asarray([E.START_NS + int(round(t * 1e9)) for t in frames[0]]) * 1e-9)
        np.testing.assert_allclose(seq.timestamps, want_ts, rtol=0, atol=1e-9)
        for k in range(2):
            np.testing.assert_array_equal(seq.read(k), left[k])
            if kw.get("stereo"):
                np.testing.assert_array_equal(seq.read_right(k), frames[1][k, 1])
            if kw.get("depth"):
                np.testing.assert_array_equal(seq.read_depth(k),
                                              np.round(frames[3][k].astype(np.float64) * 5000))
        assert cfg_t.load_settings(os.path.join(out, "settings.yaml")).camera.depth_map_factor \
            == (5000.0 if kw.get("depth") else 1.0)


def test_build_vocabulary_matches_reference(tmp_path):
    rng = np.random.default_rng(1)
    desc = rng.integers(0, 256, (600, 32)).astype(np.uint8)
    ref = bow_j.build_vocabulary(desc, k=4, depth=3, seed=2)
    got = bow_t.build_vocabulary(desc, k=4, depth=3, seed=2, device="cpu")
    for f in ("node_desc", "node_children", "node_word", "word_weight"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    assert (got.depth, got.k) == (ref.depth, ref.k)
    path = str(tmp_path / "voc.npz")
    bow_t.save_npz(path, got)
    back = bow_j.load_npz(path)
    for f in ("node_desc", "node_children", "node_word", "word_weight"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), getattr(got, f).numpy())


def _same_frames(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b) if isinstance(a, tuple) else ((a, b),):  # the IMU stream's arrays
            np.testing.assert_array_equal(x, y)


def _fresh(n, **kw):
    E.clear_frames()
    return E.euroc_frames(n, 0, **kw)


def test_euroc_frames_cache_equals_a_fresh_render():
    """Each sequence `euroc_frames` serves from its cache is the one a fresh
    render of the same arguments gives."""
    lap = dict(t_loop=16.0)
    E.clear_frames()
    served = {}
    served[3, None] = E.euroc_frames(3, 0, **lap)
    served[5, None] = E.euroc_frames(5, 0, **lap)  # renders frames 3 and 4 only
    served[2, None] = E.euroc_frames(2, 0, **lap)  # a prefix
    served[6, "imu"] = E.euroc_frames(6, 0, imu=True, **lap)  # the IMU after an extension
    variants = {"blind": dict(blind=(2, 2)), "kidnap": dict(kidnap=(3, 40))}
    for v, kw in variants.items():  # rendered after the plain sequence: they take its frames
        served[6, v] = E.euroc_frames(6, 0, **kw, **lap)
        key = E._Sequence.key_of(0, **kw, **lap)
        assert E._SEQUENCES[key].imgs[0] is E._SEQUENCES[E._Sequence.key_of(0, **lap)].imgs[0]
    served[7, "kidnap"] = E.euroc_frames(7, 0, kidnap=(3, 40), **lap)  # extends an adopted one
    for (n, v), got in served.items():
        kw = dict(lap, **variants.get(v, {}), imu=v == "imu")
        _same_frames(got, _fresh(n, **kw))
    E.clear_frames()


def test_euroc_frames_blind_variants_share_their_frames():
    """Two laps that differ in their blind interval alone: the second takes
    every frame the first rendered that neither covers (the same arrays),
    renders only those the first covered, and both equal a fresh render;
    so does the sequence without a blind interval rendered after them."""
    lap = dict(t_loop=16.0)
    E.clear_frames()
    served = {(2, 2): E.euroc_frames(8, 0, blind=(2, 2), **lap)}
    served[4, 3] = E.euroc_frames(9, 0, blind=(4, 3), **lap)  # frames 2, 3 rendered, 8 new
    first = E._SEQUENCES[E._Sequence.key_of(0, blind=(2, 2), **lap)]
    second = E._SEQUENCES[E._Sequence.key_of(0, blind=(4, 3), **lap)]
    assert all(second.imgs[k] is first.imgs[k] for k in (0, 1, 7))
    assert all(second.imgs[k] is not first.imgs[k] for k in (2, 3, 4))
    served[None] = E.euroc_frames(9, 0, **lap)
    for blind, got in served.items():
        _same_frames(got, _fresh(len(got[0]), blind=blind, **lap))
    E.clear_frames()


def test_save_frames_round_trip(tmp_path):
    """`load_frames` serves what `save_frames` wrote, at exactly its length
    and without an IMU stream; other arguments render as before."""
    path, kw = str(tmp_path / "lap.npz"), dict(t_loop=16.0, blind=(1, 2))
    E.clear_frames()
    E.save_frames(path, 4, 0, **kw)
    want = _fresh(4, **kw)
    plain = _fresh(4, t_loop=16.0)
    E.clear_frames()
    E.load_frames(path)
    _same_frames(E.euroc_frames(4, 0, **kw), want)
    for n, imu in ((3, False), (5, False), (4, True)):
        with pytest.raises(ValueError, match="exactly 4 frames"):
            E.euroc_frames(n, 0, imu=imu, **kw)
    _same_frames(E.euroc_frames(4, 0, t_loop=16.0), plain)
    with pytest.raises(ValueError, match="no depth"):
        E.save_frames(path, 2, 0, depth=True)
    E.clear_frames()
