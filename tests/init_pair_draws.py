"""Fault C16: the two-view initialization of phase 10's lap, both packages
on one host.

    JAX_PLATFORMS=cpu python tests/init_pair_draws.py [--keys 20]

Renders frames 0 and 1 of the synthetic EuRoC sequence with its lap
shortened to 8 s (the first frames of `chip_smoke.py` phase 10's lap) and
feeds them to the JAX `System` and to the port's (`device="cpu"`) at
config 1's widths. Each tracker hands `reconstruct_two_views` the matches of
frame 1 to frame 0; `lap_pair_inputs` returns what each handed over. Prints
one JSON line: whether the inputs are equal, the outcome of the JAX
function under `PRNGKey(k)` and of the port's fed the same draws for k <
`--keys`, the port's outcome under its own generator seeded k, and the
hypotheses' good-point counts (best, second) of JAX's key 0 and the port's
seed 0 (the clear-winner rule asks second < 0.75 best), and under key 0 the
initial map's differences: the good points of each, those only one holds, R
and t (max abs), and the points both hold (max and median |dX| / |X|). Not a
test: nothing
collects it; `tests/test_torch_ransac.py` holds the same inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam3_tpu.ops import cameras as cam_j  # noqa: E402
from orbslam3_tpu.ops import features as feat_j  # noqa: E402
from orbslam3_tpu.ops import ransac as rs_j  # noqa: E402
from orbslam3_tpu.pipeline import tracking as trk_j  # noqa: E402
from orbslam3_tpu.system import Sensor as SensorJ  # noqa: E402
from orbslam3_tpu.system import System as SystemJ  # noqa: E402
from orbslam3_tpu_torch import entry as E  # noqa: E402
from orbslam3_tpu_torch.ops import cameras as cam_t  # noqa: E402
from orbslam3_tpu_torch.ops import ransac as rs_t  # noqa: E402
from orbslam3_tpu_torch.pipeline import tracking as trk_t  # noqa: E402
from orbslam3_tpu_torch.system import Sensor, System  # noqa: E402

T_LOOP = 8.0  # phase 10's lap


def lap_pair_inputs(monkeypatch=None):
    """(JAX's, the port's) arguments of `reconstruct_two_views` at frame 1
    of the 8 s lap: dicts of p1, p2 (N, 2) float32, valid (N,) and
    sigma_norm, and JAX's outcome under its `PRNGKey(0)`."""
    gt_ts, imgs, _ = E.euroc_frames(2, 0, t_loop=T_LOOP)
    cfg = E.EUROC_MONO
    got = {}
    f_j, f_t = rs_j.reconstruct_two_views, rs_t.reconstruct_two_views

    def rec_j(p1, p2, valid, key, **kw):
        out = f_j(p1, p2, valid, key, **kw)
        got["jax"] = dict(p1=np.array(p1), p2=np.array(p2), valid=np.array(valid),
                          sigma_norm=kw["sigma_norm"], key=np.array(key),
                          success=bool(out.success))
        return out

    def rec_t(p1, p2, valid, generator=None, **kw):
        got["port"] = dict(p1=p1.numpy().copy(), p2=p2.numpy().copy(),
                           valid=valid.numpy().copy(), sigma_norm=kw["sigma_norm"])
        return f_t(p1, p2, valid, generator=generator, **kw)

    patches = ((trk_j.ransac, "reconstruct_two_views", rec_j),
               (trk_t.ransac, "reconstruct_two_views", rec_t))
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, f in patches:
        if monkeypatch is not None:
            monkeypatch.setattr(m, n, f)
        else:
            setattr(m, n, f)
    try:
        sj = SystemJ(SensorJ.MONOCULAR, cam_j.CameraModel.PINHOLE,
                     np.asarray(cfg["camera"], np.float32), cfg["img_wh"], feat_j.OrbParams(),
                     Kmax=cfg["Kmax"], Pmax=cfg["Pmax"], fps=cfg["fps"])
        st = System(Sensor.MONOCULAR, cam_t.CameraModel.PINHOLE, cfg["camera"], cfg["img_wh"],
                    cfg["orb"], device="cpu", Kmax=cfg["Kmax"], Pmax=cfg["Pmax"],
                    fps=cfg["fps"])
        for t, img in zip(gt_ts, imgs):
            sj.track_monocular(img.astype(np.float32), float(t))
            st.track_monocular(img, float(t))
    finally:
        if monkeypatch is None:
            for m, n, f in saved:
                setattr(m, n, f)
    return got["jax"], got["port"]


def jax_draws(key: int, valid: np.ndarray) -> np.ndarray:
    """`reconstruct_two_views`'s (200, 8) minimal sets under `PRNGKey(key)`."""
    logits = jnp.log(jnp.asarray(valid, jnp.float32) + 1e-9)
    return np.array(jax.random.categorical(jax.random.PRNGKey(key), logits[None, None, :],
                                           shape=(rs_j.N_HYPOTHESES, rs_j.SAMPLE)))


def _good_counts(p1, p2, valid, sigma, **kw):
    """(best, second) good-point counts of the chosen model's motions."""
    counts = []
    check = rs_t._check_rt

    def recording(*a, **k):
        out = check(*a, **k)
        counts.append(out[0])
        return out

    rs_t._check_rt = recording
    try:
        res = rs_t.reconstruct_two_views(p1, p2, valid, sigma_norm=sigma, **kw)
    finally:
        rs_t._check_rt = check
    n = counts[0][:8] if bool(res.used_homography) else counts[0][8:]
    top = torch.sort(n, descending=True)[0]
    return bool(res.success), int(top[0]), int(top[1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=20)
    a = ap.parse_args(argv)
    torch.set_num_threads(4)
    j, t = lap_pair_inputs()
    same = (np.array_equal(j["p1"], t["p1"]) and np.array_equal(j["valid"], t["valid"])
            and np.array_equal(j["p2"][j["valid"]], t["p2"][t["valid"]]))
    p1, p2, v = (torch.from_numpy(j[k]) for k in ("p1", "p2", "valid"))
    sigma = j["sigma_norm"]
    jax_ok, fed_ok, own_ok = [], [], []
    for k in range(a.keys):
        out = rs_j.reconstruct_two_views(jnp.asarray(j["p1"]), jnp.asarray(j["p2"]),
                                         jnp.asarray(j["valid"]), jax.random.PRNGKey(k),
                                         sigma_norm=sigma)
        jax_ok.append(bool(out.success))
        fed_ok.append(_good_counts(p1, p2, v, sigma,
                                   samples=torch.from_numpy(jax_draws(k, j["valid"])))[0])
        own_ok.append(_good_counts(p1, p2, v, sigma,
                                   generator=torch.Generator().manual_seed(k))[0])
    ref = rs_j.reconstruct_two_views(jnp.asarray(j["p1"]), jnp.asarray(j["p2"]),
                                     jnp.asarray(j["valid"]), jax.random.PRNGKey(0),
                                     sigma_norm=sigma)
    got = rs_t.reconstruct_two_views(p1, p2, v, sigma_norm=sigma,
                                     samples=torch.from_numpy(jax_draws(0, j["valid"])))
    g_ref, g_got = np.asarray(ref.is_good), got.is_good.numpy()
    both = g_ref & g_got
    X_ref, X_got = np.asarray(ref.points)[both], got.points.numpy()[both]
    rel = np.linalg.norm(X_got - X_ref, axis=1) / np.linalg.norm(X_ref, axis=1)
    key0 = dict(good=[int(g_ref.sum()), int(g_got.sum())], only_one=int((g_ref != g_got).sum()),
                R=float(np.abs(got.R.numpy() - np.asarray(ref.R)).max()),
                t=float(np.abs(got.t.numpy() - np.asarray(ref.t)).max()),
                points_rel_max=float(rel.max()), points_rel_median=float(np.median(rel)))
    print(json.dumps(dict(key0_map_vs_jax=key0,
        inputs_equal=same, matches=int(j["valid"].sum()), jax_system_success=j["success"],
        jax_keys=jax_ok, port_fed_jax_draws=fed_ok, port_own_seeds=own_ok,
        agree=sum(x == y for x, y in zip(jax_ok, fed_ok)),
        jax_key0_best_second=_good_counts(p1, p2, v, sigma,
                                          samples=torch.from_numpy(jax_draws(0, j["valid"])))[1:],
        port_seed0_best_second=_good_counts(p1, p2, v, sigma,
                                            generator=torch.Generator().manual_seed(0))[1:])))


if __name__ == "__main__":
    main()
