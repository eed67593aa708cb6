"""Kernel B1's edge cases on the CPU: the port's plain `hamming_top2`
against the reference's XLA path (`matching._mask_matrix` + `window_mask` +
`best_two`), on every row, exactly; and the wrapper's contract with its
callers (the types the kernel takes as they are, refused otherwise, and
passed so by every caller on the main path).

The cases (`kernel_bench.b1_edge_cases`, and `b1_tile_cases` above one
1024-key tile) are the ones `tests/test_torch_cuda.py` and `chip_smoke.py`
hold the kernel to on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import matching as mj
from orbslam3_tpu_torch import entry as E
from orbslam3_tpu_torch import kernel_bench
from orbslam3_tpu_torch.ops import cuda_match
from orbslam3_tpu_torch.ops import features as feat
from orbslam3_tpu_torch.pipeline import tracking

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

CASES = dict(kernel_bench.b1_edge_cases())
TILE_TIES = {k: c for k, c in kernel_bench.b1_tile_cases() if k.startswith("tile_tie")}


def _xla_masked(case):
    """The reference's masked distance matrix of one case."""
    D = mj._mask_matrix(mj.hamming_matrix(jnp.asarray(case["da"]), jnp.asarray(case["db"])),
                        None, jnp.asarray(case["vb"]))
    if "uvq" in case:
        m = mj.window_mask(*(jnp.asarray(case[k]) for k in ("uvq", "uvk", "rad", "octk", "lo",
                                                             "hi")))
        D = jnp.where(m, D, mj.INF)
    return np.asarray(D)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_top2_equals_xla_on_edge_cases(name):
    """d1, d2 and j1 equal on every row. With one key the reference's
    `lax.top_k(-D, 2)` is undefined; there d1 and j1 are its only column and
    d2 is +inf, as the port's `best_two` gives."""
    case = CASES[name]
    got = [x.numpy() for x in cuda_match.hamming_top2(*kernel_bench.b1_case_args(case, "cpu"))]
    D = _xla_masked(case)
    if D.shape[1] == 1:
        ref = [D[:, 0], np.full(len(D), np.inf, np.float32), np.zeros(len(D), np.int32)]
    else:
        ref = [np.asarray(x) for x in mj.best_two(jnp.asarray(D))]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name", list(TILE_TIES))
def test_plain_top2_equals_xla_with_ties_across_the_tile_edge(name):
    """2048 keys, the second 1024 copies of the first: every best is tied
    across the kernel's tile edge. The plain version equals the reference's
    XLA path on every row, and the lowest index wins (query 0 is key 5 and
    its copy, key 1029)."""
    case = TILE_TIES[name]
    assert case["db"].shape[0] == 2048
    got = [x.numpy() for x in cuda_match.hamming_top2(*kernel_bench.b1_case_args(case, "cpu"))]
    ref = [np.asarray(x) for x in mj.best_two(jnp.asarray(_xla_masked(case)))]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    d1, d2, j1 = got
    assert j1[0] == 5 and d1[0] == 0.0
    found = d1 < 1e9
    assert found.sum() > 500 and (j1[found] < 1024).all() and (d2[found] == d1[found]).all()


def test_edge_cases_reach_their_edges():
    """Each case holds what it is named for, on the reference's own mask."""
    empty = {k: (_xla_masked(c) >= 1e9).all(1) for k, c in CASES.items()}
    assert empty["all_invalid_windowed"].all() and empty["all_invalid_all"].all()
    nan_inf = CASES["nan_inf"]
    assert empty["nan_inf"][:8].all()  # NaN or infinite queries pass no key
    assert not empty["nan_inf"][8] and not empty["nan_inf"][11]  # infinite radius
    assert empty["nan_inf"][9] and empty["nan_inf"][10]  # negative and NaN radius
    D = _xla_masked(nan_inf)
    assert (D[8, 1:3] < 1e9).any()  # a key at an infinite position, in an infinite window
    edge = CASES["window_edge"]
    De = _xla_masked(edge)
    rows = np.arange(48)
    assert (De[rows, rows] < 1e9).all() and (De[rows, rows + 48] >= 1e9).all()
    assert (np.abs(edge["uvq"][:48] - edge["uvk"][:48]) == edge["rad"][:48, None]).all()
    assert not empty["radius_0"][::2].all() and (CASES["radius_0"]["rad"] == 0).all()
    assert not empty["radius_wide"].any()
    dup = _xla_masked(CASES["duplicates_all"])
    assert (np.sort(dup, 1)[:, 0] == np.sort(dup, 1)[:, 1]).mean() > 0.9  # ties in d1
    assert {len(c["da"]) % 32 for c in CASES.values()} - {0}


def _meta_args(n=16, m=16, **override):
    meta = dict(device="meta")
    a = dict(desc_a=torch.zeros((n, 32), dtype=torch.uint8, **meta),
             desc_b=torch.zeros((m, 32), dtype=torch.uint8, **meta),
             valid_b=torch.ones(m, dtype=torch.bool, **meta),
             window=cuda_match.MatchWindow(
                 torch.zeros((n, 2), **meta), torch.zeros((m, 2), **meta),
                 torch.ones(n, **meta), torch.zeros(m, dtype=torch.int32, **meta),
                 torch.zeros(n, dtype=torch.int32, **meta),
                 torch.zeros(n, dtype=torch.int32, **meta)))
    for k, v in override.items():
        if k in a:
            a[k] = v
        else:
            a["window"] = a["window"]._replace(**{k: v})
    return a


@pytest.mark.parametrize("override", [
    dict(desc_b=torch.zeros((1025, 32), dtype=torch.uint8, device="meta"),
         valid_b=torch.ones(1024, dtype=torch.bool, device="meta")),
    dict(desc_b=torch.zeros((0, 32), dtype=torch.uint8, device="meta")),
    dict(desc_a=torch.zeros((16, 32), dtype=torch.int32, device="meta")),
    dict(desc_a=torch.zeros((32, 16), dtype=torch.uint8, device="meta").t()),
    dict(valid_b=torch.ones(16, dtype=torch.uint8, device="meta")),
    dict(uv_q=torch.zeros((16, 2), dtype=torch.float64, device="meta")),
    dict(uv_k=torch.zeros((2, 16), device="meta").t()),
    dict(radius_q=torch.ones(32, device="meta")[::2]),
    dict(radius_q=torch.ones(16, dtype=torch.float64, device="meta")),
    dict(octave_k=torch.zeros(16, dtype=torch.int64, device="meta")),
    dict(octave_hi=torch.zeros(16, dtype=torch.int32)),
], ids=["1025_keys", "no_keys", "int_desc", "strided_desc", "u8_valid", "f64_uv", "strided_uvk",
        "strided_radius", "f64_radius", "i64_octave", "hi_off_device"])
def test_kernel_refuses_what_it_would_misread(override, monkeypatch):
    """On a non-CPU tensor the wrapper converts nothing: a type, layout or
    device the kernel does not take, no keys, or arrays that disagree on the
    key count (1025 keys, 1024 validity flags) raise ValueError before
    anything launches (the kernel library is never reached)."""
    from orbslam3_tpu_torch.ops import _build

    def no_build():
        raise AssertionError("reached the launch")

    monkeypatch.setattr(_build, "library", no_build)
    a = _meta_args(**override)
    n0 = cuda_match.LAUNCHES
    with pytest.raises(ValueError, match="hamming_top2"):
        cuda_match.hamming_top2(a["desc_a"], a["desc_b"], a["valid_b"], a["window"])
    assert cuda_match.LAUNCHES == n0


@pytest.mark.parametrize("m", [1024, 1025, 2000, 4097])
def test_kernel_takes_one_radius_by_stride_and_any_key_count(m):
    """A shared radius (0-d or expanded) goes by stride 0, a per-query one by
    stride 1, at any key count: the kernel folds over 1024-key tiles."""
    r = torch.tensor(3.0, device="meta")
    for radius, stride in ((r, 0), (r.expand(16), 0), (torch.ones(16, device="meta"), 1)):
        a = _meta_args(m=m, radius_q=radius)
        assert cuda_match.kernel_args(**a) == (16, m, stride)
        a["window"] = None
        assert cuda_match.kernel_args(**a) == (16, m, 0)


@pytest.mark.parametrize("n_features", [300, 1200])
def test_main_path_callers_pass_the_kernels_types(monkeypatch, n_features):
    """Every B1 call of a tracked frame (motion model, local map), of the
    reference-keyframe fallback and of the mapping pass's fuse passes
    arguments the kernel takes as they are: run on the CPU with the kernel's
    checks applied to each call of the plain version. At 1200 features
    (ORB-SLAM3's EuRoC stereo setting) every call has more than one
    1024-key tile of keys."""
    seen = []
    plain = cuda_match.hamming_top2_plain

    def checked(*args):
        seen.append(cuda_match.kernel_args(*args))
        return plain(*args)

    monkeypatch.setattr(cuda_match, "hamming_top2_plain", checked)
    cfg = E.EUROC._replace(H=240, W=320, fx=230.0, fy=230.0, cx=160.0, cy=120.0,
                           n_features=n_features, n_levels=3, Kmax=16, Pmax=2048, n_kf=12,
                           n_mp=1500, n_local=1024, n_back=150, first_id=1600, ref_kf=11)
    _, args = E.entry("cpu", cfg)
    E.staged_pipeline("cpu", cfg)(*args)
    assert len(seen) == 2 and seen[1][0] == cfg.Pmax  # motion model, local map
    img, state = args[:2]
    f = feat.extract(img, cfg.orb)
    tracking._track_reference_kf(state.kf_desc[cfg.ref_kf], state.kf_feat_valid[cfg.ref_kf],
                                 state.kf_mp[cfg.ref_kf], state.mp_valid, f)
    assert len(seen) == 4  # the cross-check's two launches
    mcfg = E.MappingConfig(Kmax=16, Pmax=2048, Nf=max(768, n_features), n_kf=12, n_mp=1500,
                           n_nb=3, n_cand=256, n_window=6, n_fixed=4, n_fixed_valid=3, iters=1)
    run, (mstate,) = E.mapping_pass("cpu", mcfg)
    E.fetch_mapping(run(mstate))
    assert len(seen) == 4 + mcfg.n_nb  # one fuse launch per neighbour
    if n_features > 1024:
        assert all(m == n_features for _, m, _ in seen)
