"""Two-view reconstruction for monocular initialization on torch tensors —
the H/F part of `orbslam3_tpu/ops/ransac.py` (`TwoViewReconstruction.cc`).

The reference's `vmap`s over the 200 hypotheses and the 12 motion
candidates are batched tensor ops here. All geometry is in normalized
camera coordinates (z = 1 plane), as in the reference.

Sampling: the reference draws the 200x8 minimal sets with
`jax.random.categorical` over `log(valid)`, i.e. uniformly over the valid
matches with replacement. The port draws the same distribution with
`torch.multinomial(..., replacement=True)` from an explicit generator, or
takes the draws as `samples` (the parity tests pass JAX's own).

Signs: singular vectors come with arbitrary signs, which differ between
LAPACK, cuSOLVER and XLA. H and F are scored sign-invariantly, the DLT point
is dehomogenized, and the motion decompositions enumerate both signs and fix
the rotation's through its determinant, so the winning (R, t) is the same;
only its index among the 12 candidates may differ.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TH_H_PX = 5.991
TH_F_PX = 3.841
TH_SCORE_PX = 5.991
N_HYPOTHESES = 200  # ref mMaxIterations
SAMPLE = 8


class TwoViewResult(NamedTuple):
    success: torch.Tensor  # () bool
    R: torch.Tensor  # (3,3) R21 (cam2 <- cam1 == world frame of cam1)
    t: torch.Tensor  # (3,) unit norm
    points: torch.Tensor  # (N,3) triangulated in cam1 frame
    is_good: torch.Tensor  # (N,) bool — triangulated with parallax + cheirality
    used_homography: torch.Tensor  # () bool


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """(..., n, 9) -> (..., 9): the last right singular vector. A minimal
    8-row system needs the full 9x9 V (`full_matrices=True`, as the
    reference); with >= 9 rows the reduced V is the same 9x9 matrix."""
    _, _, vt = torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1])
    return vt[..., -1, :]


def _dlt_homography(p1: torch.Tensor, p2: torch.Tensor, weights=None) -> torch.Tensor:
    """H21 from >= 4 correspondences by DLT (`ComputeH21`); leading axes
    batch."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    if weights is not None:
        r1 = r1 * weights[..., None]
        r2 = r2 * weights[..., None]
    A = torch.cat([r1, r2], dim=-2)  # (..., 2n, 9)
    return _null_vector(A).reshape(*A.shape[:-2], 3, 3)


def _eight_point_F(p1: torch.Tensor, p2: torch.Tensor, weights=None) -> torch.Tensor:
    """F21 by the 8-point algorithm + rank-2 projection (`ComputeF21`);
    with `weights`, a weighted refit over any number of correspondences."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], dim=-1)
    if weights is not None:
        A = A * weights[..., None]
    F = _null_vector(A).reshape(*A.shape[:-2], 3, 3)
    u, s, vt2 = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return u @ torch.diag_embed(s) @ vt2


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _score_homography(H21, p1, p2, valid, th, th_score):
    """Symmetric transfer chi2 score (`CheckHomography`). H21 (..., 3, 3)
    against the N correspondences; returns (score (...,), inliers (..., N))."""
    H12 = torch.linalg.inv(H21)

    def transfer(H, a, b):
        bh = _homog(a) @ H.transpose(-1, -2)
        w = bh[..., 2:3]
        proj = bh[..., :2] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
        return torch.sum((proj - b) ** 2, dim=-1)

    chi21 = transfer(H21, p1, p2)
    chi12 = transfer(H12, p2, p1)
    ok = valid & (chi21 < th) & (chi12 < th)
    score = torch.sum(torch.where(valid & (chi21 < th), th_score - chi21, 0.0)
                      + torch.where(valid & (chi12 < th), th_score - chi12, 0.0), dim=-1)
    return score, ok


def _score_fundamental(F21, p1, p2, valid, th, th_score):
    """Epipolar line distance chi2 (`CheckFundamental`); batched as
    `_score_homography`."""
    p1h = _homog(p1)
    p2h = _homog(p2)
    l2 = p1h @ F21.transpose(-1, -2)  # epipolar lines in image 2
    l1 = p2h @ F21  # in image 1
    d2 = torch.sum(l2 * p2h, dim=-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d1 = torch.sum(l1 * p1h, dim=-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    ok = valid & (d1 < th) & (d2 < th)
    score = torch.sum(torch.where(valid & (d2 < th), th_score - d2, 0.0)
                      + torch.where(valid & (d1 < th), th_score - d1, 0.0), dim=-1)
    return score, ok


def triangulate_linear(R, t, p1, p2):
    """DLT triangulation (`Triangulate`): cam1 = [I|0], cam2 = [R|t] in
    normalized coordinates. R (..., 3, 3), t (..., 3) batch over motions;
    p1, p2 (N, 2) -> (..., N, 3) in the cam1 frame."""
    lead = R.shape[:-2]
    P1 = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device),
                    torch.zeros(3, 1, dtype=R.dtype, device=R.device)], dim=1)
    P1 = P1.expand(*lead, 3, 4)
    P2 = torch.cat([R, t[..., :, None]], dim=-1)  # (..., 3, 4)

    def rows(P, p):  # (..., 3, 4), (N, 2) -> (..., N, 2, 4)
        P = P[..., None, :, :]
        return torch.stack([p[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                            p[..., 1:2] * P[..., 2, :] - P[..., 1, :]], dim=-2)

    A = torch.cat([rows(P1, p1), rows(P2, p2)], dim=-2)  # (..., N, 4, 4)
    _, _, vt = torch.linalg.svd(A)
    X = vt[..., -1, :]
    w = X[..., 3:4]
    return X[..., :3] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)


def _check_rt(R, t, p1, p2, valid, th, min_parallax_cos=0.99998):
    """Cheirality + reprojection + parallax check (`CheckRT`) of motion
    hypotheses R (..., 3, 3), t (..., 3). Returns (n_good (...,), good
    (..., N), points (..., N, 3))."""
    X = triangulate_linear(R, t, p1, p2)
    z1 = X[..., 2]
    X2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = X2[..., 2]
    O2 = -(R.transpose(-1, -2) @ t[..., :, None])[..., 0]  # cam2 centre in cam1
    r2 = X - O2[..., None, :]
    cosp = torch.sum(X * r2, dim=-1) / (
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(r2, dim=-1) + 1e-12)
    e1 = torch.sum((X[..., :2] / torch.clamp(z1[..., None], min=1e-9) - p1) ** 2, dim=-1)
    e2 = torch.sum((X2[..., :2] / torch.clamp(z2[..., None], min=1e-9) - p2) ** 2, dim=-1)
    finite = torch.all(torch.isfinite(X), dim=-1)
    good = (valid & finite & (z1 > 0) & (z2 > 0) & (e1 < th) & (e2 < th)
            & (cosp < min_parallax_cos))
    return good.to(torch.int32).sum(-1), good, X


def _decompose_E(E):
    """The 4 motion hypotheses of an essential matrix (`DecomposeE`)."""
    u, _, vt = torch.linalg.svd(E)
    Wm = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                      dtype=E.dtype, device=E.device)
    R1 = u @ Wm @ vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = u @ Wm.T @ vt
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = u[:, 2]
    t = t / (torch.linalg.norm(t) + 1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_H(H):
    """The 8 motion hypotheses of a homography (Faugeras' SVD method,
    `ReconstructH`)."""
    U, w, Vt = torch.linalg.svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / torch.clamp(d1 * d1 - d3 * d3, min=1e-12),
                                  min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / torch.clamp(d1 * d1 - d3 * d3, min=1e-12),
                                  min=0.0))
    sg1 = (1.0, 1.0, -1.0, -1.0)
    sg3 = (1.0, -1.0, 1.0, -1.0)
    cross = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    one, zero = torch.ones_like(d1), torch.zeros_like(d1)

    Rs, ts = [], []
    # d' = d2: [[ct, 0, -st], [0, 1, 0], [st, 0, ct]]
    st = cross / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    for i in range(4):
        sgn = 1.0 if i in (0, 3) else -1.0
        sn = st * sgn
        Rp = torch.stack([torch.stack([ct, zero, -sn]), torch.stack([zero, one, zero]),
                          torch.stack([sn, zero, ct])])
        Rs.append(s * U @ Rp @ Vt)
        t = U @ (torch.stack([sg1[i] * aux1, zero, -sg3[i] * aux3]) * (d1 - d3))
        ts.append(t / (torch.linalg.norm(t) + 1e-12))
    # d' = -d2: [[cphi, 0, sphi], [0, -1, 0], [sphi, 0, -cphi]]
    sphi = cross / torch.clamp((d1 - d3) * d2, min=1e-12)
    cphi = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    for i in range(4):
        sgn = 1.0 if i in (0, 3) else -1.0
        sp = sphi * sgn
        Rp = torch.stack([torch.stack([cphi, zero, sp]), torch.stack([zero, -one, zero]),
                          torch.stack([sp, zero, -cphi])])
        Rs.append(s * U @ Rp @ Vt)
        t = U @ (torch.stack([sg1[i] * aux1, zero, sg3[i] * aux3]) * (d1 + d3))
        ts.append(t / (torch.linalg.norm(t) + 1e-12))
    return torch.stack(Rs), torch.stack(ts)


def reconstruct_two_views(p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          sigma_norm: float = 1.0 / 450.0, min_triangulated: int = 50,
                          samples: Optional[torch.Tensor] = None) -> TwoViewResult:
    """Monocular initialization (`Reconstruct`): 200 H and 200 F
    hypotheses, model choice by the score ratio (RH > 0.40 -> H), motion
    recovery with cheirality voting and the clear-winner rule. `p1`, `p2`
    (N, 2) normalized coordinates of the matches, `valid` (N,). The minimal
    sets come from `samples` (200, 8) when given, else from `generator`."""
    inv_s2 = 1.0 / (sigma_norm * sigma_norm)
    th_h = TH_H_PX / inv_s2
    th_f = TH_F_PX / inv_s2
    th_sc = TH_SCORE_PX / inv_s2

    if samples is None:
        samples = torch.multinomial(valid.to(torch.float32), N_HYPOTHESES * SAMPLE,
                                    replacement=True, generator=generator)
    samples = samples.reshape(N_HYPOTHESES, SAMPLE).to(torch.int64)
    sp1, sp2 = p1[samples], p2[samples]  # (200, 8, 2)

    H_all = _dlt_homography(sp1, sp2)
    F_all = _eight_point_F(sp1, sp2)
    score_H, _ = _score_homography(H_all, p1, p2, valid, th_h, th_sc)
    score_F, _ = _score_fundamental(F_all, p1, p2, valid, th_f, th_sc)

    best_h = torch.argmax(score_H)
    best_f = torch.argmax(score_F)
    SH, SF = score_H[best_h], score_F[best_f]
    _, inl_H = _score_homography(H_all[best_h], p1, p2, valid, th_h, th_sc)
    _, inl_F = _score_fundamental(F_all[best_f], p1, p2, valid, th_f, th_sc)
    # Refit each winner on all its inliers (weighted DLT).
    H = _dlt_homography(p1, p2, weights=inl_H.to(p1.dtype))
    F = _eight_point_F(p1, p2, weights=inl_F.to(p1.dtype))
    _, inl_H = _score_homography(H, p1, p2, valid, th_h, th_sc)
    _, inl_F = _score_fundamental(F, p1, p2, valid, th_f, th_sc)
    RH = SH / torch.clamp(SH + SF, min=1e-12)
    use_H = RH > 0.40  # the reference's bias toward H on planar scenes

    # 8 motions from H, 4 from E (= F in normalized coordinates); all 12
    # evaluated, the other model's masked.
    Rs_h, ts_h = _decompose_H(H)
    Rs_e, ts_e = _decompose_E(F)
    Rs = torch.cat([Rs_h, Rs_e])
    ts = torch.cat([ts_h, ts_e])
    from_H = torch.arange(12, device=p1.device) < 8
    hyp_valid = torch.where(use_H, from_H, ~from_H)
    inl = torch.where(use_H, inl_H, inl_F)

    th_rt = 4.0 * (sigma_norm * sigma_norm)  # ref th2 = 4 sigma^2
    n_good, good, X = _check_rt(Rs, ts, p1, p2, inl, th_rt)
    n_good = torch.where(hyp_valid, n_good, -1)
    best = torch.argmax(n_good)
    n_best = n_good[best]
    second = torch.sort(n_good, descending=True)[0][1]
    n_inliers = inl.to(torch.int32).sum()
    success = ((n_best >= min_triangulated) & (n_best > 0.9 * n_inliers * 0.5)
               & (second < 0.75 * n_best))
    return TwoViewResult(success=success, R=Rs[best], t=ts[best], points=X[best],
                         is_good=good[best], used_homography=use_H)
