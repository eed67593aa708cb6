"""Plain Hamming top-2 with the projection window: the function kernel B1
computes. Distances by XOR and a popcount table, in integers; a masked
pair reads INF = 1e9; the best is the lowest index among ties, and the
second is the least distance of the other keys (equal to the best when the
best is tied)."""

from __future__ import annotations

import torch

INF = 1e9
_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def window_mask(uv_q, uv_k, radius, octave_k=None, octave_lo=None, octave_hi=None):
    """(N, M) bool: key inside the query's pixel window and octave band."""
    du = torch.abs(uv_q[:, 0:1] - uv_k[None, :, 0])
    dv = torch.abs(uv_q[:, 1:2] - uv_k[None, :, 1])
    r = torch.as_tensor(radius, dtype=torch.float32, device=uv_q.device)
    r = r.expand(uv_q.shape[0])[:, None]
    m = (du <= r) & (dv <= r)
    if octave_k is not None:
        if octave_lo is not None:
            m &= octave_k[None, :] >= octave_lo[:, None]
        if octave_hi is not None:
            m &= octave_k[None, :] <= octave_hi[:, None]
    return m


def hamming(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(N, 32) x (M, 32) uint8 -> (N, M) int32 Hamming distances."""
    table = _POPCOUNT.to(desc_a.device)
    x = desc_a[:, None, :] ^ desc_b[None, :, :]
    return table[x.to(torch.int32)].sum(-1, dtype=torch.int32)


def top2(desc_a, desc_b, valid_b=None, window=None, block: int = 512):
    """(best (N,) f32, second (N,) f32, argbest (N,) int32) per query row;
    `window` is (uv_q, uv_k, radius, octave_k, octave_lo, octave_hi)."""
    n = desc_a.shape[0]
    d1s, d2s, js = [], [], []
    for i in range(0, n, block):
        j = min(n, i + block)
        D = hamming(desc_a[i:j], desc_b).to(torch.float32)
        if valid_b is not None:
            D = torch.where(valid_b[None, :], D, INF)
        if window is not None:
            uv_q, uv_k, r, ok, lo, hi = window
            r = torch.as_tensor(r)
            ri = r if r.dim() == 0 or r.numel() == 1 else r[i:j]
            m = window_mask(uv_q[i:j], uv_k, ri, ok, None if lo is None else lo[i:j],
                            None if hi is None else hi[i:j])
            D = torch.where(m, D, INF)
        a = torch.argmin(D, dim=1)
        d1 = D.gather(1, a[:, None])[:, 0]
        d2 = D.scatter(1, a[:, None], float("inf")).amin(dim=1)
        d1s.append(d1)
        d2s.append(d2)
        js.append(a.to(torch.int32))
    return torch.cat(d1s), torch.cat(d2s), torch.cat(js)
