"""K-nearest-neighbour mean squared distance (port of `knn_mean_sq_dist`
in fourdgs/ops/knn.py), the initial-scale rule of new Gaussians
(distCUDA2 semantics). Distances are d^2 = |q|^2 + |r|^2 - 2 q.r over
query chunks, so the inner product is one matmul per chunk."""

from __future__ import annotations

import torch

_BIG = 1e10


def knn_mean_sq_dist(points: torch.Tensor, valid: torch.Tensor | None = None,
                     k: int = 3, chunk: int = 2048) -> torch.Tensor:
    """Mean squared distance from each point to its k nearest *other*
    points. Invalid points get 0; a query with fewer than k valid
    neighbours averages over zeros in place of the missing ones."""
    n = points.shape[0]
    r_sq = torch.sum(points * points, dim=-1)
    bias = torch.zeros_like(r_sq) if valid is None else torch.where(
        valid, torch.zeros_like(r_sq), torch.full_like(r_sq, _BIG)
    )
    kk = min(k, n)
    out = []
    for base in range(0, n, chunk):
        q = points[base:base + chunk]
        q_sq = torch.sum(q * q, dim=-1, keepdim=True)
        d2 = q_sq + r_sq[None, :] - 2.0 * (q @ points.T) + bias[None, :]
        rows = torch.arange(q.shape[0], device=points.device)
        d2[rows, base + rows] = _BIG  # exclude self
        out.append(torch.topk(d2, kk, dim=1, largest=False).values)
    d2 = torch.clamp(torch.cat(out), min=0.0) if n else points.new_zeros((0, kk))
    d2 = torch.where(d2 >= _BIG * 0.5, torch.zeros_like(d2), d2)
    if kk < k:
        d2 = torch.cat([d2, d2.new_zeros((n, k - kk))], dim=1)
    mean = torch.mean(d2, dim=-1)
    if valid is not None:
        mean = torch.where(valid, mean, torch.zeros_like(mean))
    return mean
