# Frozen copy of fourdgs_torch/ops/knn.py (lines 1-111,
# commit c19f610): the port's plain path, kept as the benchmark's
# reference, unchanged but for its imports, which name these copies.
"""K-nearest-neighbour ops (port of fourdgs/ops/knn.py).

  - `knn_mean_sq_dist`: the initial-scale rule of new Gaussians (distCUDA2
    semantics),
  - `knn_indices`: the control-node neighbours of the 4D path (its blend
    weights are `models/deform.py` `blend_weights`),
  - `farthest_point_sample`: control-node placement,
  - `voxel_downsample_mask`: the first point per voxel, on the host (the
    reference's `native` module, whose numpy fallback this is).

Distances are d^2 = |q|^2 + |r|^2 - 2 q.r, one matmul per query chunk,
clamped at 0, with invalid references pushed back by a large bias, as in
the reference (`torch.cdist` rounds otherwise and picks other neighbours
on near-ties). Neighbours come from a stable sort, so exact ties go to the
lower index, as `lax.top_k` breaks them.
"""

from __future__ import annotations

import numpy as np
import torch

_BIG = 1e10
CHUNK = 8192   # queries per distance matrix in knn_indices


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def _sq_dists(q: torch.Tensor, refs: torch.Tensor, r_sq: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """(..., nq, nr) d^2 = |q|^2 + |r|^2 - 2 q.r + bias (unclamped)."""
    return (_sq_norm(q)[..., :, None] + r_sq[..., None, :]
            - 2.0 * (q @ refs.transpose(-1, -2)) + bias[..., None, :])


def _bias(r_sq: torch.Tensor, ref_valid: torch.Tensor | None) -> torch.Tensor:
    if ref_valid is None:
        return torch.zeros_like(r_sq)
    return torch.where(ref_valid, torch.zeros_like(r_sq), torch.full_like(r_sq, _BIG))


def knn_indices(queries: torch.Tensor, refs: torch.Tensor, k: int,
                ref_valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., Nq, 3) x (..., Nr, 3) -> (sq_dists (..., Nq, k), indices
    (..., Nq, k) int64), nearest first. Leading axes batch."""
    r_sq = _sq_norm(refs)
    bias = _bias(r_sq, ref_valid)
    d2s, idxs = [], []
    for base in range(0, queries.shape[-2], CHUNK):
        d2 = _sq_dists(queries[..., base:base + CHUNK, :], refs, r_sq, bias)
        d2, idx = torch.sort(d2, dim=-1, stable=True)
        d2s.append(d2[..., :k])
        idxs.append(idx[..., :k])
    return torch.clamp(torch.cat(d2s, dim=-2), min=0.0), torch.cat(idxs, dim=-2)


def knn_mean_sq_dist(points: torch.Tensor, valid: torch.Tensor | None = None,
                     k: int = 3, chunk: int = 2048) -> torch.Tensor:
    """Mean squared distance from each point to its k nearest *other*
    points. Invalid points get 0; a query with fewer than k valid
    neighbours averages over zeros in place of the missing ones."""
    n = points.shape[0]
    r_sq = torch.sum(points * points, dim=-1)
    bias = _bias(r_sq, valid)
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


def farthest_point_sample(points: torch.Tensor, valid: torch.Tensor, n_samples: int,
                          start: torch.Tensor | int) -> torch.Tensor:
    """Farthest-point sampling over the valid points, from index `start`
    (a draw weighted by `valid`). Returns (n_samples,) int64 indices; an
    invalid point is never picked after the start. The steps stay on the
    device: no step reads a value back to the host."""
    n = points.shape[0]
    sel = torch.empty(n_samples, dtype=torch.long, device=points.device)
    cur = torch.as_tensor(start, dtype=torch.long, device=points.device).reshape(())
    min_d2 = torch.full((n,), float("inf"), dtype=points.dtype, device=points.device)
    neg_inf = torch.full_like(min_d2, -float("inf"))
    for s in range(n_samples):
        sel[s] = cur
        min_d2 = torch.minimum(min_d2, _sq_norm(points - points[cur]))
        cur = torch.argmax(torch.where(valid, min_d2, neg_inf))
    return sel


def voxel_downsample_mask(points: np.ndarray, voxel: float) -> np.ndarray:
    """(N,) bool keep-mask of (N, 3) host points: the first point of each
    voxel of side `voxel`, in input order."""
    key = np.floor(np.ascontiguousarray(points, np.float32) / voxel).astype(np.int64)
    _, first = np.unique(key, axis=0, return_index=True)
    keep = np.zeros(key.shape[0], bool)
    keep[first] = True
    return keep
