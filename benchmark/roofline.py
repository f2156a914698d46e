"""Operations and bytes a compositor call needs, the deformation MLP's
products, and the published peaks of one NVIDIA H100 (SXM, 700 W).

Copied from chip_smoke.py (commit c19f610): the peaks and the per
(pixel, pair) operation counts from lines 221-229, `work_counts` from
lines 238-253, and the byte and operation sums of `compare_kernels` from
lines 285-296. The work is counted from a call's inputs: the pairs each
pixel visits up to its last applied pair, and those it applies, each
input byte read once and each output byte written once. It never depends
on how a kernel does the work, so a change that fuses or replaces a
kernel leaves the count as it was.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.ops.rasterize import compositor as C

PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_OPS_S = 67e12  # H100 SXM float32 outside the tensor cores
# per (pixel, pair) operation counts of the compositor's arithmetic
# (composite_common.cuh, composite_fwd.cu, composite_bwd.cu): every add,
# multiply, compare, min/max, divide, exp and log1p counts as one
FWD_OPS_VISITED = 16   # dx, dy, power, exp, op*e, clamp, two validity tests
FWD_OPS_APPLIED = 18   # log1p, cum, exp, T test, 1/(1-alpha), t_before, w, 4 fma, T>0.5
BWD_OPS_VISITED = 16
BWD_OPS_APPLIED = 65   # recompute, T recovery, u, dalpha, suffix, 10 gradients and sums


class Bins(NamedTuple):
    """The tile ranges a compositor call takes."""

    pair_gid: torch.Tensor
    tile_start: torch.Tensor
    tile_count: torch.Tensor


class Work(NamedTuple):
    fwd_ops: float
    fwd_bytes: float
    bwd_ops: float
    bwd_bytes: float


def work_counts(fields, bins: Bins, grid: C.TileGrid, n_contrib) -> tuple[int, int]:
    """(pairs visited, pairs applied) over all pixels up to each pixel's
    last applied pair: the work this data needs."""
    px, py, _ = C._pixels(bins.tile_start.shape[0], grid, fields.device)
    kmax = int(bins.tile_count.max()) if bins.tile_count.numel() else 0
    applied = 0
    for k0 in range(0, kmax, C.KB):
        kb = min(C.KB, kmax - k0)
        *_, valid = C._pair_block(fields, bins, k0, kb, px, py, grid)
        k = torch.arange(k0, k0 + kb, device=fields.device)
        applied += int((valid & (k[None, :, None] < n_contrib[:, None])).sum())
    return int(n_contrib.sum()), applied


def call_work(fields, pair_gid, tile_start, tile_count, n_contrib, *, tiles_per_view: int,
              tx_n: int, width: int, height: int) -> Work:
    """The operations and bytes of one forward and of one backward
    compositor call on these inputs (`n_contrib` is the forward's)."""
    bins = Bins(pair_gid, tile_start, tile_count)
    grid = C.TileGrid(tx_n, tiles_per_view // tx_n, width, height)
    visited, applied = work_counts(fields, bins, grid, n_contrib)
    v, n1, _ = fields.shape
    n_pairs = int(pair_gid.numel())
    view_of_pair = torch.repeat_interleave(
        torch.arange(tile_count.numel(), device=fields.device) // tiles_per_view,
        tile_count.long())
    rows = int(torch.unique(pair_gid.long() + view_of_pair * n1).numel())
    vt = int(tile_start.numel())
    npix = vt * C.NPIX
    fwd_bytes = rows * 40 + n_pairs * 4 + vt * 8 + npix * (5 * 4 + 4) + v * n1 * 4
    bwd_bytes = rows * 40 + n_pairs * 4 + vt * 8 + npix * (4 + 4 + 5 * 4) + rows * 40
    fwd_ops = FWD_OPS_VISITED * visited + FWD_OPS_APPLIED * applied
    bwd_ops = BWD_OPS_VISITED * (visited - applied) + BWD_OPS_APPLIED * applied
    return Work(float(fwd_ops), float(fwd_bytes), float(bwd_ops), float(bwd_bytes))


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the float32
    peak or bytes at the memory peak, whichever is longer."""
    return max(ops / PEAK_FP32_OPS_S, nbytes / PEAK_BYTES_S)


def mlp_ops(weights, rows: int, backward: bool) -> float:
    """Float32 operations of an MLP's products on `rows` points: 2 per
    multiply-add of each layer's (rows, d_in) x (d_in, d_out) product,
    and twice that again for the backward (the gradients of the input and
    of the weight)."""
    fwd = sum(2.0 * rows * w.shape[0] * w.shape[1] for w in weights)
    return fwd * (3.0 if backward else 1.0)
