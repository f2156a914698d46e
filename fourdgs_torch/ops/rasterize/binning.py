"""Tile binning: expand Gaussians to (tile, depth)-sorted pairs (port of
fourdgs/ops/rasterize/binning.py).

The rect math is CUDA `getRect` (auxiliary.h): tiles
[(p-r)/T, (p+r+T-1)/T) clamped to the grid, enumerated row-major in at
most `max_rect` candidate slots; `preprocess(max_radius=...)` caps radii
so the true rect fits. The opacity-aware cull drops candidate tiles that
provably receive alpha < 1/255 everywhere.

The output is a flat pair list sorted by (view, tile, depth, Gaussian id)
with each tile's range — the order the reference's stable sort produces.
The port has no fixed pair buffer, so none of the reference's CHUNK
alignment, pad sentinels or per-Gaussian candidate tables exist here: the
backward kernel sums per-Gaussian gradients with atomics instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fourdgs_torch.utils.trace import sync


class TileBins(NamedTuple):
    pair_gid: torch.Tensor    # (P,) int32 Gaussian id of each pair
    tile_start: torch.Tensor  # (V*T,) int32 offset of each tile's range
    tile_count: torch.Tensor  # (V*T,) int32 pairs in each tile
    num_pairs: torch.Tensor   # (V,) int64 pairs binned per view
    overflow: torch.Tensor    # (V,) bool — num_pairs > the configured max_pairs


def tile_grid(width: int, height: int, tile: int) -> tuple[int, int]:
    return (-(-width // tile), -(-height // tile))


def bin_gaussians(
    mean2d: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    visible: torch.Tensor,
    *,
    width: int,
    height: int,
    tile: int = 16,
    max_rect: int = 16,
    max_pairs: int = 1 << 18,
    opacity: torch.Tensor | None = None,
    cull_radius: torch.Tensor | None = None,
) -> TileBins:
    """Bin (N,)-shaped inputs of one view, or (V, N)-shaped inputs of V
    views into one pair list whose tile ids run v * T + t."""
    if mean2d.dim() == 2:
        mean2d, depth, radius, visible = (
            a[None] for a in (mean2d, depth, radius, visible)
        )
        opacity = None if opacity is None else opacity[None]
        cull_radius = None if cull_radius is None else cull_radius[None]
    mean2d, depth = mean2d.detach(), depth.detach()
    v_n = mean2d.shape[0]
    dev = mean2d.device
    tx_n, ty_n = tile_grid(width, height, tile)
    num_tiles = tx_n * ty_n

    mx, my = mean2d[..., 0], mean2d[..., 1]
    r = radius.to(mx.dtype)
    tx0 = torch.clamp(torch.floor((mx - r) / tile), 0, tx_n).to(torch.int32)
    ty0 = torch.clamp(torch.floor((my - r) / tile), 0, ty_n).to(torch.int32)
    tx1 = torch.clamp(torch.floor((mx + r + tile - 1) / tile), 0, tx_n).to(torch.int32)
    ty1 = torch.clamp(torch.floor((my + r + tile - 1) / tile), 0, ty_n).to(torch.int32)

    rect_w = tx1 - tx0
    touched_rect = torch.where(visible, rect_w * (ty1 - ty0), torch.zeros_like(rect_w))
    touched_rect = torch.clamp(touched_rect, max=max_rect)

    slot = torch.arange(max_rect, dtype=torch.int32, device=dev)
    safe_w = torch.clamp(rect_w, min=1)[..., None]
    d_ty = torch.div(slot, safe_w, rounding_mode="floor")
    d_tx = slot - d_ty * safe_w
    cand_tile = (ty0[..., None] + d_ty) * tx_n + (tx0[..., None] + d_tx)
    cand_ok = slot < touched_rect[..., None]

    if opacity is not None:
        # opacity-aware culling (equivalence-preserving): alpha <=
        # op * exp(-4.5 d^2 / s^2) for s = the UNCAPPED 3-sigma radius, so
        # a candidate tile whose nearest pixel lies beyond
        # d_max = s * sqrt(ln(255 op) / 4.5) contributes exactly zero
        rc = r if cull_radius is None else cull_radius.detach().to(mx.dtype)
        rc = torch.maximum(rc, r)
        tlo_x = ((tx0[..., None] + d_tx) * tile).to(mx.dtype)
        tlo_y = ((ty0[..., None] + d_ty) * tile).to(mx.dtype)
        nx = torch.minimum(torch.maximum(mx[..., None], tlo_x), tlo_x + (tile - 1))
        ny = torch.minimum(torch.maximum(my[..., None], tlo_y), tlo_y + (tile - 1))
        d2 = (mx[..., None] - nx) ** 2 + (my[..., None] - ny) ** 2
        op = torch.clamp(opacity.detach(), min=1.0 / 255.0)
        dmax2 = (rc * rc * (torch.log(255.0 * op) / 4.5))[..., None]
        cand_ok = cand_ok & (d2 <= dmax2)

    # compaction, then two stable sorts: by depth, then by tile. The
    # candidates enter in (view, gaussian, slot) order, so ties keep the
    # reference's stable-sort order (lower Gaussian id first).
    with sync("bin.nonzero"):
        vi, gi, si = cand_ok.nonzero(as_tuple=True)
    tile_g = vi * num_tiles + cand_tile[vi, gi, si].to(torch.int64)
    order = torch.argsort(depth[vi, gi], stable=True)
    order = order[torch.argsort(tile_g[order], stable=True)]
    pair_gid = gi[order].to(torch.int32)

    # bincount reads its input's least and largest value on the host
    reads = 2 if vi.numel() else 0
    with sync("bin.tile_count", reads):
        tile_count = torch.bincount(tile_g, minlength=v_n * num_tiles)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    with sync("bin.view_pairs", reads):
        num_pairs = torch.bincount(vi, minlength=v_n)
    return TileBins(
        pair_gid=pair_gid,
        tile_start=tile_start.to(torch.int32),
        tile_count=tile_count.to(torch.int32),
        num_pairs=num_pairs,
        overflow=num_pairs > max_pairs,
    )


def cat_bins(a: TileBins, b: TileBins) -> TileBins:
    """Views of `a` then views of `b` as one multi-view TileBins."""
    return TileBins(
        pair_gid=torch.cat([a.pair_gid, b.pair_gid]),
        tile_start=torch.cat([a.tile_start, b.tile_start + a.pair_gid.shape[0]]),
        tile_count=torch.cat([a.tile_count, b.tile_count]),
        num_pairs=torch.cat([a.num_pairs, b.num_pairs]),
        overflow=torch.cat([a.overflow, b.overflow]),
    )
