# Frozen copy of fourdgs_torch/ops/rasterize/oracle.py (lines 1-118,
# commit c19f610): the port's plain path, kept as the benchmark's
# reference, unchanged but for its imports, which name these copies.
"""Dense reference compositor, the test oracle (port of
fourdgs/ops/rasterize/oracle.py).

The compositing semantics of the CUDA renderCUDA loop in closed form:

  alpha_i   = min(0.99, op_i * exp(power_i)),  skip if power>0 or alpha<1/255
  T_i       = prod_{j<=i, valid} (1 - alpha_j)
  applied_i = valid_i & (T_i >= 1e-4)
  w_i       = applied_i * alpha_i * T_{i-1}
  C         = sum w_i c_i + T_final * bg ;  D = sum w_i depth_i
  n_touched_i = #pixels with applied_i & (T_i > 0.5)

with the getRect tile-rectangle membership test. O(N*H*W) memory: tests
only; the tile compositor in compositor.py is what renders.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.ops.rasterize.preprocess import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_EPS,
    ScreenGaussians,
)


class RenderOutputs(NamedTuple):
    color: torch.Tensor      # ([V,] C, H, W)
    depth: torch.Tensor      # ([V,] H, W)
    alpha: torch.Tensor      # ([V,] H, W) accumulated opacity
    n_touched: torch.Tensor  # ([V,] N) int32
    T_final: torch.Tensor    # ([V,] H, W)
    radii: torch.Tensor      # ([V,] N) int32 screen-space radius (0 = culled)
    # () bool — more pairs were binned than `RasterConfig.max_pairs`.
    # The port has no fixed pair buffer and renders every pair; the flag
    # keeps the reference's capacity signal. False on the oracle path.
    overflow: torch.Tensor
    # () int — (tile, gaussian) pairs binned (max over views). 0 on the
    # oracle path.
    num_pairs: torch.Tensor


def composite_oracle(
    sg: ScreenGaussians,
    bg: torch.Tensor,
    width: int,
    height: int,
    tile: int = 16,
) -> RenderOutputs:
    n = sg.mean2d.shape[0]
    nch = sg.color.shape[1]
    dev = sg.mean2d.device
    inf = torch.full_like(sg.depth, float("inf"))
    order = torch.argsort(torch.where(sg.visible, sg.depth, inf), stable=True)
    mx = sg.mean2d[order, 0][:, None]
    my = sg.mean2d[order, 1][:, None]
    ca = sg.conic[order, 0][:, None]
    cb = sg.conic[order, 1][:, None]
    cc = sg.conic[order, 2][:, None]
    op = sg.opacity[order][:, None]
    col = sg.color[order]
    dep = sg.depth[order][:, None]
    rad = sg.radius[order].to(torch.float32)[:, None]
    vis = sg.visible[order][:, None]

    v, u = torch.meshgrid(
        torch.arange(height, device=dev), torch.arange(width, device=dev), indexing="ij"
    )
    px = u.reshape(-1).to(torch.float32)[None, :]
    py = v.reshape(-1).to(torch.float32)[None, :]

    tx_n = -(-width // tile)
    ty_n = -(-height // tile)
    tx0 = torch.clamp(torch.floor((mx - rad) / tile), 0, tx_n)
    ty0 = torch.clamp(torch.floor((my - rad) / tile), 0, ty_n)
    tx1 = torch.clamp(torch.floor((mx + rad + tile - 1) / tile), 0, tx_n)
    ty1 = torch.clamp(torch.floor((my + rad + tile - 1) / tile), 0, ty_n)
    ptx = torch.floor(px / tile)
    pty = torch.floor(py / tile)
    member = (ptx >= tx0) & (ptx < tx1) & (pty >= ty0) & (pty < ty1)

    dx = mx - px
    dy = my - py
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
    valid = member & vis & (power <= 0.0) & (alpha >= ALPHA_MIN)

    zero = torch.zeros_like(alpha)
    la = torch.where(valid, torch.log1p(-alpha), zero)
    cum = torch.cumsum(la, dim=0)
    T_incl = torch.exp(cum)
    applied = valid & (T_incl >= T_EPS)
    T_before = torch.exp(cum - la)
    w = torch.where(applied, alpha * T_before, zero)

    color_flat = col.T @ w
    depth_flat = torch.sum(w * dep, dim=0)
    T_final = torch.exp(torch.sum(torch.where(applied, la, zero), dim=0))
    color_flat = color_flat + T_final[None, :] * bg[:, None]

    touched_sorted = torch.sum((applied & (T_incl > 0.5)).to(torch.int32), dim=1)
    n_touched = torch.zeros((n,), dtype=torch.int32, device=dev)
    n_touched[order] = touched_sorted.to(torch.int32)

    return RenderOutputs(
        color=color_flat.reshape(nch, height, width),
        depth=depth_flat.reshape(height, width),
        alpha=(1.0 - T_final).reshape(height, width),
        n_touched=n_touched,
        T_final=T_final.reshape(height, width),
        radii=sg.radius,
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        num_pairs=torch.zeros((), dtype=torch.int64, device=dev),
    )
