"""Differentiable Gaussian-splat rendering: preprocess -> bin -> composite
(port of fourdgs/ops/rasterize/api.py).

Camera-pose gradients flow through `T_cw` by autograd (callers
parameterize `T_cw = se3_exp(tau) @ T_cw0` and differentiate with respect
to tau). One render of V views is one launch of each compositor kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fourdgs_torch.ops.rasterize.binning import TileBins, bin_gaussians, tile_grid
from fourdgs_torch.ops.rasterize.compositor import NOUT, TILE, TileGrid, composite
from fourdgs_torch.ops.rasterize.oracle import RenderOutputs
from fourdgs_torch.ops.rasterize.preprocess import preprocess
from fourdgs_torch.utils.trace import span


class RasterConfig(NamedTuple):
    """Rasterizer capacity knobs. Tiles are always TILE x TILE pixels:
    the compositor kernels are written for that size."""

    max_rect: int = 16        # max tiles a Gaussian may touch (4x4)
    max_pairs: int = 1 << 18  # pair count above which `overflow` is raised

    @property
    def max_radius(self) -> int:
        # biggest radius whose getRect fits max_rect: a rect side of s
        # tiles covers radius r when 2r + tile - 1 < s*tile
        side = int(self.max_rect ** 0.5)
        return ((side - 1) * TILE) // 2


def ndc_project(x: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """Points (..., N, 3) through full projections (..., 4, 4) (proj @ T_cw)
    to NDC (..., N, 3): the flow payload's one projection."""
    hom = x @ full[..., :3, :3].transpose(-1, -2) + full[..., None, :3, 3]
    w = x @ full[..., 3:4, :3].transpose(-1, -2) + full[..., None, 3:4, 3]
    return hom / (w + 1e-7)


def flow_payload(x1: torch.Tensor, x2: torch.Tensor, full1: torch.Tensor,
                 full2: torch.Tensor, dygs: torch.Tensor) -> torch.Tensor:
    """The 3-channel payload a flow render composites: the NDC
    displacement (du, dv) of each Gaussian from (x1, camera 1) to (x2,
    camera 2), and its dynamic flag in the third channel. Signed values;
    nothing downstream clamps a payload."""
    f = ndc_project(x2, full2) - ndc_project(x1, full1)
    dy = dygs.to(f.dtype)[:, None].expand(f.shape[:-1] + (1,))
    return torch.cat([f[..., :2], dy], dim=-1)


def _assemble_image(tiles: torch.Tensor, tx_n: int, ty_n: int, tile: int, w: int, h: int):
    """Channel-first (..., num_tiles, C, tile*tile) -> (..., C, H, W)."""
    lead = tiles.shape[:-3]
    c = tiles.shape[-2]
    img = tiles.reshape(lead + (ty_n, tx_n, c, tile, tile))
    n = len(lead)
    img = img.permute(*range(n), n + 2, n, n + 3, n + 1, n + 4)
    img = img.reshape(lead + (c, ty_n * tile, tx_n * tile))
    return img[..., :h, :w]


def compute_bins_multi(
    means3d, scales, quats, alive, T_cws, proj, opacities=None, *,
    fx: float, fy: float, width: int, height: int, tan_fovx: float,
    tan_fovy: float, scale_mod: float = 1.0, config: RasterConfig = RasterConfig(),
) -> TileBins:
    """Tile binning of V views (T_cws (V, 4, 4)) for reuse across nearby
    renders. Forward only. A `bin` span (work: the views)."""
    with torch.no_grad(), span("bin", T_cws.shape[0]):
        op = torch.ones_like(means3d[..., 0]) if opacities is None else opacities
        sg = preprocess(
            means3d, scales, quats, op, torch.zeros_like(means3d), alive,
            T_cws, proj, fx=fx, fy=fy, width=width, height=height,
            tan_fovx=tan_fovx, tan_fovy=tan_fovy, scale_mod=scale_mod,
            max_radius=config.max_radius,
        )
        return bin_gaussians(
            sg.mean2d, sg.depth, sg.radius, sg.visible, width=width,
            height=height, tile=TILE, max_rect=config.max_rect,
            max_pairs=config.max_pairs, opacity=sg.opacity, cull_radius=sg.sigma3,
        )


def compute_bins(means3d, scales, quats, alive, T_cw, proj, opacities=None, **kw) -> TileBins:
    """Tile binning of one view at pose T_cw (4, 4). Forward only."""
    return compute_bins_multi(means3d, scales, quats, alive, T_cw[None], proj,
                              opacities, **kw)


def view_fields(
    means3d, scales, quats, opacities, colors, alive, T_cws, proj, *,
    fx: float, fy: float, width: int, height: int, tan_fovx: float,
    tan_fovy: float, scale_mod: float = 1.0,
    mean2d_offsets: torch.Tensor | None = None,
    config: RasterConfig = RasterConfig(),
):
    """Preprocess V views and lay out the compositor's field table:
    returns (screen Gaussians, screen means, field table (V, N+1, 10) with
    a zero pad row at N). No binning, no host read."""
    v = T_cws.shape[0]
    sg = preprocess(
        means3d, scales, quats, opacities, colors, alive, T_cws, proj,
        fx=fx, fy=fy, width=width, height=height, tan_fovx=tan_fovx,
        tan_fovy=tan_fovy, scale_mod=scale_mod, max_radius=config.max_radius,
    )
    mean2d = sg.mean2d if mean2d_offsets is None else sg.mean2d + mean2d_offsets
    n = mean2d.shape[-2]
    color = sg.color.expand((v, n, sg.color.shape[-1]))
    fields = torch.cat(
        [mean2d, sg.conic, sg.depth[..., None], sg.opacity[..., None], color], dim=-1
    )  # (V, N, 10) [mx, my, ca, cb, cc, depth, op, r, g, b]
    fields = torch.cat([fields, fields.new_zeros((v, 1, fields.shape[-1]))], dim=1)
    return sg, mean2d, fields


def screen_fields(
    means3d, scales, quats, opacities, colors, alive, T_cws, proj, *,
    fx: float, fy: float, width: int, height: int, tan_fovx: float,
    tan_fovy: float, scale_mod: float = 1.0,
    mean2d_offsets: torch.Tensor | None = None,
    config: RasterConfig = RasterConfig(),
    bins: TileBins | None = None,
):
    """Preprocess V views and lay out what the compositor takes: returns
    (screen Gaussians, field table (V, N+1, 10) with a zero pad row at N,
    bins, tile grid)."""
    sg, mean2d, fields = view_fields(
        means3d, scales, quats, opacities, colors, alive, T_cws, proj,
        fx=fx, fy=fy, width=width, height=height, tan_fovx=tan_fovx,
        tan_fovy=tan_fovy, scale_mod=scale_mod, mean2d_offsets=mean2d_offsets,
        config=config,
    )
    if bins is None:
        with span("bin", T_cws.shape[0]):
            bins = bin_gaussians(
                mean2d.detach(), sg.depth.detach(), sg.radius, sg.visible,
                width=width, height=height, tile=TILE,
                max_rect=config.max_rect, max_pairs=config.max_pairs,
                opacity=sg.opacity.detach(), cull_radius=sg.sigma3.detach(),
            )
    return sg, fields, bins, view_grid(width, height)


def view_grid(width: int, height: int) -> TileGrid:
    """The tile grid of a width x height view."""
    tx_n, ty_n = tile_grid(width, height, TILE)
    return TileGrid(tx_n, ty_n, width, height)


def image_from_tiles(out: torch.Tensor, grid: TileGrid, bg: torch.Tensor):
    """The compositor's per-tile outputs (V*T, 5, 256) of V views as
    images: (color (V, 3, H, W) on background `bg`, depth (V, H, W),
    alpha (V, H, W), T_final (V, H, W))."""
    img5 = _assemble_image(out.reshape(-1, grid.tiles, NOUT, TILE * TILE), grid.tx_n,
                           grid.ty_n, TILE, grid.width, grid.height)
    t_final = img5[:, 4]
    color = img5[:, :3] + t_final[:, None] * bg[None, :, None, None]
    return color, img5[:, 3], 1.0 - t_final, t_final


def rasterize_multi(
    means3d: torch.Tensor,     # (N, 3) shared or (V, N, 3)
    scales: torch.Tensor,      # (N, 3) or (V, N, 3)
    quats: torch.Tensor,       # (N, 4) or (V, N, 4)
    opacities: torch.Tensor,   # (N,) or (V, N)
    colors: torch.Tensor,      # (N, 3) or (V, N, 3)
    alive: torch.Tensor,       # (N,) bool
    T_cws: torch.Tensor,       # (V, 4, 4)
    proj: torch.Tensor,
    bg: torch.Tensor,
    *,
    fx: float, fy: float, width: int, height: int, tan_fovx: float,
    tan_fovy: float, scale_mod: float = 1.0,
    mean2d_offsets: torch.Tensor | None = None,  # (V, N, 2) gradient taps
    config: RasterConfig = RasterConfig(),
    bins: TileBins | None = None,                # a compute_bins_multi result
) -> RenderOutputs:
    """Render V views of one map; outputs carry a leading V axis.
    `mean2d_offsets` is a zeros tap whose gradient is the screen-space
    mean gradient used for densification statistics."""
    sg, fields, bins, grid = screen_fields(
        means3d, scales, quats, opacities, colors, alive, T_cws, proj,
        fx=fx, fy=fy, width=width, height=height, tan_fovx=tan_fovx,
        tan_fovy=tan_fovy, scale_mod=scale_mod, mean2d_offsets=mean2d_offsets,
        config=config, bins=bins,
    )
    n = fields.shape[1] - 1
    out, n_touched = composite(fields, bins, grid)
    color, depth, alpha, t_final = image_from_tiles(out, grid, bg)
    return RenderOutputs(
        color=color,
        depth=depth,
        alpha=alpha,
        n_touched=n_touched[:, :n],
        T_final=t_final,
        radii=sg.radius,
        overflow=torch.any(bins.overflow),
        num_pairs=torch.max(bins.num_pairs),
    )


def rasterize(
    means3d, scales, quats, opacities, colors, alive, T_cw, proj, bg, *,
    fx: float, fy: float, width: int, height: int, tan_fovx: float,
    tan_fovy: float, scale_mod: float = 1.0,
    mean2d_offset: torch.Tensor | None = None,
    config: RasterConfig = RasterConfig(),
    bins: TileBins | None = None,
) -> RenderOutputs:
    """Render one view at pose T_cw (4, 4). `bins` reuses a
    `compute_bins` result (tracking re-bins every few iterations)."""
    out = rasterize_multi(
        means3d, scales, quats, opacities, colors, alive, T_cw[None], proj, bg,
        fx=fx, fy=fy, width=width, height=height, tan_fovx=tan_fovx,
        tan_fovy=tan_fovy, scale_mod=scale_mod,
        mean2d_offsets=None if mean2d_offset is None else mean2d_offset[None],
        config=config, bins=bins,
    )
    return out._replace(
        color=out.color[0], depth=out.depth[0], alpha=out.alpha[0],
        n_touched=out.n_touched[0], T_final=out.T_final[0], radii=out.radii[0],
    )


def render_flow(
    means3d, scales, quats, opacities, dygs, alive,
    d_xyz1, d_xyz2, d_rot1, d_scale1, T_cw1, T_cw2, proj, *,
    fx: float, fy: float, width: int, height: int, tan_fovx: float,
    tan_fovy: float, config: RasterConfig = RasterConfig(),
) -> RenderOutputs:
    """Render the scene flow from (time 1, camera 1) to (time 2, camera 2)
    as a 3-channel image: NDC (du, dv) and the dygs flag, on a zero
    background. `scales` and `quats` are activated; the deformations
    d_* are (N, .) at the two times. The Gaussians' base parameters are
    detached: only the deformations receive gradients."""
    base = means3d.detach()
    x1, x2 = base + d_xyz1, base + d_xyz2
    payload = flow_payload(x1, x2, proj @ T_cw1, proj @ T_cw2, dygs)
    return rasterize(
        x1, scales.detach() + d_scale1, quats.detach() + d_rot1, opacities.detach(),
        payload, alive, T_cw1, proj, torch.zeros(3, device=means3d.device),
        fx=fx, fy=fy, width=width, height=height, tan_fovx=tan_fovx,
        tan_fovy=tan_fovy, config=config,
    )
