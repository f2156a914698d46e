"""The SLAM losses (port of fourdgs/slam/losses.py, with the RGB-only
tracking and mapping losses that fourdgs/slam/tracking.py and mapping.py
write inline for monocular runs).

Images are (3, H, W) in [0,1]; depths and opacity (H, W); `motion_mask`
is True on static (usable) pixels. The mapping and flow losses also take
a leading view axis and then return one loss per view.
"""

from __future__ import annotations

import torch

from fourdgs_torch.ops.image import image_gradient, image_gradient_mask


def apply_exposure(image: torch.Tensor, exposure_a, exposure_b) -> torch.Tensor:
    """Affine exposure compensation: exp(a) * I + b."""
    return torch.exp(exposure_a) * image + exposure_b


def tracking_loss_rgbd(
    image: torch.Tensor,
    depth: torch.Tensor,
    opacity: torch.Tensor,
    gt_image: torch.Tensor,
    gt_depth: torch.Tensor,
    grad_mask: torch.Tensor,
    motion_mask: torch.Tensor | None = None,
    alpha: float = 0.95,
    rgb_boundary_threshold: float = 0.01,
) -> torch.Tensor:
    """Opacity-weighted L1 RGB on edge pixels + L1 depth on confident
    pixels, means over the FULL image like the reference's `.mean()`."""
    rgb_mask = (torch.sum(gt_image, dim=0) > rgb_boundary_threshold) & grad_mask
    if motion_mask is not None:
        rgb_mask = rgb_mask & motion_mask
    rgb_maskf = rgb_mask.to(image.dtype)[None]
    l1_rgb = torch.mean(opacity[None] * torch.abs((image - gt_image) * rgb_maskf))

    depth_mask = (gt_depth > 0.01) & (gt_depth < 1000.0) & (opacity > 0.95)
    if motion_mask is not None:
        depth_mask = depth_mask & motion_mask
    l1_depth = torch.mean(torch.abs((depth - gt_depth) * depth_mask.to(depth.dtype)))
    return alpha * l1_rgb + (1.0 - alpha) * l1_depth


def tracking_loss_rgb(
    image: torch.Tensor,
    opacity: torch.Tensor,
    gt_image: torch.Tensor,
    grad_mask: torch.Tensor,
    motion_mask: torch.Tensor | None = None,
    rgb_boundary_threshold: float = 0.01,
) -> torch.Tensor:
    """The monocular tracking loss: opacity-weighted L1 RGB on the edge
    pixels of non-black, static pixels, the mean over the full image."""
    rgb_mask = (torch.sum(gt_image, dim=0) > rgb_boundary_threshold) & grad_mask
    if motion_mask is not None:
        rgb_mask = rgb_mask & motion_mask
    return torch.mean(opacity[None] * torch.abs((image - gt_image) * rgb_mask.to(image.dtype)[None]))


def mapping_loss_rgb(image: torch.Tensor, gt_image: torch.Tensor,
                     rgb_boundary_threshold: float = 0.01) -> torch.Tensor:
    """The monocular mapping loss: L1 RGB on non-black pixels (no motion or
    extra mask), batched over a leading view axis like `mapping_loss_rgbd`."""
    rgb_mask = torch.sum(gt_image, dim=-3) > rgb_boundary_threshold
    return torch.mean(torch.abs((image - gt_image) * rgb_mask.to(image.dtype).unsqueeze(-3)),
                      dim=(-3, -2, -1))


def mapping_loss_rgbd(
    image: torch.Tensor,
    depth: torch.Tensor,
    gt_image: torch.Tensor,
    gt_depth: torch.Tensor,
    motion_mask: torch.Tensor | None = None,
    alpha: float = 0.95,
    rgb_boundary_threshold: float = 0.01,
    rm_dynamic: bool = False,
    dynamic: bool = False,
    extra_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """L1 RGB + L1 depth mapping loss; batched over a leading view axis
    when given (V, 3, H, W) images, returning per-view losses. With
    `dynamic`, the per-pixel L1 counts twice on dynamic pixels
    (~motion_mask); the 4D mapping sets it per iteration. `extra_mask`
    (the `rm_initdy` reprojection masks) is ANDed into both pixel masks
    with `rm_dynamic`, as the motion mask is."""
    rgb_mask = torch.sum(gt_image, dim=-3) > rgb_boundary_threshold
    depth_mask = (gt_depth > 0.01) & (gt_depth < 10000.0)
    if motion_mask is not None and rm_dynamic:
        rgb_mask = rgb_mask & motion_mask
        depth_mask = depth_mask & motion_mask
    if extra_mask is not None and rm_dynamic:
        rgb_mask = rgb_mask & extra_mask
        depth_mask = depth_mask & extra_mask
    l1_rgb = torch.abs((image - gt_image) * rgb_mask.to(image.dtype).unsqueeze(-3))
    l1_depth = torch.abs((depth - gt_depth) * depth_mask.to(depth.dtype))
    if dynamic and motion_mask is not None:
        w = torch.where(motion_mask, 1.0, 2.0).to(image.dtype)
        l1_rgb = l1_rgb * w.unsqueeze(-3)
        l1_depth = l1_depth * w
    return (alpha * torch.mean(l1_rgb, dim=(-3, -2, -1))
            + (1.0 - alpha) * torch.mean(l1_depth, dim=(-2, -1)))


def network_loss_rgbd(
    image: torch.Tensor,
    depth: torch.Tensor,
    opacity: torch.Tensor,
    gt_image: torch.Tensor,
    gt_depth: torch.Tensor,
    motion_mask: torch.Tensor | None = None,
    alpha: float = 0.9,
    dynamic: bool = False,
) -> torch.Tensor:
    """The deformation warmup's loss: L1 RGB where opacity > 0.95, L1 depth
    where also the depth is valid; with `dynamic`, dynamic pixels count
    three times."""
    rgb_mask = opacity > 0.95
    l1_rgb = torch.abs((image - gt_image) * rgb_mask.to(image.dtype)[None])
    depth_mask = (gt_depth > 0.01) & (opacity > 0.95)
    l1_depth = torch.abs((depth - gt_depth) * depth_mask.to(depth.dtype))
    if dynamic and motion_mask is not None:
        w = torch.where(motion_mask, 1.0, 3.0).to(image.dtype)
        l1_rgb = l1_rgb * w[None]
        l1_depth = l1_depth * w
    return alpha * torch.mean(l1_rgb) + (1.0 - alpha) * torch.mean(l1_depth)


def masked_flow_l1(rendered_flow: torch.Tensor, target_flow: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """L1 between rendered and target flow (..., 2, H, W) on the masked
    pixels (..., H, W), over twice the mask's size: one loss per view."""
    m = mask.to(rendered_flow.dtype).unsqueeze(-3)
    return (torch.sum(torch.abs((rendered_flow - target_flow) * m), dim=(-3, -2, -1))
            / torch.clamp(torch.sum(m, dim=(-3, -2, -1)) * 2.0, min=1.0))


def pearson_depth_loss(depth: torch.Tensor, gt_depth: torch.Tensor) -> torch.Tensor:
    """1 - the Pearson correlation of rendered and true depth, both zeroed
    where the true depth is invalid."""
    valid = (gt_depth > 0.01).to(depth.dtype)
    d = (depth * valid).reshape(-1)
    g = (gt_depth * valid).reshape(-1)
    dm = d - torch.mean(d)
    gm = g - torch.mean(g)
    den = torch.sqrt(torch.sum(dm ** 2) * torch.sum(gm ** 2) + 1e-12)
    return 1.0 - torch.sum(dm * gm) / den


def isotropic_loss(scaling: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """|s - mean(s)| per Gaussian, masked mean over alive slots."""
    dev = torch.abs(scaling - torch.mean(scaling, dim=1, keepdim=True))
    alivef = alive.to(scaling.dtype)[:, None]
    return torch.sum(dev * alivef) / torch.clamp(torch.sum(alivef) * scaling.shape[1], min=1.0)


def median_depth(depth: torch.Tensor, opacity: torch.Tensor | None = None,
                 mask: torch.Tensor | None = None):
    """Median and spread of valid rendered depth (the mean of the two
    middle values for an even count, like jnp.nanmedian)."""
    valid = depth > 0
    if opacity is not None:
        valid = valid & (opacity > 0.95)
    if mask is not None:
        valid = valid & mask
    vals = depth[valid]
    if vals.numel() == 0:
        nan = torch.tensor(float("nan"), device=depth.device)
        return nan, nan, valid
    med = torch.quantile(vals, 0.5)
    std = torch.sqrt(torch.mean((vals - med) ** 2))
    return med, std, valid


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with the reference's gradient at 0 (+1, where torch.abs gives 0)."""
    return torch.where(x >= 0, x, -x)


def depth_smoothness_loss(depth: torch.Tensor, gt_image: torch.Tensor) -> torch.Tensor:
    """Edge-aware depth smoothness: the depth's Scharr gradients weighted by
    exp(-10 * the grey image's gradient^2), on pixels whose 3x3 depth
    window is valid."""
    gray_v, gray_h = image_gradient(torch.mean(gt_image, dim=0, keepdim=True))
    d = depth[None]
    mask_v, mask_h = image_gradient_mask(d)
    depth_v, depth_h = image_gradient(d)
    w_v = torch.exp(-10.0 * gray_v ** 2) * mask_v
    w_h = torch.exp(-10.0 * gray_h ** 2) * mask_h
    nv = torch.clamp(torch.sum(mask_v), min=1.0)
    nh = torch.clamp(torch.sum(mask_h), min=1.0)
    return torch.sum(w_h * _abs(depth_h)) / nh + torch.sum(w_v * _abs(depth_v)) / nv
