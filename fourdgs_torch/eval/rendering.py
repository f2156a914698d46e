"""Rendering-quality evaluation over frames (port of
fourdgs/eval/rendering.py without LPIPS and without image dumps): PSNR
masked to valid (and static) pixels, SSIM and L1 depth, averaged."""

from __future__ import annotations

import numpy as np
import torch

from fourdgs_torch.ops.image import psnr, ssim


def eval_rendering(render_fn, dataset, frame_ids: list[int], mask_dynamic: bool = False,
                   interval: int = 1) -> dict:
    """render_fn(idx) -> (image (3, H, W), depth (H, W)) tensors at the
    estimated pose of dataset frame idx."""
    psnrs, ssims, l1ds = [], [], []
    for idx in frame_ids[::interval]:
        gt_image, gt_depth, _, motion_mask = dataset[idx]
        img, depth = render_fn(idx)
        dev = img.device
        gt_image = torch.as_tensor(gt_image, device=dev)
        motion = torch.as_tensor(motion_mask, device=dev)
        mask = gt_image.sum(dim=0) > 0.01
        if mask_dynamic:
            mask = mask & motion
        img = torch.clamp(img, 0, 1)
        psnrs.append(float(psnr(img, gt_image, mask)))
        ssims.append(float(ssim(img, gt_image)))
        gtd = torch.as_tensor(gt_depth, device=dev)
        valid = (gtd > 0.01) & motion
        l1 = torch.sum(torch.abs(depth - gtd) * valid) / torch.clamp(torch.sum(valid), min=1)
        l1ds.append(float(l1))
    return {
        "mean_psnr": float(np.mean(psnrs)) if psnrs else None,
        "mean_ssim": float(np.mean(ssims)) if ssims else None,
        "mean_l1_depth": float(np.mean(l1ds)) if l1ds else None,
        "frames": len(psnrs),
    }
