"""Rendering-quality evaluation over frames (port of
fourdgs/eval/rendering.py): PSNR masked to valid (and, in static mode,
static) pixels, SSIM, LPIPS and L1 depth, averaged, written to
`<save_dir>/psnr/<label>/final_result.json` with PNG dumps of renders,
ground truth and novel views under `<save_dir>/renders/<label>/`. LPIPS
(eval/lpips.py) needs AlexNet weights: `mean_lpips` is None when
`lpips.load_weights` finds no file."""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from PIL import Image

from fourdgs_torch.eval.lpips import load_weights, lpips_pair
from fourdgs_torch.ops.image import psnr, ssim


def _dump(path: str, img: torch.Tensor) -> None:
    """A (3, H, W) image in [0, 1] as an 8-bit PNG."""
    arr = np.clip(img.detach().cpu().numpy(), 0, 1).transpose(1, 2, 0)
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def eval_rendering(render_fn, dataset, frame_ids: list[int], save_dir: str | None = None,
                   label: str = "final", mask_dynamic: bool = False, interval: int = 1,
                   novel_render_fn=None, dump_interval: int | None = None) -> dict:
    """render_fn(idx) -> (image (3, H, W), depth (H, W)) tensors at the
    estimated pose of dataset frame idx. `interval` strides the metrics.
    With `save_dir`, the metrics are written there and frames dumped where
    `dump_interval` is falsy or (idx + 1) % dump_interval == 0 or idx == 0,
    with the novel view of `novel_render_fn` when given."""
    psnrs, ssims, lpipss, l1ds = [], [], [], []
    lpips_w = False   # loaded at the first frame, on its device; None: no weights file
    dump_dir = None
    if save_dir:
        dump_dir = os.path.join(save_dir, "renders", label)
        os.makedirs(dump_dir, exist_ok=True)
    for idx in frame_ids[::interval]:
        gt_image, gt_depth, _, motion_mask = dataset[idx]
        img, depth = render_fn(idx)
        dev = img.device
        gt_image = torch.as_tensor(gt_image, device=dev)
        motion = torch.as_tensor(motion_mask, device=dev)
        if dump_dir and (not dump_interval or (idx + 1) % dump_interval == 0 or idx == 0):
            _dump(os.path.join(dump_dir, f"{idx:05d}_render.png"), img)
            _dump(os.path.join(dump_dir, f"{idx:05d}_gt.png"), gt_image)
            if novel_render_fn is not None:
                _dump(os.path.join(dump_dir, f"{idx:05d}_novel.png"), novel_render_fn(idx)[0])
        mask = gt_image.sum(dim=0) > 0.01
        if mask_dynamic:
            mask = mask & motion
        img = torch.clamp(img, 0, 1)
        psnrs.append(float(psnr(img, gt_image, mask)))
        ssims.append(float(ssim(img, gt_image)))
        if lpips_w is False:
            lpips_w = load_weights(device=dev)
        if lpips_w is not None:
            lpipss.append(float(lpips_pair(lpips_w, img, torch.clamp(gt_image, 0, 1))))
        if gt_depth is not None:
            gtd = torch.as_tensor(gt_depth, device=dev)
            valid = (gtd > 0.01) & motion
            l1 = torch.sum(torch.abs(depth - gtd) * valid) / torch.clamp(torch.sum(valid), min=1)
            l1ds.append(float(l1))
    out = {
        "mean_psnr": float(np.mean(psnrs)) if psnrs else None,
        "mean_ssim": float(np.mean(ssims)) if ssims else None,
        "mean_lpips": float(np.mean(lpipss)) if lpipss else None,
        "mean_l1_depth": float(np.mean(l1ds)) if l1ds else None,
        "frames": len(psnrs),
    }
    if save_dir:
        os.makedirs(os.path.join(save_dir, "psnr", label), exist_ok=True)
        with open(os.path.join(save_dir, "psnr", label, "final_result.json"), "w") as f:
            json.dump(out, f, indent=2)
    return out
