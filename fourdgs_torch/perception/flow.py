"""Optical flow for the flow losses of 4D mapping (port of
fourdgs/perception/flow.py).

A provider maps a frame pair (uid1, uid2) and the two frames' colour
images (3, H, W) in [0, 1] to pixel flows (fwd, bwd), each (H, W, 2): fwd
from frame uid2 to uid1, bwd from uid1 to uid2, as the reference's
`generate_flow(image, image_last)` orders them. `SyntheticFlowProvider`
computes them exactly for the synthetic sequence (camera reprojection of
the ground-truth depth plus the blob's known motion) and ignores the
images; on recorded sequences the RAFT and GMA networks
(perception/raft.py, perception/gma.py) compute them from the images, and
`network_weights` finds their weight files. `FlowCache` keeps each pair's
flows normalized to the loss's units (px / [W, H] * 2), channel first,
with their forward-backward consistency masks. All host numpy: a pair's
flow is computed once per run.
"""

from __future__ import annotations

import os

import cv2
import numpy as np

# weight files of the flow networks, relative to the working directory,
# then in the user's cache
WEIGHTS_PATHS = {
    "raft": ("pretrained/raft-things.npz", "pretrained/raft-things.pth",
             "~/.cache/fourdgs/raft-things.npz", "~/.cache/fourdgs/raft-things.pth"),
    "gma": ("pretrained/gma-things.npz", "pretrained/gma-things.pth",
            "~/.cache/fourdgs/gma-things.npz", "~/.cache/fourdgs/gma-things.pth"),
}


def network_weights(flow_model: str) -> str | None:
    """The first existing weights file of flow network `flow_model` ('raft'
    or 'gma'), or None."""
    if flow_model not in WEIGHTS_PATHS:
        raise ValueError(f"unknown flow model {flow_model!r}: use 'raft' or 'gma'")
    paths = (os.path.expanduser(p) for p in WEIGHTS_PATHS[flow_model])
    return next((p for p in paths if os.path.exists(p)), None)


def warp_flow(img: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Backward-warp `img` (H, W, C) by `flow` (H, W, 2): bicubic, zero
    outside."""
    h, w = flow.shape[:2]
    grid = flow.copy()
    grid[:, :, 0] += np.arange(w)
    grid[:, :, 1] += np.arange(h)[:, None]
    return cv2.remap(img, grid.astype(np.float32), None, cv2.INTER_CUBIC,
                     borderMode=cv2.BORDER_CONSTANT)


def compute_fwdbwd_mask(fwd_flow: np.ndarray, bwd_flow: np.ndarray,
                        alpha_1: float = 0.5, alpha_2: float = 0.5):
    """Forward-backward consistency masks (H, W) bool of the two flows: a
    pixel is consistent where the flow and the other flow warped back onto
    it cancel to within alpha_1 of their lengths plus alpha_2 pixels."""
    bwd2fwd = warp_flow(bwd_flow, fwd_flow)
    fwd_err = np.linalg.norm(fwd_flow + bwd2fwd, axis=-1)
    fwd_mask = fwd_err < alpha_1 * (
        np.linalg.norm(fwd_flow, axis=-1) + np.linalg.norm(bwd2fwd, axis=-1)) + alpha_2
    fwd2bwd = warp_flow(fwd_flow, bwd_flow)
    bwd_err = np.linalg.norm(bwd_flow + fwd2bwd, axis=-1)
    bwd_mask = bwd_err < alpha_1 * (
        np.linalg.norm(bwd_flow, axis=-1) + np.linalg.norm(fwd2bwd, axis=-1)) + alpha_2
    return fwd_mask, bwd_mask


def normalize_flow(flow_px: np.ndarray) -> np.ndarray:
    """(H, W, 2) pixel flow -> px / [W, H] * 2."""
    h, w = flow_px.shape[:2]
    return flow_px / np.array([w, h], np.float32) * 2.0


class FlowCache:
    """Per-(uid1, uid2) flows: `get` returns ((2, H, W) fwd, (2, H, W) bwd)
    in normalized units and the (H, W) forward and backward consistency
    masks, computing them on the first call for the pair from the two
    frames' images."""

    def __init__(self, provider):
        self.provider = provider
        self._cache: dict[tuple[int, int], tuple] = {}

    def get(self, uid1: int, uid2: int, img1=None, img2=None):
        key = (uid1, uid2)
        if key not in self._cache:
            fwd_px, bwd_px = self.provider(uid1, uid2, img1, img2)
            fwd_mask, bwd_mask = compute_fwdbwd_mask(fwd_px, bwd_px)
            self._cache[key] = (normalize_flow(fwd_px).transpose(2, 0, 1),
                                normalize_flow(bwd_px).transpose(2, 0, 1),
                                fwd_mask, bwd_mask)
        return self._cache[key]


class SyntheticFlowProvider:
    """Exact optical flow of the synthetic dataset: every pixel of one frame
    is back-projected with its ground-truth depth, moved with the blob if
    it is dynamic, and projected into the other frame."""

    def __init__(self, dataset):
        self.dataset = dataset

    def _flow(self, uid_a: int, uid_b: int) -> np.ndarray:
        from fourdgs_torch.data.synthetic import blob_offset

        ds = self.dataset
        _, depth, T_a, motion = ds[uid_a]
        T_b = ds.poses[uid_b]
        h, w = depth.shape
        v, u = np.mgrid[0:h, 0:w].astype(np.float32)
        z = depth
        x = (u - ds.cx) * z / ds.fx
        y = (v - ds.cy) * z / ds.fy
        pc = np.stack([x, y, z], -1).reshape(-1, 3)
        Ra, ta = T_a[:3, :3], T_a[:3, 3]
        pw = (pc - ta) @ Ra
        if ds.blob is not None:
            t_a = uid_a / max(ds.num_imgs - 1, 1)
            t_b = uid_b / max(ds.num_imgs - 1, 1)
            delta = blob_offset(t_b) - blob_offset(t_a)
            dyn = (~motion).reshape(-1)
            pw = pw + dyn[:, None] * delta[None]
        pb = pw @ T_b[:3, :3].T + T_b[:3, 3]
        zb = np.maximum(pb[:, 2], 1e-6)
        ub = ds.fx * pb[:, 0] / zb + ds.cx
        vb = ds.fy * pb[:, 1] / zb + ds.cy
        flow = np.stack([ub - u.reshape(-1), vb - v.reshape(-1)], -1)
        flow = flow.reshape(h, w, 2).astype(np.float32)
        flow[depth <= 0] = 0.0
        return flow

    def __call__(self, uid1: int, uid2: int, img1=None, img2=None):
        return self._flow(uid2, uid1), self._flow(uid1, uid2)
