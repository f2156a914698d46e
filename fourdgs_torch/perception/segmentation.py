"""Dynamic-object segmentation of recorded frames (port of the
`NullSegmenter`, `MotionSegmenter` and `make_segmenter` of
fourdgs/perception/segmentation.py).

A segmenter maps an (H, W, 3) uint8 frame (and its depth) to an (H, W)
bool DYNAMIC mask. `MotionSegmenter` is the geometric one: the previous
frame is warped into the current one through the depth and the pose
predicted from tracked poses, and coherent high-residual regions (5x5 box
filtered, thresholded, 4-connected regions of at least `min_region`
pixels) are dynamic. The learned YOLOv9 segmenter is not ported yet:
`make_segmenter` refuses a config whose weights file exists rather than
segment it by geometry.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.ndimage import label

class NullSegmenter:
    """Everything static."""

    def __call__(self, img_u8: np.ndarray, depth: np.ndarray | None = None) -> np.ndarray:
        return np.zeros(img_u8.shape[:2], bool)


def region_filter(mask: np.ndarray, min_region: int) -> np.ndarray:
    """The True pixels of 4-connected regions of at least `min_region`
    pixels."""
    lbl, n_lab = label(mask.astype(bool))   # the default structure is 4-connected
    if n_lab == 0:
        return np.zeros(mask.shape, bool)
    keep = np.bincount(lbl.reshape(-1), minlength=n_lab + 1) >= min_region
    keep[0] = False
    return keep[lbl]


class MotionSegmenter:
    """Ego-motion-compensated residual segmentation. Stateful: each call
    with a depth segments against the previous such frame and then keeps
    this one. `pose_provider() -> (4, 4)` gives the w2c pose of the frame
    being segmented, predicted from tracked poses; without it there is no
    geometry and every mask is empty."""

    def __init__(self, intrinsics, residual_threshold: float = 0.12,
                 min_region: int = 200, pose_provider=None):
        self.intr = intrinsics
        self.th = residual_threshold
        self.min_region = min_region
        self._prev = None  # (gray, depth, T_cw)
        self.pose_provider = pose_provider

    @staticmethod
    def _gray(img_u8: np.ndarray) -> np.ndarray:
        return img_u8[..., :3].astype(np.float32).mean(-1) / 255.0

    def update(self, img_u8: np.ndarray, depth: np.ndarray, T_cw: np.ndarray) -> np.ndarray:
        gray = self._gray(img_u8)
        mask = np.zeros(gray.shape, bool)
        if self._prev is not None and depth is not None:
            mask = self._segment(gray, depth, T_cw, *self._prev)
        self._prev = (gray, depth, np.asarray(T_cw))
        return mask

    def _segment(self, gray, depth, T_cw, prev_gray, prev_depth, prev_T):
        intr = self.intr
        h, w = gray.shape
        v, u = np.mgrid[0:h, 0:w].astype(np.float32)
        z = depth
        x = (u - intr.cx) * z / intr.fx
        y = (v - intr.cy) * z / intr.fy
        pc = np.stack([x, y, z], -1).reshape(-1, 3)
        # current camera -> world -> previous camera
        pw = (pc - T_cw[:3, 3]) @ T_cw[:3, :3]
        pp = pw @ prev_T[:3, :3].T + prev_T[:3, 3]
        zp = np.maximum(pp[:, 2], 1e-6)
        up = (intr.fx * pp[:, 0] / zp + intr.cx).reshape(h, w)
        vp = (intr.fy * pp[:, 1] / zp + intr.cy).reshape(h, w)
        ui = np.clip(np.round(up).astype(int), 0, w - 1)
        vi = np.clip(np.round(vp).astype(int), 0, h - 1)
        inb = (up >= 0) & (up < w) & (vp >= 0) & (vp < h)
        resid = np.abs(gray - prev_gray[vi, ui]) * ((z > 0) & inb)

        k = 5   # box filter by summed-area table
        csum = np.cumsum(np.cumsum(np.pad(resid, k // 2, mode="edge"), 0), 1)
        csum = np.pad(csum, ((1, 0), (1, 0)))
        box = (csum[k:, k:] - csum[:-k, k:] - csum[k:, :-k] + csum[:-k, :-k]) / (k * k)
        return region_filter(box > self.th, self.min_region)

    def __call__(self, img_u8: np.ndarray, depth: np.ndarray | None = None) -> np.ndarray:
        if depth is not None and self.pose_provider is not None:
            return self.update(img_u8, depth, np.asarray(self.pose_provider()))
        return np.zeros(img_u8.shape[:2], bool)


def make_segmenter(config, intrinsics):
    """The segmenter of a config: `MotionSegmenter` while the YOLOv9 weights
    (`Dataset.yolo_weights`) are absent. With the weights present it
    raises: the learned segmenter is not ported yet."""
    weights = config["Dataset"].get("yolo_weights", "pretrained/yolov9e-seg.pt")
    if os.path.exists(weights):
        raise NotImplementedError(
            f"YOLOv9 is not ported yet (ROADMAP item 15); found weights {weights}")
    return MotionSegmenter(intrinsics)
