"""Dynamic-object segmentation of recorded frames (port of the
`NullSegmenter`, `Yolov9SegSegmenter`, `MotionSegmenter` and
`make_segmenter` of fourdgs/perception/segmentation.py).

A segmenter maps an (H, W, 3) uint8 frame (and its depth) to an (H, W)
bool DYNAMIC mask. `Yolov9SegSegmenter` is the learned one: the union of
YOLOv9-seg's instance masks of the configured COCO classes (person 0,
chair 56, clock 74, teddy bear 77), the network on the device
(perception/yolov9.py). `MotionSegmenter` is the geometric one, taken
when no YOLOv9 weights file is found: the previous frame is warped into
the current one through the depth and the pose predicted from tracked
poses, and coherent high-residual regions (5x5 box filtered,
thresholded, 4-connected regions of at least `min_region` pixels) are
dynamic. The reference's `UltralyticsSegmenter`, which runs the
`ultralytics` package's network, is not ported.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import label

from fourdgs_torch.perception.yolov9 import load_yolov9, weights_file

PERSON, CHAIR, CLOCK, TEDDY = 0, 56, 74, 77


class NullSegmenter:
    """Everything static."""

    def __call__(self, img_u8: np.ndarray, depth: np.ndarray | None = None) -> np.ndarray:
        return np.zeros(img_u8.shape[:2], bool)


class Yolov9SegSegmenter:
    """The union of the YOLOv9-seg masks of `classes` at score >= conf;
    the network runs on `device` (the card unless "cpu"), the depth is
    not used. Raises if the weights do not load."""

    def __init__(self, weights: str = "pretrained/yolov9e-seg.pt", classes=(PERSON,),
                 conf: float = 0.25, device=None):
        self.model = load_yolov9(weights, device=device)
        self.classes = list(classes)
        self.conf = conf

    def __call__(self, img_u8: np.ndarray, depth: np.ndarray | None = None) -> np.ndarray:
        chw = img_u8[..., :3].astype(np.float32).transpose(2, 0, 1) / 255.0
        return self.model.segment(chw, self.classes, conf=self.conf)


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


def make_segmenter(config, intrinsics, device=None):
    """The segmenter of a config: `Yolov9SegSegmenter` on `device` when
    the weights file `Dataset.yolo_weights` (default
    pretrained/yolov9e-seg.pt) or its sibling `.npz` exists, for the
    classes person and those of `seg_chair`/`seg_clock`/`seg_teddy`;
    `MotionSegmenter` otherwise. A file that is found but does not load
    raises (the reference falls back instead, ROADMAP §3)."""
    ds = config["Dataset"]
    classes = [PERSON] + [c for key, c in (("seg_chair", CHAIR), ("seg_clock", CLOCK),
                                           ("seg_teddy", TEDDY)) if ds.get(key)]
    weights = ds.get("yolo_weights", "pretrained/yolov9e-seg.pt")
    if weights_file(weights) is not None:
        return Yolov9SegSegmenter(weights, classes=tuple(classes), device=device)
    return MotionSegmenter(intrinsics)
