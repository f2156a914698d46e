"""Dataset layer: indexable RGB-D sequences returning numpy frames (port of
fourdgs/data/base.py).

`__getitem__` returns (image (3, H, W) float32 in [0, 1], depth (H, W)
metres or None without a depth sensor, w2c pose (4, 4), motion mask
(H, W) bool, True on static pixels). Recorded sequences decode their PNGs
with Pillow, undistort colour with OpenCV's Brown-Conrady map when the
calibration says `distorted: true` (the Bonn configs), and divide depth by
`depth_scale`. The runner may set `mask_fn`, a segmenter called on each
frame's (H, W, 3) uint8 image and depth the first time the frame is read; its
dynamic mask is kept per index in `dynamic_masks` and returned inverted.
"""

from __future__ import annotations

from typing import Callable, Optional

import cv2
import numpy as np
from PIL import Image

MaskFn = Callable[[np.ndarray, Optional[np.ndarray]], np.ndarray]  # image, depth -> dynamic


class BaseDataset:
    """Indexable RGB-D dataset. Subclasses fill `poses` and `num_imgs`, and
    recorded ones `color_paths` and `depth_paths`."""

    def __init__(self, args, path: str, config):
        self.args = args
        self.path = path
        self.config = config
        calibration = config["Dataset"]["Calibration"]
        self.fx = calibration["fx"]
        self.fy = calibration["fy"]
        self.cx = calibration["cx"]
        self.cy = calibration["cy"]
        self.width = calibration["width"]
        self.height = calibration["height"]
        self.depth_scale = calibration.get("depth_scale", 1.0)
        self.has_depth = config["Dataset"].get("sensor_type", "depth") == "depth"
        self.distorted = calibration.get("distorted", False)
        self.dist_coeffs = np.array([calibration.get(k, 0.0)
                                     for k in ("k1", "k2", "p1", "p2", "k3")])
        self.K = np.array([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                           [0.0, 0.0, 1.0]])
        self.map1x = self.map1y = None
        if self.distorted:
            self.map1x, self.map1y = cv2.initUndistortRectifyMap(
                self.K, self.dist_coeffs, np.eye(3), self.K, (self.width, self.height),
                cv2.CV_32FC1,
            )
        self.fovx = 2 * np.arctan(self.width / (2 * self.fx))
        self.fovy = 2 * np.arctan(self.height / (2 * self.fy))
        self.color_paths: list[str] = []
        self.depth_paths: list[str] = []
        self.poses: list[np.ndarray] = []
        self.num_imgs = 0
        self.mask_fn: Optional[MaskFn] = None
        self.dynamic_masks: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return self.num_imgs

    def _read_color(self, idx: int) -> np.ndarray:
        img = np.array(Image.open(self.color_paths[idx]))[..., :3]
        if self.map1x is not None:
            img = cv2.remap(img, self.map1x, self.map1y, cv2.INTER_LINEAR)
        return img

    def _read_depth(self, idx: int) -> np.ndarray:
        return np.array(Image.open(self.depth_paths[idx])).astype(np.float32) / self.depth_scale

    def _dynamic_mask(self, idx: int, img_u8: np.ndarray, depth) -> np.ndarray:
        """The segmenter's dynamic mask of frame idx, computed once."""
        if idx not in self.dynamic_masks:
            dynamic = np.zeros(img_u8.shape[:2], bool)
            if self.mask_fn is not None:
                # the segmenter's pose comes from its own provider (tracked
                # poses), never from the dataset
                dynamic = self.mask_fn(img_u8, depth)
            self.dynamic_masks[idx] = dynamic
        return self.dynamic_masks[idx]

    def __getitem__(self, idx: int):
        img_u8 = self._read_color(idx)
        image = np.clip(img_u8.astype(np.float32) / 255.0, 0.0, 1.0).transpose(2, 0, 1)
        depth = self._read_depth(idx) if self.has_depth else None
        motion_mask = ~self._dynamic_mask(idx, img_u8, depth)
        return image, depth, self.poses[idx], motion_mask


def load_dataset(args, path: str, config, device) -> BaseDataset:
    """Dataset factory by `Dataset.type`: `tum` (also the Bonn layout),
    `CoFusion`, `synthetic` and `realsense` (a live camera); `device` is
    where the synthetic sequence renders."""
    from fourdgs_torch.data.cofusion import CoFusionDataset
    from fourdgs_torch.data.synthetic import SyntheticDataset
    from fourdgs_torch.data.tum import TUMDataset

    dtype = config["Dataset"]["type"]
    if dtype == "tum":
        return TUMDataset(args, path, config)
    if dtype == "CoFusion":
        return CoFusionDataset(args, path, config)
    if dtype == "synthetic":
        return SyntheticDataset(args, path, config, device=device)
    if dtype == "realsense":
        from fourdgs_torch.data.realsense import RealsenseDataset

        return RealsenseDataset(args, path, config)
    raise ValueError(f"Unknown dataset type: {dtype}")
