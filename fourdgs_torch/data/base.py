"""Dataset layer: indexable RGB-D sequences returning numpy frames (port of
fourdgs/data/base.py, for the synthetic sequence of this slice)."""

from __future__ import annotations

import numpy as np


class BaseDataset:
    """Indexable RGB-D dataset: `__getitem__` returns (image (3, H, W)
    float32 in [0, 1], depth (H, W) metres, w2c pose (4, 4), motion mask
    (H, W) bool, True on static pixels). Subclasses fill `poses` and
    `num_imgs`."""

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
        self.fovx = 2 * np.arctan(self.width / (2 * self.fx))
        self.fovy = 2 * np.arctan(self.height / (2 * self.fy))
        self.poses: list[np.ndarray] = []
        self.num_imgs = 0

    def __len__(self) -> int:
        return self.num_imgs


def load_dataset(args, path: str, config, device) -> BaseDataset:
    """Dataset factory. The port has the synthetic sequence; the TUM,
    CoFusion and RealSense loaders are not ported yet."""
    from fourdgs_torch.data.synthetic import SyntheticDataset

    dtype = config["Dataset"]["type"]
    if dtype == "synthetic":
        return SyntheticDataset(args, path, config, device=device)
    raise ValueError(f"dataset type {dtype!r} is not ported yet (only 'synthetic')")
