"""CoFusion sequence loader (port of fourdgs/data/cofusion.py): `colour/`,
`depth_noise/*.exr` or `depth/*.png`, `mask_colour/` ground-truth dynamic
masks, `trajectories/gt-cam-0.txt`, and the calibration's `start`/`end`
frame window."""

from __future__ import annotations

import glob
import os

import cv2
import numpy as np
from PIL import Image

from fourdgs_torch.data.base import BaseDataset
from fourdgs_torch.data.tum import quat_to_mat


def read_exr_depth(path: str) -> np.ndarray:
    """Single-channel depth of an EXR file, through OpenCV's EXR reader."""
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    img = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    if img is None:
        raise RuntimeError(f"failed to read EXR: {path} (OpenCV built without OpenEXR?)")
    if img.ndim == 3:
        img = img[..., 0]
    return img.astype(np.float32)


class CoFusionDataset(BaseDataset):
    def __init__(self, args, path: str, config):
        super().__init__(args, path, config)
        self.color_paths = sorted(glob.glob(os.path.join(path, "colour", "*.png")))
        self.depth_paths = sorted(glob.glob(os.path.join(path, "depth_noise", "*.exr"))
                                  + glob.glob(os.path.join(path, "depth", "*.png")))
        self.mask_paths = sorted(glob.glob(os.path.join(path, "mask_colour", "*.png")))
        self.num_imgs = len(self.color_paths)
        self._load_poses(os.path.join(path, "trajectories"))

        calib = config["Dataset"]["Calibration"]
        start = calib.get("start", 0)
        end = calib.get("end", self.num_imgs)
        if end == -1:
            end = self.num_imgs
        self.color_paths = self.color_paths[start:end]
        self.depth_paths = self.depth_paths[start:end]
        self.poses = self.poses[start:end]
        self.mask_paths = self.mask_paths[start:end]
        self.num_imgs = len(self.color_paths)

    def _load_poses(self, traj_dir: str):
        pose_file = os.path.join(traj_dir, "gt-cam-0.txt")
        if not os.path.isfile(pose_file):
            self.poses = [np.eye(4) for _ in range(self.num_imgs)]
            return
        vecs = np.loadtxt(pose_file, dtype=np.float64)
        self.poses = []
        for i in range(self.num_imgs):
            T = quat_to_mat(vecs[i][4:8])   # xyzw
            T[:3, 3] = vecs[i][1:4]
            self.poses.append(np.linalg.inv(T))

    def _read_depth(self, idx: int) -> np.ndarray:
        p = self.depth_paths[idx]
        d = read_exr_depth(p) if p.endswith(".exr") else np.array(Image.open(p)).astype(
            np.float32)
        return d / self.depth_scale

    def __getitem__(self, idx: int):
        image, depth, pose, motion_mask = super().__getitem__(idx)
        if self.mask_paths:
            m = np.array(Image.open(self.mask_paths[idx]).convert("L"))
            motion_mask = ~(m > 255 * 0.01)
        return image, depth, pose, motion_mask
