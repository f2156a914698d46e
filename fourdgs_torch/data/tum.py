"""TUM RGB-D sequence parser and dataset (port of fourdgs/data/tum.py); the
Bonn RGB-D Dynamic sequences share the layout.

Association of the rgb/depth/groundtruth timestamp lists (nearest
timestamp within `max_dt` 0.08 s) and the thinning to `frame_rate` match
the reference TUMParser.
"""

from __future__ import annotations

import os

import numpy as np

from fourdgs_torch.data.base import BaseDataset


def quat_to_mat(qxyzw: np.ndarray) -> np.ndarray:
    """xyzw quaternion -> 4x4 homogeneous rotation."""
    x, y, z, w = qxyzw
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    T = np.eye(4)
    T[:3, :3] = np.array([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
    ])
    return T


class TUMParser:
    def __init__(self, input_folder: str, frame_rate: int = 32):
        self.input_folder = input_folder
        self.load_poses(input_folder, frame_rate)
        self.n_img = len(self.color_paths)

    @staticmethod
    def parse_list(filepath: str, skiprows: int = 0) -> np.ndarray:
        return np.loadtxt(filepath, delimiter=" ", dtype=str, skiprows=skiprows)

    @staticmethod
    def associate_frames(t_img, t_depth, t_pose, max_dt: float = 0.08):
        """(image, depth, pose) index triples: for each image, the nearest
        depth and pose timestamps, kept when both are within max_dt."""
        assoc = []
        for i, t in enumerate(t_img):
            j = int(np.argmin(np.abs(t_depth - t)))
            k = int(np.argmin(np.abs(t_pose - t)))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                assoc.append((i, j, k))
        return assoc

    def load_poses(self, datapath: str, frame_rate: int):
        pose_list = os.path.join(datapath, "groundtruth.txt")
        if not os.path.isfile(pose_list):
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self.parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self.parse_list(os.path.join(datapath, "depth.txt"))
        pose_vecs = self.parse_list(pose_list, skiprows=1).astype(np.float64)

        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        assoc = self.associate_frames(t_img, t_depth, pose_vecs[:, 0])

        # thin to frame_rate: keep a frame more than 1/frame_rate s after
        # the last kept one
        indices = [0]
        for i in range(1, len(assoc)):
            if t_img[assoc[i][0]] - t_img[assoc[indices[-1]][0]] > 1.0 / frame_rate:
                indices.append(i)

        self.color_paths, self.depth_paths, self.poses, self.tstamps = [], [], [], []
        for ix in indices:
            i, j, k = assoc[ix]
            self.color_paths.append(os.path.join(datapath, image_data[i, 1]))
            self.depth_paths.append(os.path.join(datapath, depth_data[j, 1]))
            T = quat_to_mat(pose_vecs[k][4:8])   # camera-to-world, qx qy qz qw
            T[:3, 3] = pose_vecs[k][1:4]
            self.poses.append(np.linalg.inv(T))  # world-to-camera
            self.tstamps.append(t_img[i])


class TUMDataset(BaseDataset):
    def __init__(self, args, path: str, config):
        super().__init__(args, path, config)
        parser = TUMParser(path)
        self.num_imgs = parser.n_img
        self.color_paths = parser.color_paths
        self.depth_paths = parser.depth_paths
        self.poses = parser.poses
        self.tstamps = parser.tstamps
