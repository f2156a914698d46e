"""Synthetic RGB-D sequences rendered from a ground-truth Gaussian scene
(port of fourdgs/data/synthetic.py without `write_tum_format`).

A procedurally textured room built from Gaussians, an orbiting camera
trajectory and, with `dynamic`, a blob of Gaussians that moves over
normalized time, with exact motion masks; all drawn from numpy generators
seeded from the config. Frames are rendered by the port's own rasterizer
at the ground-truth poses, on the dataset's device, so SLAM on the output
has a well-defined optimum.
"""

from __future__ import annotations

import numpy as np
import torch

from fourdgs_torch.data.base import BaseDataset
from fourdgs_torch.geometry.projection import projection_matrix
from fourdgs_torch.ops.rasterize.api import RasterConfig, rasterize


def _plane(rng, n, origin, u_axis, v_axis, color_fn, scale=0.04):
    uu = rng.uniform(0, 1, n)
    vv = rng.uniform(0, 1, n)
    pts = (
        np.asarray(origin)[None]
        + uu[:, None] * np.asarray(u_axis)[None]
        + vv[:, None] * np.asarray(v_axis)[None]
    )
    colors = color_fn(uu, vv)
    scales = np.full((n, 3), scale) * rng.uniform(0.6, 1.6, (n, 1))
    return pts.astype(np.float32), colors.astype(np.float32), scales.astype(np.float32)


def make_room_scene(seed: int = 0, points_per_wall: int = 3000):
    """Gaussian 'room': floor, ceiling, back wall, two side walls, textured.
    Returns (means, colors, log-scales, quats, opacities) numpy arrays."""
    rng = np.random.default_rng(seed)
    walls = []

    def tex(a, b, ph):
        def fn(u, v):
            return np.stack(
                [
                    0.5 + 0.45 * np.sin(a * u * 6.28 + ph),
                    0.5 + 0.45 * np.cos(b * v * 6.28 + ph * 2),
                    0.5 + 0.45 * np.sin((a * u + b * v) * 6.28),
                ],
                axis=-1,
            )
        return fn

    n = points_per_wall
    walls.append(_plane(rng, n, [-2, 1.2, 1], [4, 0, 0], [0, 0, 4], tex(3, 2, 0.0)))   # floor
    walls.append(_plane(rng, n, [-2, -1.2, 1], [4, 0, 0], [0, 0, 4], tex(2, 3, 1.0)))  # ceiling
    walls.append(_plane(rng, n, [-2, -1.2, 5], [4, 0, 0], [0, 2.4, 0], tex(4, 4, 2.0)))  # back
    walls.append(_plane(rng, n, [-2, -1.2, 1], [0, 2.4, 0], [0, 0, 4], tex(5, 2, 0.5)))  # left
    walls.append(_plane(rng, n, [2, -1.2, 1], [0, 2.4, 0], [0, 0, 4], tex(2, 5, 1.5)))   # right
    pts = np.concatenate([w[0] for w in walls])
    col = np.concatenate([w[1] for w in walls])
    scl = np.concatenate([w[2] for w in walls])
    quats = np.zeros((pts.shape[0], 4), np.float32)
    quats[:, 0] = 1.0
    opac = np.full(pts.shape[0], 0.95, np.float32)
    return pts, col, np.log(scl), quats, opac


def make_dynamic_blob(seed: int = 1, n: int = 400):
    """A compact cluster of Gaussians that translates along x over
    normalized time. Returns (means, colors, log-scales, quats,
    opacities) numpy arrays."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 0.12, (n, 3)).astype(np.float32) + np.array(
        [0.0, 0.2, 2.5], np.float32
    )
    col = np.tile(np.array([[0.9, 0.15, 0.1]], np.float32), (n, 1))
    col += rng.uniform(-0.05, 0.05, (n, 3)).astype(np.float32)
    scl = np.log(np.full((n, 3), 0.05, np.float32))
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    opac = np.full(n, 0.95, np.float32)
    return pts, col, scl, quats, opac


def blob_offset(time: float) -> np.ndarray:
    """Ground-truth trajectory of the dynamic blob (x sweep, slight bob)."""
    return np.array(
        [1.2 * (time - 0.5), 0.15 * np.sin(time * 6.28), 0.0], np.float32
    )


def orbit_pose(t: float, radius: float = 0.12) -> np.ndarray:
    """World-to-camera pose looking at the room center from a small orbit
    (~centimetres per frame, like handheld RGB-D footage)."""
    ang = 0.6 * np.sin(t * 2 * np.pi)
    cx = radius * np.sin(ang)
    cz = 0.08 * (1 - np.cos(ang))
    yaw = 0.06 * np.sin(ang)
    cy_, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
    c = np.array([cx, 0.0, cz])
    T = np.eye(4)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ c
    return T


class SyntheticDataset(BaseDataset):
    """config["Dataset"] extras: num_frames, dynamic, seed,
    points_per_wall."""

    def __init__(self, args, path: str, config, device: torch.device | str):
        super().__init__(args, path, config)
        ds = config["Dataset"]
        self.device = torch.device(device)
        self.num_imgs = int(ds.get("num_frames", 60))
        seed = int(ds.get("seed", 0))
        ppw = int(ds.get("points_per_wall", 3000))
        self.static_scene = make_room_scene(seed, ppw)
        self.blob = make_dynamic_blob(seed + 1) if ds.get("dynamic", False) else None
        self.poses = [orbit_pose(i / max(self.num_imgs - 1, 1)) for i in range(self.num_imgs)]
        self._proj = projection_matrix(self.fx, self.fy, self.cx, self.cy, self.width,
                                       self.height, device=self.device)
        self._cache: dict[int, tuple] = {}

    def _time(self, idx: int) -> float:
        return idx / max(self.num_imgs - 1, 1)

    def _scene_at(self, idx: int):
        """The static scene, and the blob at frame idx's time."""
        if self.blob is None:
            return self.static_scene
        bpts = self.blob[0] + blob_offset(self._time(idx))[None]
        return tuple(np.concatenate([a, b]) for a, b in
                     zip(self.static_scene, (bpts,) + self.blob[1:]))

    def _render(self, idx: int):
        pts, col, lscl, quats, opac = (
            torch.as_tensor(a, device=self.device) for a in self._scene_at(idx)
        )
        with torch.no_grad():
            out = rasterize(
                pts, torch.exp(lscl), quats, opac, col,
                torch.ones(pts.shape[0], dtype=torch.bool, device=self.device),
                torch.as_tensor(self.poses[idx], dtype=torch.float32, device=self.device),
                self._proj, torch.zeros(3, device=self.device),
                fx=self.fx, fy=self.fy, width=self.width, height=self.height,
                tan_fovx=float(np.tan(self.fovx / 2)), tan_fovy=float(np.tan(self.fovy / 2)),
                config=RasterConfig(),
            )
        image = torch.clamp(out.color, 0, 1)
        depth = torch.where(out.alpha > 0.5, out.depth / torch.clamp(out.alpha, min=1e-6),
                            torch.zeros_like(out.depth))
        return image.cpu().numpy(), depth.cpu().numpy()

    def motion_mask_gt(self, idx: int) -> np.ndarray:
        """Exact motion mask (True = static): 8x8-pixel squares around the
        projections of the blob's Gaussians."""
        if self.blob is None:
            return np.ones((self.height, self.width), bool)
        bpts = self.blob[0] + blob_offset(self._time(idx))[None]
        T = self.poses[idx]
        pc = bpts @ T[:3, :3].T + T[:3, 3]
        z = np.maximum(pc[:, 2], 1e-4)
        u = (self.fx * pc[:, 0] / z + self.cx).astype(int)
        v = (self.fy * pc[:, 1] / z + self.cy).astype(int)
        mask = np.zeros((self.height, self.width), bool)
        r = 4
        for uu, vv in zip(u, v):
            if 0 <= uu < self.width and 0 <= vv < self.height:
                mask[max(0, vv - r):vv + r, max(0, uu - r):uu + r] = True
        return ~mask

    def __getitem__(self, idx: int):
        if idx not in self._cache:
            self._cache[idx] = self._render(idx)
        image, depth = self._cache[idx]
        return image, depth, self.poses[idx], self.motion_mask_gt(idx)
