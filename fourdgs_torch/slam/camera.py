"""Camera intrinsics and per-frame data (port of fourdgs/slam/camera.py)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from fourdgs_torch.geometry.projection import focal2fov, projection_matrix
from fourdgs_torch.ops.image import grad_intensity_mask


class Intrinsics(NamedTuple):
    """Pinhole intrinsics."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def tan_fovx(self) -> float:
        return math.tan(focal2fov(self.fx, self.width) / 2.0)

    @property
    def tan_fovy(self) -> float:
        return math.tan(focal2fov(self.fy, self.height) / 2.0)

    def proj(self, znear: float = 0.01, zfar: float = 100.0, *,
             device: torch.device | str) -> torch.Tensor:
        return projection_matrix(
            self.fx, self.fy, self.cx, self.cy, self.width, self.height,
            znear, zfar, device=device,
        )

    def raster_kw(self) -> dict:
        """The static camera arguments of `rasterize`."""
        return dict(fx=self.fx, fy=self.fy, width=self.width, height=self.height,
                    tan_fovx=self.tan_fovx, tan_fovy=self.tan_fovy)

    @classmethod
    def from_config(cls, config) -> "Intrinsics":
        """The calibration of `config["Dataset"]["Calibration"]`."""
        c = config["Dataset"]["Calibration"]
        return cls(fx=float(c["fx"]), fy=float(c["fy"]), cx=float(c["cx"]), cy=float(c["cy"]),
                   width=int(c["width"]), height=int(c["height"]))

    @classmethod
    def from_dataset(cls, ds) -> "Intrinsics":
        """The calibration a dataset carries: its config's, or a live
        camera's own."""
        return cls(fx=float(ds.fx), fy=float(ds.fy), cx=float(ds.cx), cy=float(ds.cy),
                   width=int(ds.width), height=int(ds.height))


class Frame(NamedTuple):
    """One RGB-D observation on the device. `motion_mask` is True on
    static pixels; `time` is the normalized timestamp idx/(N-1)."""

    uid: int
    image: torch.Tensor        # (3, H, W) float32 in [0,1]
    depth: torch.Tensor        # (H, W) float32, metres; 0 = invalid
    motion_mask: torch.Tensor  # (H, W) bool, True = static
    grad_mask: torch.Tensor    # (H, W) bool — Scharr edge mask for tracking
    T_gt: np.ndarray           # (4, 4) ground-truth world-to-camera (eval only)
    time: float


def make_frame(uid: int, image, depth, T_gt, time: float, motion_mask=None,
               edge_threshold: float = 1.1, *, device: torch.device | str) -> Frame:
    """A frame on `device`. A frame without depth (`depth` None: a
    `sensor_type: monocular` recording) carries depth zeros, which every
    depth mask reads as invalid."""
    image = torch.as_tensor(image, dtype=torch.float32, device=device)
    if depth is None:
        depth = torch.zeros(image.shape[1:], dtype=torch.float32, device=device)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=device)
    if motion_mask is None:
        motion_mask = torch.ones(depth.shape, dtype=torch.bool, device=device)
    else:
        motion_mask = torch.as_tensor(motion_mask, dtype=torch.bool, device=device)
    grad_mask = grad_intensity_mask(image, edge_threshold)[0]
    return Frame(
        uid=int(uid),
        image=image,
        depth=depth,
        motion_mask=motion_mask,
        grad_mask=grad_mask,
        T_gt=np.asarray(T_gt, np.float32),
        time=float(time),
    )
