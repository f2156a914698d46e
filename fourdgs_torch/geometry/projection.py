"""Pinhole projection matrices and depth back-projection (port of
fourdgs/geometry/projection.py). Column-vector convention throughout:
clip = P @ T_cw @ [x; 1]."""

from __future__ import annotations

import math

import torch

from fourdgs_torch.utils.trace import sync


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def projection_matrix(
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    znear: float = 0.01,
    zfar: float = 100.0,
    *,
    device: torch.device | str,
) -> torch.Tensor:
    """Off-center perspective projection (getProjectionMatrix2
    semantics): camera space to clip space with w = z."""
    left = ((2.0 * cx - width) / width - 1.0) * width / 2.0
    right = ((2.0 * cx - width) / width + 1.0) * width / 2.0
    top = ((2.0 * cy - height) / height + 1.0) * height / 2.0
    bottom = ((2.0 * cy - height) / height - 1.0) * height / 2.0
    left *= znear / fx
    right *= znear / fx
    top *= znear / fy
    bottom *= znear / fy

    P = torch.zeros((4, 4), dtype=torch.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    with sync("proj.h2d"):
        return P.to(device)


def world_to_view(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble T_cw from a world-to-camera rotation and translation."""
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def full_projection(P: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
    """Clip-from-world matrix."""
    return P @ T_cw


def camera_center(T_cw: torch.Tensor) -> torch.Tensor:
    """Camera position in world coordinates: -R^T t."""
    return -T_cw[:3, :3].T @ T_cw[:3, 3]


def backproject_depth(
    depth: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    T_cw: torch.Tensor,
) -> torch.Tensor:
    """Depth map (H, W) -> world-space points (H*W, 3). Invalid
    (depth <= 0) pixels still produce rows; callers mask them."""
    H, W = depth.shape
    v, u = torch.meshgrid(
        torch.arange(H, device=depth.device),
        torch.arange(W, device=depth.device),
        indexing="ij",
    )
    z = depth
    x = (u.to(depth.dtype) - cx) * z / fx
    y = (v.to(depth.dtype) - cy) * z / fy
    pts_cam = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    return (pts_cam - t) @ R
