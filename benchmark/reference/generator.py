"""The benchmark's own sequence generator: the textured Gaussian room, the
moving blob and the orbiting camera, rendered by the frozen plain
renderer, and the TUM RGB-D layout writer.

Frozen copies of fourdgs_torch/data/synthetic.py (commit c19f610):
`_plane`, `make_room_scene`, `make_dynamic_blob` and `blob_offset` from
lines 27-100, `orbit_pose` from lines 103-118, the render of `_render`
from lines 151-168, and `write_tum_format`, `_write_rgbd` and
`_pose_line` from lines 189-242. Departures: the orbit's phase is an
argument (`orbit_pose(t)` of the copy is the port's), so that a
sequence can repeat one orbit of `frames_per_orbit` frames; and the TUM
writer takes the frames as arrays and lists a frame file once per frame
of the sequence, so that a periodic sequence is written once per orbit.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from benchmark.reference.geometry.projection import projection_matrix
from benchmark.reference.geometry.quaternion import rotmat_to_quat
from benchmark.reference.ops.rasterize.api import RasterConfig, rasterize


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
    """World-to-camera pose looking at the room center from a small orbit;
    t is the phase, one orbit per unit."""
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


def render_frame(scene, T_cw: np.ndarray, calib: dict, device) -> tuple[np.ndarray, np.ndarray]:
    """(image (3, H, W) in [0, 1], depth (H, W) metres, 0 where the render
    is not opaque) of the numpy scene at world-to-camera pose T_cw, by the
    plain renderer on `device`."""
    fx, fy, cx, cy = (float(calib[k]) for k in ("fx", "fy", "cx", "cy"))
    w, h = int(calib["width"]), int(calib["height"])
    pts, col, lscl, quats, opac = (torch.as_tensor(a, device=device) for a in scene)
    fovx, fovy = 2 * np.arctan(w / (2 * fx)), 2 * np.arctan(h / (2 * fy))
    with torch.no_grad():
        out = rasterize(
            pts, torch.exp(lscl), quats, opac, col,
            torch.ones(pts.shape[0], dtype=torch.bool, device=device),
            torch.as_tensor(T_cw, dtype=torch.float32, device=device),
            projection_matrix(fx, fy, cx, cy, w, h, device=device),
            torch.zeros(3, device=device),
            fx=fx, fy=fy, width=w, height=h,
            tan_fovx=float(np.tan(fovx / 2)), tan_fovy=float(np.tan(fovy / 2)),
            config=RasterConfig(),
        )
    image = torch.clamp(out.color, 0, 1)
    depth = torch.where(out.alpha > 0.5, out.depth / torch.clamp(out.alpha, min=1e-6),
                        torch.zeros_like(out.depth))
    return image.cpu().numpy(), depth.cpu().numpy()


def scene_at(static_scene, blob, time: float):
    """The static scene, and the blob (if any) at normalized time."""
    if blob is None:
        return static_scene
    bpts = blob[0] + blob_offset(time)[None]
    return tuple(np.concatenate([a, b]) for a, b in zip(static_scene, (bpts,) + blob[1:]))


def write_tum_format(frames, poses, out_dir: str, depth_scale: float = 5000.0,
                     rate_hz: float = 30.0):
    """Write a sequence in TUM RGB-D layout. `frames` holds one (image,
    depth) pair per distinct frame and `poses` one world-to-camera pose
    per frame of the sequence; frame i shows `frames[i % len(frames)]`.
    Colour as 8-bit RGB, depth as 16-bit at `depth_scale` units per
    metre; `rgb.txt`, `depth.txt` and `groundtruth.txt` (tx ty tz qx qy
    qz qw of camera-to-world) at `rate_hz` timestamps."""
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    for k, (img, depth) in enumerate(frames):
        _write_rgbd(img, depth, os.path.join(out_dir, "rgb", f"{k:05d}.png"),
                    os.path.join(out_dir, "depth", f"{k:05d}.png"), depth_scale)
    rgb_lines, depth_lines = ["# color images"], ["# depth"]
    gt_lines = ["# ground truth trajectory"]
    for i, T_cw in enumerate(poses):
        k = i % len(frames)
        ts = f"{i / rate_hz + 1000.0:.6f}"
        rgb_lines.append(f"{ts} rgb/{k:05d}.png")
        depth_lines.append(f"{ts} depth/{k:05d}.png")
        gt_lines.append(f"{ts} {_pose_line(T_cw)}")
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def _write_rgbd(img, depth, color_path: str, depth_path: str, depth_scale: float):
    """Colour as 8-bit RGB, depth as 16-bit at `depth_scale` units per metre."""
    Image.fromarray((np.transpose(img, (1, 2, 0)) * 255).astype(np.uint8)).save(color_path)
    Image.fromarray(np.clip(depth * depth_scale, 0, 65535).astype(np.uint16)).save(depth_path)


def _pose_line(T_cw) -> str:
    """tx ty tz qx qy qz qw of the camera-to-world pose."""
    T_wc = np.linalg.inv(T_cw)
    q = rotmat_to_quat(torch.as_tensor(T_wc[:3, :3], dtype=torch.float32)).numpy()
    tx, ty, tz = T_wc[:3, 3]
    return f"{tx:.6f} {ty:.6f} {tz:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}"
