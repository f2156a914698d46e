# Frozen copy of fourdgs_torch/ops/rasterize/preprocess.py (lines 1-200,
# commit c19f610): the port's plain path, kept as the benchmark's
# reference, unchanged but for its imports, which name these copies.
"""Per-Gaussian screen-space preprocessing, EWA splatting (port of
fourdgs/ops/rasterize/preprocess.py).

Plain torch on (..., N) component vectors, differentiable by autograd,
including through the SE(3) retraction that produces the camera pose.
Every function broadcasts over a leading view axis: pass `T_cw` as
(V, 4, 4) to preprocess V views of one map at once (where the reference
vmaps).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# CUDA reference constants (auxiliary.h / forward.cu)
LOW_PASS = 0.3           # 2D covariance low-pass (forward.cu:113-115)
NEAR_Z = 0.2             # frustum near plane (auxiliary.h in_frustum)
ALPHA_MIN = 1.0 / 255.0  # min contributing alpha (forward.cu:355)
ALPHA_MAX = 0.99         # alpha clamp (forward.cu:353)
T_EPS = 1e-4             # transmittance termination (forward.cu:357)


class ScreenGaussians(NamedTuple):
    """Screen-space per-Gaussian quantities feeding the tile compositor."""

    mean2d: torch.Tensor   # (..., N, 2) pixel coords
    depth: torch.Tensor    # (..., N) camera-space z
    conic: torch.Tensor    # (..., N, 3) inverse 2D covariance (a, b, c)
    opacity: torch.Tensor  # (..., N) activated opacity, 0 where not visible
    color: torch.Tensor    # (..., N, C)
    radius: torch.Tensor   # (..., N) int32 pixel radius (0 = culled)
    visible: torch.Tensor  # (..., N) bool — in frustum, alive, radius > 0
    sigma3: torch.Tensor   # (..., N) UNCAPPED 3-sigma radius (cull bound)


def _rotmat_components(quats: torch.Tensor):
    r, x, y, z = quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    rx, ry, rz = r * x, r * y, r * z
    return (
        1 - 2 * (yy + zz), 2 * (xy - rz), 2 * (xz + ry),
        2 * (xy + rz), 1 - 2 * (xx + zz), 2 * (yz - rx),
        2 * (xz - ry), 2 * (yz + rx), 1 - 2 * (xx + yy),
    )


def _cov3d_components(scales: torch.Tensor, quats: torch.Tensor, scale_mod: float = 1.0):
    """Sigma = R S S^T R^T as 6 components [xx, xy, xz, yy, yz, zz]."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rotmat_components(quats)
    s0 = scale_mod * scales[..., 0]
    s1 = scale_mod * scales[..., 1]
    s2 = scale_mod * scales[..., 2]
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    sxx = m00 * m00 + m01 * m01 + m02 * m02
    sxy = m00 * m10 + m01 * m11 + m02 * m12
    sxz = m00 * m20 + m01 * m21 + m02 * m22
    syy = m10 * m10 + m11 * m11 + m12 * m12
    syz = m10 * m20 + m11 * m21 + m12 * m22
    szz = m20 * m20 + m21 * m21 + m22 * m22
    return sxx, sxy, sxz, syy, syz, szz


def compute_cov3d(scales: torch.Tensor, quats: torch.Tensor, scale_mod: float = 1.0) -> torch.Tensor:
    """Packed (N, 6) [xx, xy, xz, yy, yz, zz]."""
    return torch.stack(_cov3d_components(scales, quats, scale_mod), dim=-1)


def _R(T_cw: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """Entry (i, j) of a (..., 4, 4) matrix shaped to broadcast against
    (..., N) component vectors."""
    return T_cw[..., i, j, None]


def _ewa_cov2d_components(tx_cam, ty_cam, tz_cam, cov3d_c, T_cw, fx, fy,
                          tan_fovx, tan_fovy):
    """EWA projection of the 3D covariance to 2D (forward.cu:76-117);
    returns (a, b, c) with the low-pass added."""
    # guard the divide for culled/dead Gaussians (masked downstream)
    tz = torch.where(tz_cam > NEAR_Z, tz_cam, torch.ones_like(tz_cam))
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(tx_cam / tz, -limx, limx) * tz
    ty = torch.clamp(ty_cam / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    a00 = j00 * _R(T_cw, 0, 0) + j02 * _R(T_cw, 2, 0)
    a01 = j00 * _R(T_cw, 0, 1) + j02 * _R(T_cw, 2, 1)
    a02 = j00 * _R(T_cw, 0, 2) + j02 * _R(T_cw, 2, 2)
    a10 = j11 * _R(T_cw, 1, 0) + j12 * _R(T_cw, 2, 0)
    a11 = j11 * _R(T_cw, 1, 1) + j12 * _R(T_cw, 2, 1)
    a12 = j11 * _R(T_cw, 1, 2) + j12 * _R(T_cw, 2, 2)

    sxx, sxy, sxz, syy, syz, szz = cov3d_c
    s0x = sxx * a00 + sxy * a01 + sxz * a02
    s0y = sxy * a00 + syy * a01 + syz * a02
    s0z = sxz * a00 + syz * a01 + szz * a02
    s1x = sxx * a10 + sxy * a11 + sxz * a12
    s1y = sxy * a10 + syy * a11 + syz * a12
    s1z = sxz * a10 + syz * a11 + szz * a12
    a = a00 * s0x + a01 * s0y + a02 * s0z + LOW_PASS
    b = a00 * s1x + a01 * s1y + a02 * s1z
    c = a10 * s1x + a11 * s1y + a12 * s1z + LOW_PASS
    return a, b, c


def _camera_xyz(means3d: torch.Tensor, T_cw: torch.Tensor):
    x, y, z = means3d[..., 0], means3d[..., 1], means3d[..., 2]
    rows = [
        _R(T_cw, i, 0) * x + _R(T_cw, i, 1) * y + _R(T_cw, i, 2) * z + _R(T_cw, i, 3)
        for i in range(3)
    ]
    return x, y, z, rows


def ewa_cov2d(means3d, cov3d, T_cw, fx, fy, tan_fovx, tan_fovy) -> torch.Tensor:
    """Packed (N, 3) [a, b, c]."""
    _, _, _, (tcx, tcy, tcz) = _camera_xyz(means3d, T_cw)
    a, b, c = _ewa_cov2d_components(
        tcx, tcy, tcz, tuple(cov3d[..., i] for i in range(6)),
        T_cw, fx, fy, tan_fovx, tan_fovy,
    )
    return torch.stack([a, b, c], dim=-1)


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    alive: torch.Tensor,
    T_cw: torch.Tensor,
    proj: torch.Tensor,
    fx: float,
    fy: float,
    width: int,
    height: int,
    tan_fovx: float,
    tan_fovy: float,
    scale_mod: float = 1.0,
    max_radius: int | None = None,
) -> ScreenGaussians:
    """Cull + project + cov2d + conic + radius. `alive` masks dead
    capacity slots; `max_radius` caps the pixel radius so the tile
    footprint fits the binner's `max_rect`."""
    x, y, z, (tcx, tcy, depth) = _camera_xyz(means3d, T_cw)
    in_front = depth > NEAR_Z

    fp = proj @ T_cw
    hom_x = _R(fp, 0, 0) * x + _R(fp, 0, 1) * y + _R(fp, 0, 2) * z + _R(fp, 0, 3)
    hom_y = _R(fp, 1, 0) * x + _R(fp, 1, 1) * y + _R(fp, 1, 2) * z + _R(fp, 1, 3)
    w = _R(fp, 3, 0) * x + _R(fp, 3, 1) * y + _R(fp, 3, 2) * z + _R(fp, 3, 3)
    inv_w = 1.0 / (w + 1e-7)
    px = ((hom_x * inv_w + 1.0) * width - 1.0) * 0.5
    py = ((hom_y * inv_w + 1.0) * height - 1.0) * 0.5
    mean2d = torch.stack([px, py], dim=-1)

    cov3d_c = _cov3d_components(scales, quats, scale_mod)
    c2a, c2b, c2c = _ewa_cov2d_components(
        tcx, tcy, depth, cov3d_c, T_cw, fx, fy, tan_fovx, tan_fovy
    )

    det = c2a * c2c - c2b * c2b
    det_ok = det > 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / safe_det
    conic = torch.stack([c2c * inv_det, -c2b * inv_det, c2a * inv_det], dim=-1)

    mid = 0.5 * (c2a + c2c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    sigma3 = 3.0 * torch.sqrt(lam1)
    radius = torch.ceil(sigma3)
    if max_radius is not None:
        radius = torch.clamp(radius, max=float(max_radius))
    visible = alive & in_front & det_ok
    radius = torch.where(visible, radius, torch.zeros_like(radius)).to(torch.int32)
    visible = visible & (radius > 0)

    zero = torch.zeros_like(depth)
    return ScreenGaussians(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        opacity=torch.where(visible, opacities, zero),
        color=colors,
        radius=radius,
        visible=visible,
        sigma3=torch.where(visible, sigma3, zero),
    )
