"""SO(3)/SE(3) exponential maps and the pose-retraction step (port of
fourdgs/geometry/se3.py).

Small-angle behaviour uses `torch.where` with the angle clamped away from
zero, like the reference, so autograd through the Taylor branch at
tau = 0 (every tracking iteration) is well-defined.

Convention: `tau = [rho(3), theta(3)]`; poses are 4x4 world-to-camera
matrices acting on column vectors.
"""

from __future__ import annotations

import torch

_EPS = 1e-5


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> 3x3 skew-symmetric matrix. Supports leading batch dims."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _safe_angle(theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    sq = torch.sum(theta * theta, dim=-1)
    small = sq < _EPS * _EPS
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    return angle, small


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with 2nd-order Taylor fallback near zero."""
    W = skew(theta)
    W2 = W @ W
    angle, small = _safe_angle(theta)
    a = angle[..., None, None]
    s = small[..., None, None]
    sin_t = torch.where(s, torch.ones_like(a), torch.sin(a) / a)
    cos_t = torch.where(s, torch.full_like(a, 0.5), (1.0 - torch.cos(a)) / (a * a))
    return _eye_like(W) + sin_t * W + cos_t * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse of so3_exp (principal branch)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_angle = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    angle = torch.arccos(cos_angle)
    small = angle < _EPS
    safe = torch.where(small, torch.ones_like(angle), angle)
    scale = torch.where(small, torch.full_like(angle, 0.5), 0.5 * safe / torch.sin(safe))
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    return scale[..., None] * w


def se3_V(theta: torch.Tensor) -> torch.Tensor:
    """Left-Jacobian V(theta) so that t = V @ rho."""
    W = skew(theta)
    W2 = W @ W
    angle, small = _safe_angle(theta)
    a = angle[..., None, None]
    s = small[..., None, None]
    c1 = torch.where(s, torch.full_like(a, 0.5), (1.0 - torch.cos(a)) / (a * a))
    c2 = torch.where(s, torch.full_like(a, 1.0 / 6.0), (a - torch.sin(a)) / (a * a * a))
    return _eye_like(W) + c1 * W + c2 * W2


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """tau = [rho, theta] -> 4x4 transform. Batchable over leading dims."""
    rho = tau[..., :3]
    theta = tau[..., 3:]
    R = so3_exp(theta)
    t = torch.einsum("...ij,...j->...i", se3_V(theta), rho)
    top = torch.cat([R, t[..., None]], dim=-1)
    # the row [0, 0, 0, 1] made on the device: no copy from the host, so
    # the map can be captured in a CUDA graph
    bottom = torch.zeros(tau.shape[:-1] + (1, 4), dtype=tau.dtype, device=tau.device)
    bottom[..., 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def se3_apply(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to (..., N, 3) points."""
    return points @ T[..., :3, :3].transpose(-1, -2) + T[..., :3, 3][..., None, :]


def update_pose(
    tau: torch.Tensor, T_cw: torch.Tensor, converged_threshold: float = 1e-4
) -> tuple[torch.Tensor, torch.Tensor]:
    """Left-multiplicative pose retraction: T' = exp(tau) @ T_cw; returns
    (new_T_cw, |tau| < threshold)."""
    new_T = se3_exp(tau) @ T_cw
    converged = torch.linalg.norm(tau) < converged_threshold
    return new_T, converged
