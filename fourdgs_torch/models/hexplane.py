"""HexPlane deformation field, 4DGaussians' (port of
fourdgs/models/hexplane.py).

Six multi-resolution 2D feature planes over the coordinate pairs (xy, xz,
yz, xt, yt, zt): the features are sampled bilinearly, multiplied across
the six planes of a scale, concatenated across scales, and decoded by an
MLP into (dx, ds, dr). Nothing in the SLAM path trains it, in the
reference as here; `get_dynamic_mask` and the plane regularizers are its
surface.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PAIRS = ((0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3))
SPATIAL_PAIRS = (0, 1, 2)
TIME_PAIRS = (3, 4, 5)


class HexPlaneParams(NamedTuple):
    planes: tuple                # 6 * n_scales tensors (C, R_b, R_a)
    head_w1: torch.Tensor
    head_b1: torch.Tensor
    dx_w: torch.Tensor
    dx_b: torch.Tensor
    ds_w: torch.Tensor
    ds_b: torch.Tensor
    dr_w: torch.Tensor
    dr_b: torch.Tensor
    aabb_min: torch.Tensor       # (3,)
    aabb_max: torch.Tensor       # (3,)


def init_hexplane(generator: torch.Generator, resolution=(64, 64, 64, 25), out_dim: int = 32,
                  multires=(1, 2, 4, 8), width: int = 64, aabb_min=(-2.0, -2.0, -2.0),
                  aabb_max=(2.0, 2.0, 2.0), device="cpu") -> HexPlaneParams:
    """The field at 4DGaussians' kplanes defaults: per scale the spatial
    resolutions times the scale (time's unscaled), features uniform in
    [0.1, 0.5], the first head layer He-normal, the output heads normal at
    1e-5, biases zero. Drawn from `generator` on the CPU, then moved."""
    def uniform(shape):
        return torch.rand(shape, generator=generator) * 0.4 + 0.1

    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    planes = []
    for scale in multires:
        res = [resolution[0] * scale, resolution[1] * scale, resolution[2] * scale,
               resolution[3]]
        planes += [uniform((out_dim, res[b], res[a])) for a, b in PAIRS]
    feat_dim = out_dim * len(multires)
    hp = HexPlaneParams(
        planes=tuple(planes),
        head_w1=normal((feat_dim, width), (2.0 / feat_dim) ** 0.5), head_b1=torch.zeros(width),
        dx_w=normal((width, 3), 1e-5), dx_b=torch.zeros(3),
        ds_w=normal((width, 3), 1e-5), ds_b=torch.zeros(3),
        dr_w=normal((width, 4), 1e-5), dr_b=torch.zeros(4),
        aabb_min=torch.tensor(aabb_min, dtype=torch.float32),
        aabb_max=torch.tensor(aabb_max, dtype=torch.float32),
    )
    return to_device(hp, device)


def to_device(params, device):
    """A field's parameters (a NamedTuple of tensors and tuples of them)
    on `device`."""
    return type(params)(*(tuple(p.to(device) for p in f) if isinstance(f, tuple)
                          else f.to(device) for f in params))


def clip01(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 1] with the reference's gradient: 1 inside, 0 outside
    and 1/2 at either bound (max/min split a tie; torch.clamp gives 1)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _grid_sample_2d(plane: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """plane (C, H, W), uv (N, 2) in [0, 1] -> (N, C): bilinear with
    align-corners semantics, as four gathers. The lower corner is clipped
    to W - 2 (H - 2), so uv = 1 blends the last two texels with weight 1
    on the last: F.grid_sample's value, but not always its gradient."""
    c, h, w = plane.shape
    x = clip01(uv[:, 0]) * (w - 1)
    y = clip01(uv[:, 1]) * (h - 1)
    x0 = torch.clamp(torch.floor(x).to(torch.long), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.long), 0, h - 2)
    dx = x - x0
    dy = y - y0
    p = plane.reshape(c, h * w)

    def g(yy, xx):
        return p[:, yy * w + xx].T  # (N, C)

    return (g(y0, x0) * ((1 - dx) * (1 - dy))[:, None]
            + g(y0, x0 + 1) * (dx * (1 - dy))[:, None]
            + g(y0 + 1, x0) * ((1 - dx) * dy)[:, None]
            + g(y0 + 1, x0 + 1) * (dx * dy)[:, None])


def hexplane_features(hp: HexPlaneParams, xyz: torch.Tensor, t) -> torch.Tensor:
    """(N, 3) points at scalar time t -> (N, out_dim * n_scales)."""
    n = xyz.shape[0]
    norm = (xyz - hp.aabb_min) / (hp.aabb_max - hp.aabb_min)
    tt = torch.as_tensor(t, dtype=xyz.dtype, device=xyz.device).reshape(1).expand(n)
    coords = torch.cat([norm, tt[:, None]], dim=1)  # (N, 4)
    feats = []
    for s in range(len(hp.planes) // 6):
        prod = None
        for pi, (a, b) in enumerate(PAIRS):
            f = _grid_sample_2d(hp.planes[s * 6 + pi], torch.stack([coords[:, a], coords[:, b]],
                                                                    dim=1))
            prod = f if prod is None else prod * f
        feats.append(prod)
    return torch.cat(feats, dim=1)


def hexplane_deform(hp: HexPlaneParams, xyz: torch.Tensor, t):
    """(dx, ds, dr) per point."""
    h = torch.relu(hexplane_features(hp, xyz, t) @ hp.head_w1 + hp.head_b1)
    return h @ hp.dx_w + hp.dx_b, h @ hp.ds_w + hp.ds_b, h @ hp.dr_w + hp.dr_b


def get_dynamic_mask(hp: HexPlaneParams, xyz: torch.Tensor, t, dx_th: float = 1e-3,
                     ds_th: float = 1e-3, dr_th: float = 1e-3) -> torch.Tensor:
    """(N,) bool: the points whose deltas pass a threshold."""
    dx, ds, dr = hexplane_deform(hp, xyz, t)
    norm = torch.linalg.vector_norm
    return (norm(dx, dim=-1) > dx_th) | (norm(ds, dim=-1) > ds_th) | (norm(dr, dim=-1) > dr_th)


# ---------------------------------------------------------------------------
# Plane regularizers
# ---------------------------------------------------------------------------


def _plane_tv(plane: torch.Tensor) -> torch.Tensor:
    d1 = plane[:, 1:, :] - plane[:, :-1, :]
    d2 = plane[:, :, 1:] - plane[:, :, :-1]
    return torch.mean(d1 * d1) + torch.mean(d2 * d2)


def _planes(hp: HexPlaneParams, pairs):
    return [hp.planes[s * 6 + pi] for s in range(len(hp.planes) // 6) for pi in pairs]


def plane_tv_loss(hp: HexPlaneParams) -> torch.Tensor:
    """Total variation over the spatial planes."""
    return sum((_plane_tv(p) for p in _planes(hp, SPATIAL_PAIRS)), hp.planes[0].new_zeros(()))


def time_smoothness_loss(hp: HexPlaneParams) -> torch.Tensor:
    """Second-difference smoothness along time, the rows of the
    spatio-temporal planes."""
    total = hp.planes[0].new_zeros(())
    for p in _planes(hp, TIME_PAIRS):
        dd = p[:, 2:, :] - 2 * p[:, 1:-1, :] + p[:, :-2, :]
        total = total + torch.mean(dd * dd)
    return total


def l1_time_planes_loss(hp: HexPlaneParams) -> torch.Tensor:
    """L1 pull of the spatio-temporal planes toward the identity feature 1."""
    return sum((torch.mean(torch.abs(1.0 - p)) for p in _planes(hp, TIME_PAIRS)),
               hp.planes[0].new_zeros(()))
