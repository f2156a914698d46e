"""Fixed-capacity Gaussian map: the scene model of the SLAM system (port of
fourdgs/models/gaussian_map.py).

The map is a preallocated capacity-C set of tensors with an `alive` mask,
as in the reference: insertion writes new Gaussians into dead slots (and
zeroes their Adam moments), pruning clears `alive` (and the moments),
densify clones and splits through the same insertion path. Slots, masks
and NaN-safe dead-slot defaults show up in results, so they are kept even
though PyTorch could grow tensors instead.

Functions take and return `GaussianMap` / `AdamState` named tuples of
tensors; random numbers arrive as arguments (see utils/draws.py).
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from fourdgs_torch.geometry.projection import backproject_depth
from fourdgs_torch.geometry.quaternion import quat_normalize, quat_to_rotmat
from fourdgs_torch.geometry.sh import rgb_to_sh0, sh0_to_rgb
from fourdgs_torch.ops.knn import knn_mean_sq_dist


def inverse_sigmoid(x):
    return math.log(x / (1.0 - x))


class GaussianParams(NamedTuple):
    """Learnable per-Gaussian parameters (raw, pre-activation)."""

    xyz: torch.Tensor       # (C, 3)
    f_dc: torch.Tensor      # (C, 3) SH DC coefficients
    scaling: torch.Tensor   # (C, 3) log-scale
    rotation: torch.Tensor  # (C, 4) unnormalized quaternion (wxyz)
    opacity: torch.Tensor   # (C, 1) logit-opacity

    def map(self, fn) -> "GaussianParams":
        return GaussianParams(*(fn(x) for x in self))


class GaussianMap(NamedTuple):
    params: GaussianParams
    alive: torch.Tensor        # (C,) bool
    dygs: torch.Tensor         # (C,) bool — dynamic Gaussian flag
    kf_id: torch.Tensor        # (C,) int32 spawning keyframe
    n_obs: torch.Tensor        # (C,) int32
    max_radii2d: torch.Tensor  # (C,) float32
    grad_accum: torch.Tensor   # (C,) float32 — |d mean2d| accumulated
    denom: torch.Tensor        # (C,) float32

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.params.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        return quat_normalize(self.params.rotation)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.params.opacity)[:, 0]

    @property
    def get_color(self) -> torch.Tensor:
        return sh0_to_rgb(self.params.f_dc)

    @property
    def num_alive(self) -> int:
        return int(self.alive.sum())


class AdamState(NamedTuple):
    """Per-field Adam moments (eps 1e-15 as the reference's
    torch.optim.Adam(eps=1e-15)); `count` is a host integer."""

    mu: GaussianParams
    nu: GaussianParams
    count: int


class MapLRs(NamedTuple):
    """Per-field learning rates (spatial_lr_scale = 6)."""

    xyz: float = 0.00016 * 6.0
    f_dc: float = 0.0025
    scaling: float = 0.001 * 6.0
    rotation: float = 0.001
    opacity: float = 0.05


def empty_map(capacity: int, device: torch.device | str) -> GaussianMap:
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    rot = z(capacity, 4)
    rot[:, 0] = 1.0
    return GaussianMap(
        params=GaussianParams(
            xyz=z(capacity, 3),
            f_dc=z(capacity, 3),
            scaling=torch.full((capacity, 3), -10.0, device=device),
            rotation=rot,
            opacity=torch.full((capacity, 1), -10.0, device=device),
        ),
        alive=z(capacity, dtype=torch.bool),
        dygs=z(capacity, dtype=torch.bool),
        kf_id=z(capacity, dtype=torch.int32),
        n_obs=z(capacity, dtype=torch.int32),
        max_radii2d=z(capacity),
        grad_accum=z(capacity),
        denom=z(capacity),
    )


def init_adam(capacity: int, device: torch.device | str) -> AdamState:
    zero = empty_map(capacity, device).params.map(torch.zeros_like)
    return AdamState(mu=zero, nu=zero, count=0)


def _bookkeeping(gmap: GaussianMap):
    return (gmap.alive, gmap.dygs, gmap.kf_id, gmap.n_obs, gmap.max_radii2d,
            gmap.grad_accum, gmap.denom)


def resize_map(gmap: GaussianMap, adam: AdamState, new_capacity: int):
    """Grow (or shrink, alive slots permitting) the capacity. Growth pads
    parameters with the safe dead-slot defaults of `empty_map`, never
    zeros: a zero quaternion NaNs the normalize backward."""
    old = gmap.capacity
    dev = gmap.alive.device
    if new_capacity >= old:
        fresh = empty_map(new_capacity, dev)
        params = GaussianParams(*(
            torch.cat([p, f[old:]]) for p, f in zip(gmap.params, fresh.params)
        ))
        book = [torch.cat([a, f[old:]]) for a, f in zip(_bookkeeping(gmap), _bookkeeping(fresh))]

        def grow(x):
            return torch.cat([x, x.new_zeros((new_capacity - old,) + x.shape[1:])])

        adam2 = AdamState(mu=adam.mu.map(grow), nu=adam.nu.map(grow), count=adam.count)
        return GaussianMap(params, *book), adam2
    order = torch.argsort((~gmap.alive).to(torch.int8), stable=True)[:new_capacity]

    def take(x):
        return x[order]

    gmap2 = GaussianMap(gmap.params.map(take), *(take(a) for a in _bookkeeping(gmap)))
    adam2 = AdamState(mu=adam.mu.map(take), nu=adam.nu.map(take), count=adam.count)
    return gmap2, adam2


def adam_step(
    params: GaussianParams,
    grads: GaussianParams,
    state: AdamState,
    lrs: MapLRs,
    alive: torch.Tensor,
    xyz_lr_mult: float = 1.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
) -> tuple[GaussianParams, AdamState]:
    """Adam update gated by `alive`: dead slots never move. The gate is a
    `where`, not a multiply — a NaN gradient on a dead slot must not poison
    it (NaN * 0 is still NaN)."""
    count = state.count + 1
    c1 = 1.0 - b1**count
    c2 = 1.0 - b2**count
    lr_map = lrs._asdict()
    lr_map["xyz"] = lrs.xyz * xyz_lr_mult
    new_p, new_mu, new_nu = {}, {}, {}
    for name in GaussianParams._fields:
        p = getattr(params, name)
        g = getattr(grads, name)
        mu = b1 * getattr(state.mu, name) + (1 - b1) * g
        nu = b2 * getattr(state.nu, name) + (1 - b2) * g * g
        step = lr_map[name] * (mu / c1) / (torch.sqrt(nu / c2) + eps)
        mask = alive.reshape((-1,) + (1,) * (p.dim() - 1))
        zero = torch.zeros_like(p)
        new_p[name] = torch.where(mask, p - step, p)
        new_mu[name] = torch.where(mask, mu, zero)
        new_nu[name] = torch.where(mask, nu, zero)
    return GaussianParams(**new_p), AdamState(
        mu=GaussianParams(**new_mu), nu=GaussianParams(**new_nu), count=count
    )


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=30000) -> float:
    """3DGS exponential LR schedule: log-linear lr_init -> lr_final over
    max_steps (the delay easing only when lr_delay_steps > 0)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0)
        )
    else:
        delay = 1.0
    return delay * math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


class NewGaussians(NamedTuple):
    """A batch of candidate insertions (masked by `valid`)."""

    xyz: torch.Tensor       # (P, 3)
    rgb: torch.Tensor       # (P, 3) linear color in [0,1]
    scaling: torch.Tensor   # (P, 3) log-scale
    rotation: torch.Tensor  # (P, 4)
    opacity: torch.Tensor   # (P, 1) raw
    valid: torch.Tensor     # (P,) bool


def insert_raw(gmap: GaussianMap, adam: AdamState, new: NewGaussians,
               kf_src: torch.Tensor, dy_src: torch.Tensor):
    """Place valid candidates in dead slots, carrying per-candidate kf_id
    and dygs: new Gaussians get zeroed Adam moments and reset stats.
    Candidates beyond the free slots are dropped. Returns (map, adam,
    number inserted)."""
    p = min(new.valid.shape[0], gmap.capacity)
    cand_order = torch.argsort((~new.valid).to(torch.int8), stable=True)[:p]
    slots = torch.argsort(gmap.alive.to(torch.int8), stable=True)[:p]
    take = new.valid[cand_order] & ~gmap.alive[slots]

    def put(arr, vals):
        mask = take.reshape((-1,) + (1,) * (arr.dim() - 1))
        out = arr.clone()
        out[slots] = torch.where(mask, vals[cand_order].to(arr.dtype), arr[slots])
        return out

    def zput(arr):
        return put(arr, torch.zeros((new.valid.shape[0],) + arr.shape[1:],
                                    dtype=arr.dtype, device=arr.device))

    params = GaussianParams(
        xyz=put(gmap.params.xyz, new.xyz),
        f_dc=put(gmap.params.f_dc, rgb_to_sh0(new.rgb)),
        scaling=put(gmap.params.scaling, new.scaling),
        rotation=put(gmap.params.rotation, new.rotation),
        opacity=put(gmap.params.opacity, new.opacity),
    )
    ones = torch.ones_like(new.valid)
    gmap2 = GaussianMap(
        params=params,
        alive=put(gmap.alive, ones),
        dygs=put(gmap.dygs, dy_src),
        kf_id=put(gmap.kf_id, kf_src),
        n_obs=zput(gmap.n_obs),
        max_radii2d=zput(gmap.max_radii2d),
        grad_accum=zput(gmap.grad_accum),
        denom=zput(gmap.denom),
    )
    adam2 = AdamState(mu=adam.mu.map(zput), nu=adam.nu.map(zput), count=adam.count)
    return gmap2, adam2, int(take.sum())


def insert(gmap: GaussianMap, adam: AdamState, new: NewGaussians, kf_id: int,
           dygs: bool = False):
    """Insert candidates spawned by keyframe `kf_id`."""
    n = new.valid.shape[0]
    dev = new.valid.device
    return insert_raw(
        gmap, adam, new,
        torch.full((n,), kf_id, dtype=torch.int32, device=dev),
        torch.full((n,), dygs, dtype=torch.bool, device=dev),
    )


def prune(gmap: GaussianMap, adam: AdamState, kill: torch.Tensor):
    """Clear `alive` for killed slots and zero their Adam moments."""
    keepf = (gmap.alive & ~kill).to(torch.float32)

    def m(x):
        return x * keepf.reshape((-1,) + (1,) * (x.dim() - 1))

    return (
        gmap._replace(alive=gmap.alive & ~kill),
        adam._replace(mu=adam.mu.map(m), nu=adam.nu.map(m)),
    )


def add_densification_stats(gmap: GaussianMap, mean2d_grad: torch.Tensor,
                            update_filter: torch.Tensor) -> GaussianMap:
    """Add |d mean2d| (N, 2) of the Gaussians in `update_filter` to their
    densification statistics, and one to their count."""
    f = update_filter.to(torch.float32)
    return gmap._replace(grad_accum=gmap.grad_accum + torch.linalg.norm(mean2d_grad, dim=-1) * f,
                         denom=gmap.denom + f)


def update_max_radii(gmap: GaussianMap, radii: torch.Tensor,
                     visible: torch.Tensor) -> GaussianMap:
    """The largest screen radius seen so far, for the `visible` Gaussians."""
    return gmap._replace(max_radii2d=torch.where(
        visible, torch.maximum(gmap.max_radii2d, radii.to(torch.float32)), gmap.max_radii2d))


def reset_opacity(gmap: GaussianMap, adam: AdamState, value: float = 0.01):
    """Set all opacities to `value` and reset the opacity moments."""
    new_op = torch.full_like(gmap.params.opacity, inverse_sigmoid(value))
    adam = adam._replace(
        mu=adam.mu._replace(opacity=torch.zeros_like(adam.mu.opacity)),
        nu=adam.nu._replace(opacity=torch.zeros_like(adam.nu.opacity)),
    )
    return gmap._replace(params=gmap.params._replace(opacity=new_op)), adam


def reset_opacity_nonvisible(gmap: GaussianMap, adam: AdamState, visible: torch.Tensor):
    """Reset Gaussians not visible in the current window to opacity 0.4."""
    target = torch.full_like(gmap.params.opacity, inverse_sigmoid(0.4))
    new_op = torch.where(visible[:, None], gmap.params.opacity, target)
    nonvisf = (~visible).to(torch.float32)[:, None]
    adam = adam._replace(
        mu=adam.mu._replace(opacity=adam.mu.opacity * (1 - nonvisf)),
        nu=adam.nu._replace(opacity=adam.nu.opacity * (1 - nonvisf)),
    )
    return gmap._replace(params=gmap.params._replace(opacity=new_op)), adam


def densify_and_prune(
    gmap: GaussianMap,
    adam: AdamState,
    noise: tuple[torch.Tensor, torch.Tensor],
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float,
    percent_dense: float = 0.01,
):
    """Clone small high-gradient Gaussians, split large ones (2 samples,
    scale/1.6), prune transparent/oversized ones. `noise` holds the two
    (C, 3) standard-normal draws of the split samples."""
    p = gmap.params
    orig_alive = gmap.alive
    orig_max_radii = gmap.max_radii2d
    grads = torch.where(gmap.denom > 0, gmap.grad_accum / torch.clamp(gmap.denom, min=1.0),
                        torch.zeros_like(gmap.denom))
    scaling = torch.exp(p.scaling)
    max_scale = torch.max(scaling, dim=1).values
    hi_grad = (grads >= max_grad) & gmap.alive
    clone_sel = hi_grad & (max_scale <= percent_dense * extent)
    split_sel = hi_grad & (max_scale > percent_dense * extent)

    clones = NewGaussians(
        xyz=p.xyz, rgb=sh0_to_rgb(p.f_dc), scaling=p.scaling,
        rotation=p.rotation, opacity=p.opacity, valid=clone_sel,
    )
    gmap, adam, _ = insert_raw(gmap, adam, clones, gmap.kf_id, gmap.dygs)

    rot = quat_to_rotmat(quat_normalize(p.rotation))
    new_scaling = torch.log(scaling / (0.8 * 2.0))
    for i in range(2):
        offs = torch.einsum("nij,nj->ni", rot, noise[i] * scaling)
        samples = NewGaussians(
            xyz=p.xyz + offs, rgb=sh0_to_rgb(p.f_dc), scaling=new_scaling,
            rotation=p.rotation, opacity=p.opacity, valid=split_sel,
        )
        gmap, adam, _ = insert_raw(gmap, adam, samples, gmap.kf_id, gmap.dygs)

    # prune masks are evaluated against the PRE-insert population
    opacity = torch.sigmoid(p.opacity)[:, 0]
    kill = split_sel | (opacity < min_opacity)
    if max_screen_size > 0:
        kill = kill | (orig_max_radii > max_screen_size) | (max_scale > 0.1 * extent)
    gmap, adam = prune(gmap, adam, kill & orig_alive)
    gmap = gmap._replace(
        grad_accum=torch.zeros_like(gmap.grad_accum),
        denom=torch.zeros_like(gmap.denom),
        max_radii2d=torch.zeros_like(gmap.max_radii2d),
    )
    return gmap, adam


def candidates_from_rgbd(
    keep_u: torch.Tensor,    # (H*W,) uniform [0, 1) draws
    image: torch.Tensor,     # (3, H, W)
    depth: torch.Tensor,     # (H, W) — zeros where not to spawn
    T_cw: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    *,
    downsample: int,
    point_size: float = 0.01,
    adaptive_pointsize: bool = True,
    max_new: int = 16384,
    exposure_a: float = 0.0,
    exposure_b: float = 0.0,
) -> NewGaussians:
    """Back-project an RGB-D keyframe into Gaussian candidates: random
    pixel subsampling at rate 1/downsample (a pixel is kept where
    keep_u < 1/downsample), the first `max_new` kept pixels in raster
    order, 3-NN mean-squared-distance scale, opacity 0.5, identity
    rotation. Only selected pixels are returned (all valid)."""
    img = torch.clamp(math.exp(exposure_a) * image + exposure_b, 0.0, 1.0)
    pts = backproject_depth(depth, fx, fy, cx, cy, T_cw)
    rgb = img.reshape(3, -1).T
    sel = (depth > 0).reshape(-1) & (keep_u < (1.0 / downsample))
    idx = torch.nonzero(sel).squeeze(1)[:max_new]
    xyz = pts[idx]
    rgb = rgb[idx]

    if adaptive_pointsize:
        d = depth[depth > 0.1]
        med = torch.quantile(d, 0.5) if d.numel() else torch.tensor(float("nan"))
        psize = float(torch.clamp(med * point_size, max=0.05))
    else:
        psize = point_size
    d2 = torch.clamp(knn_mean_sq_dist(xyz, k=3) * psize, min=1e-7)
    n = xyz.shape[0]
    scaling = torch.log(torch.sqrt(d2))[:, None].expand(n, 3)
    rotation = torch.zeros((n, 4), device=xyz.device)
    rotation[:, 0] = 1.0
    opacity = torch.full((n, 1), inverse_sigmoid(0.5), device=xyz.device)
    return NewGaussians(
        xyz=xyz, rgb=rgb, scaling=scaling.contiguous(), rotation=rotation,
        opacity=opacity, valid=torch.ones(n, dtype=torch.bool, device=xyz.device),
    )
