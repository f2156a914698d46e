"""Camera tracking: pose-only optimization by differentiable rendering
(port of fourdgs/slam/tracking.py).

A Python loop of up to `max_iters` render + gradient + Adam steps on an
SE(3) delta (rot/trans) plus exposure a/b, retracted left-multiplicatively
each step with the Adam moments kept across steps, and the reference's
early exit (|tau| < converged_threshold after a step).

The loop keeps the reference's round structure: ceil(max_iters /
rebin_every) rounds, each binning the tiles once at its start and running
up to `rebin_every` iterations on those bins; a step larger than
`rebin_delta_threshold` ends the round early, so the next round re-bins.
A frame with fast motion can therefore take fewer than `max_iters` steps,
exactly as in the reference.

With `monocular` the loss is RGB only (`tracking_loss_rgb`); the median
depth of the result still comes from the final render.

Spans (utils/trace.py): `track_frame` (work: the iterations taken), with
a `bin` per round, a `track_iter` per iteration and the final
`track_render`. Sync sites: the learning rates' copy (`track.lr_h2d`),
each round's `bin.overflow` and `bin.num_pairs`, each iteration's
`track.step_norm` and `track.loss`, and the final render's
`track.render_overflow` and `track.render_pairs`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fourdgs_torch.geometry.se3 import se3_exp
from fourdgs_torch.models.gaussian_map import GaussianMap
from fourdgs_torch.ops.rasterize.api import RasterConfig, compute_bins, rasterize
from fourdgs_torch.slam.camera import Frame, Intrinsics
from fourdgs_torch.slam.losses import (
    apply_exposure,
    median_depth,
    tracking_loss_rgb,
    tracking_loss_rgbd,
)
from fourdgs_torch.utils.trace import span, sync


class TrackingConfig(NamedTuple):
    max_iters: int = 100
    monocular: bool = False
    lr_rot: float = 0.003
    lr_trans: float = 0.001
    lr_exposure: float = 0.01
    alpha: float = 0.9
    rgb_boundary_threshold: float = 0.01
    converged_threshold: float = 1e-4
    # tile binning is recomputed every `rebin_every` iterations: per-
    # iteration pose deltas move screen means far less than a tile
    rebin_every: int = 8
    # a step above this SE(3) norm ends the round, so the next one re-bins
    rebin_delta_threshold: float = 0.01
    raster: RasterConfig = RasterConfig()


class TrackResult(NamedTuple):
    T_cw: torch.Tensor          # (4, 4) refined pose
    exposure: torch.Tensor      # (2,) [a, b]
    n_iters: int
    final_loss: float
    median_depth: torch.Tensor
    visibility: torch.Tensor    # (C,) bool — n_touched > 0 at the final pose
    opacity: torch.Tensor       # (H, W) final rendered opacity
    depth: torch.Tensor         # (H, W) final rendered depth
    overflow: bool              # any render binned more than max_pairs pairs
    num_pairs: int              # max binned pairs seen this frame


def track_frame(
    gmap: GaussianMap,
    frame: Frame,
    T_init: torch.Tensor,
    exposure_init: torch.Tensor,
    intr: Intrinsics,
    config: TrackingConfig = TrackingConfig(),
    use_motion_mask: bool = True,
) -> TrackResult:
    """Optimize the frame pose against the static map."""
    with span("track_frame") as sp:
        res = _track(gmap, frame, T_init, exposure_init, intr, config, use_motion_mask)
        sp.work = res.n_iters
    return res


def _track(gmap, frame, T_init, exposure_init, intr, config, use_motion_mask) -> TrackResult:
    dev = T_init.device
    static_alive = gmap.alive & ~gmap.dygs
    with torch.no_grad():
        colors, scales = gmap.get_color, gmap.get_scaling
        quats, opac = gmap.get_rotation, gmap.get_opacity
    xyz = gmap.params.xyz
    proj = intr.proj(device=dev)
    bg = torch.zeros(3, device=dev)
    kw = intr.raster_kw()
    with sync("track.lr_h2d"):
        lr = torch.tensor([config.lr_trans] * 3 + [config.lr_rot] * 3
                          + [config.lr_exposure] * 2, device=dev)
    motion = frame.motion_mask if use_motion_mask else None

    def render_at(T_cw, bins=None):
        return rasterize(xyz, scales, quats, opac, colors, static_alive, T_cw, proj,
                         bg, config=config.raster, bins=bins, **kw)

    T_cw = T_init.clone()
    exp_ab = exposure_init.clone()
    mu = torch.zeros(8, device=dev)
    nu = torch.zeros(8, device=dev)
    count = 0
    converged = False
    loss_val = float("inf")
    ov_seen, pm_seen = False, 0
    rb = max(config.rebin_every, 1)
    n_rounds = -(-config.max_iters // rb)
    b1, b2, eps = 0.9, 0.999, 1e-8
    for _ in range(n_rounds):
        if count >= config.max_iters or converged:
            break
        bins = compute_bins(xyz, scales, quats, static_alive, T_cw, proj, opac,
                            config=config.raster, **kw)
        if not ov_seen:
            with sync("bin.overflow"):
                ov_seen = bool(bins.overflow.any())
        with sync("bin.num_pairs"):
            pm_seen = max(pm_seen, int(bins.num_pairs.max()))
        for _ in range(rb):
            if count >= config.max_iters or converged:
                break
            with span("track_iter"):
                # delta = [trans(3), rot(3), exposure_a, exposure_b] at [0, exp]
                delta = torch.cat([torch.zeros(6, device=dev), exp_ab]).requires_grad_(True)
                T = se3_exp(delta[:6]) @ T_cw
                out = render_at(T, bins)
                image_ab = apply_exposure(out.color, delta[6], delta[7])
                if config.monocular:
                    loss = tracking_loss_rgb(
                        image_ab, out.alpha, frame.image, frame.grad_mask, motion_mask=motion,
                        rgb_boundary_threshold=config.rgb_boundary_threshold,
                    )
                else:
                    loss = tracking_loss_rgbd(
                        image_ab, out.depth, out.alpha, frame.image, frame.depth,
                        frame.grad_mask, motion_mask=motion, alpha=config.alpha,
                        rgb_boundary_threshold=config.rgb_boundary_threshold,
                    )
                (g,) = torch.autograd.grad(loss, delta)
                with torch.no_grad():
                    count += 1
                    mu = b1 * mu + (1 - b1) * g
                    nu = b2 * nu + (1 - b2) * g * g
                    step = (lr * (mu / (1 - b1**count))
                            / (torch.sqrt(nu / (1 - b2**count)) + eps))
                    tau = -step[:6]
                    T_cw = se3_exp(tau) @ T_cw
                    exp_ab = exp_ab - step[6:8]
                    with sync("track.step_norm"):
                        tau_norm = float(torch.linalg.norm(tau))
                with sync("track.loss"):
                    loss_val = float(loss.detach())
            converged = tau_norm < config.converged_threshold
            if tau_norm > config.rebin_delta_threshold:
                break  # stale bins: the next round re-bins at the new pose

    with torch.no_grad(), span("track_render"):
        out = render_at(T_cw)
        med, _, _ = median_depth(out.depth, out.alpha)
        overflow = ov_seen
        if not overflow:
            with sync("track.render_overflow"):
                overflow = bool(out.overflow)
        with sync("track.render_pairs"):
            num_pairs = max(pm_seen, int(out.num_pairs))
    return TrackResult(
        T_cw=T_cw,
        exposure=exp_ab,
        n_iters=count,
        final_loss=loss_val,
        median_depth=med,
        visibility=out.n_touched > 0,
        opacity=out.alpha,
        depth=out.depth,
        overflow=overflow,
        num_pairs=num_pairs,
    )
