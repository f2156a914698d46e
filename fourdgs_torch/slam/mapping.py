"""Mapping backend: multi-view map optimization over the keyframe window
(port of fourdgs/slam/mapping.py).

One `map_chunk` call runs `num_iters` iterations: per iteration it renders
the window views plus 2 random replay keyframes in one multi-view render
(one launch of each compositor kernel), takes the mapping loss + 10x
isotropic scale regularizer, and applies Adam to the map parameters (gated
by the reference's `i > step_after` rule) and to the pose/exposure of the
first `pose_window` window views. Views marked invalid contribute nothing
to the loss or the statistics, so they are not rendered at all.

Window-view tile bins are recomputed every `rebin_every` iterations (the
reference's round structure); replay views are binned every iteration.
The densify / opacity-reset cadence runs on the host between chunks.

With `MappingConfig.refine` (colour refinement) every iteration's view
set is instead `num_views` distinct keyframes drawn from the whole pool
(`refine_picks`), binned afresh, under (1 - lambda) L1 + lambda (1 - SSIM)
+ 0.1 L1 depth, motion-masked; only the map parameters step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fourdgs_torch.geometry.quaternion import quat_normalize
from fourdgs_torch.geometry.se3 import se3_exp
from fourdgs_torch.geometry.sh import sh0_to_rgb
from fourdgs_torch.ops.image import ssim
from fourdgs_torch.models.gaussian_map import (
    AdamState,
    GaussianMap,
    MapLRs,
    adam_step,
    expon_lr,
)
from fourdgs_torch.ops.rasterize.api import (
    RasterConfig,
    compute_bins_multi,
    rasterize,
    rasterize_multi,
)
from fourdgs_torch.ops.rasterize.binning import cat_bins
from fourdgs_torch.slam.camera import Intrinsics
from fourdgs_torch.slam.keyframes import KeyframeStore, fetch_images
from fourdgs_torch.slam.losses import isotropic_loss, mapping_loss_rgbd


class MappingConfig(NamedTuple):
    num_window_views: int = 8     # key_opt slots (window[:3] + covisible picks)
    num_random_views: int = 2     # random replay keyframes per iteration
    pose_window: int = 3
    alpha: float = 0.9
    rgb_boundary_threshold: float = 0.01
    lr_rot: float = 0.0015        # 0.5 x tracking LRs
    lr_trans: float = 0.0005
    lr_exposure: float = 0.01
    isotropic_weight: float = 10.0
    refine: bool = False          # colour-refinement objective and view draws
    rm_dynamic: bool = True       # mask dynamic pixels out of the loss
    raster: RasterConfig = RasterConfig()
    lrs: MapLRs = MapLRs()
    # xyz LR multiplier decays 1 -> xyz_lr_ratio over xyz_lr_max_steps
    # global iterations
    xyz_lr_ratio: float = 0.01
    xyz_lr_max_steps: int = 30000
    # window-view binning is recomputed every `rebin_every` iterations
    rebin_every: int = 4

    @property
    def num_views(self) -> int:
        return self.num_window_views + self.num_random_views


def refine_picks(u: np.ndarray, rand_pool: np.ndarray, rand_pool_size: int, nv: int):
    """`nv` distinct keyframes drawn uniformly from the valid pool entries:
    the stable argsort of uniform draws `u` (one per pool entry), invalid
    entries keyed at +inf. Returns (slots (nv,), valids (nv,))."""
    m = rand_pool.shape[0]
    u = np.where(np.arange(m) < rand_pool_size, u, np.inf)
    order = np.argsort(u, kind="stable")
    take = min(nv, m)
    slots = np.zeros(nv, rand_pool.dtype)
    slots[:take] = rand_pool[order[:take]]
    valids = np.arange(nv) < min(rand_pool_size, take)
    return slots, valids


class PoseAdam(NamedTuple):
    mu: torch.Tensor  # (Vw, 8) [trans(3), rot(3), exposure(2)]
    nu: torch.Tensor  # (Vw, 8)
    count: int


def init_pose_adam(num_views: int, device: torch.device | str) -> PoseAdam:
    z = torch.zeros((num_views, 8), device=device)
    return PoseAdam(mu=z, nu=z, count=0)


class MapChunkResult(NamedTuple):
    gmap: GaussianMap
    adam: AdamState
    store: KeyframeStore
    pose_adam: PoseAdam
    final_loss: float
    overflow: bool   # any render binned more than max_pairs pairs
    num_pairs: int   # max pairs per view seen in the chunk


def _activated(params):
    return (params.xyz, torch.exp(params.scaling), quat_normalize(params.rotation),
            torch.sigmoid(params.opacity)[:, 0], sh0_to_rgb(params.f_dc))


def _views_bins(gmap: GaussianMap, store: KeyframeStore, slots, proj,
                intr: Intrinsics, cfg: MappingConfig):
    """Forward-only binning of the views at store slots `slots`."""
    with torch.no_grad():
        xyz, scales, quats, opac, _ = _activated(gmap.params)
        return compute_bins_multi(xyz, scales, quats, gmap.alive, store.T_cw[slots],
                                  proj, opac, config=cfg.raster, **intr.raster_kw())


LAMBDA_DSSIM = 0.2   # the SSIM share of the colour-refinement loss


def refine_loss(images_ab, images_gt, depth, depth_gt, motion):
    """(V,) colour-refinement losses: (1 - lambda) L1 + lambda (1 - SSIM)
    + 0.1 L1 depth, each over the static pixels."""
    mf = motion.to(torch.float32)[:, None]
    l1 = torch.mean(torch.abs((images_ab - images_gt) * mf), dim=(1, 2, 3))
    dmask = ((depth_gt > 0.01) & motion).to(torch.float32)
    l1d = torch.mean(torch.abs((depth - depth_gt) * dmask), dim=(1, 2))
    return ((1 - LAMBDA_DSSIM) * l1 + LAMBDA_DSSIM * (1.0 - ssim(images_ab * mf, images_gt * mf))
            + 0.1 * l1d)


def map_chunk(
    gmap: GaussianMap,
    adam: AdamState,
    store: KeyframeStore,
    window_slots: np.ndarray,   # (Vw,) int store slots (key_opt order)
    window_valid: np.ndarray,   # (Vw,) bool
    opt_pose: np.ndarray,       # (Vw,) bool — optimize pose of this view
    rand_pool: np.ndarray,      # (R,) int candidate slots for replay
    rand_pool_size: int,
    pose_adam: PoseAdam,
    picks: np.ndarray,          # (num_iters, 2) raw replay draws; refine: (num_iters, R) uniform
    num_iters: int,
    step_after: int,            # map params step when i > step_after
    iter_base: int,             # global iteration_count at chunk start
    intr: Intrinsics,
    cfg: MappingConfig = MappingConfig(),
) -> MapChunkResult:
    dev = gmap.alive.device
    proj = intr.proj(device=dev)
    kw = intr.raster_kw()
    vw, vr = cfg.num_window_views, cfg.num_random_views
    window_slots = np.asarray(window_slots)
    window_valid = np.asarray(window_valid, bool)
    w_act = np.nonzero(window_valid)[0]          # rendered window views
    w_slots = torch.as_tensor(window_slots[w_act], device=dev, dtype=torch.long)
    uid_ok = (store.uids[torch.as_tensor(window_slots, device=dev, dtype=torch.long)]
              .cpu().numpy() != 0) & window_valid
    mask8 = torch.as_tensor(
        np.concatenate([np.repeat((opt_pose & uid_ok)[:, None], 6, 1),
                        np.repeat(uid_ok[:, None], 2, 1)], 1),
        dtype=torch.float32, device=dev,
    )
    pose_lr = torch.tensor([cfg.lr_trans] * 3 + [cfg.lr_rot] * 3 + [cfg.lr_exposure] * 2,
                           device=dev)
    size = max(rand_pool_size, 1)
    rand_valid = np.arange(vr) < min(rand_pool_size, vr)
    loss_val = torch.tensor(float("inf"))
    ov_seen, pm_seen = False, 0
    rb = max(cfg.rebin_every, 1)
    b1, b2, eps = 0.9, 0.999, 1e-8

    for i in range(num_iters):
        if cfg.refine:
            # the whole view set: distinct keyframes from the full pool
            r_slots, r_valid = refine_picks(picks[i], rand_pool, rand_pool_size,
                                            cfg.num_views)
            slots = torch.as_tensor(r_slots[r_valid], device=dev, dtype=torch.long)
            bins = _views_bins(gmap, store, slots, proj, intr, cfg)
        else:
            if i % rb == 0:
                bins_w = _views_bins(gmap, store, w_slots, proj, intr, cfg)
            # distinct replay picks from the host pool
            r1, r2 = int(picks[i, 0]), int(picks[i, 1])
            r2 = (r2 + 1 if r2 >= r1 else r2) % size
            r_slots = np.asarray([rand_pool[r1], rand_pool[r2]][:vr])[rand_valid]
            slots = torch.as_tensor(np.concatenate([window_slots[w_act], r_slots]),
                                    device=dev, dtype=torch.long)
            bins = bins_w
            if r_slots.size:
                bins = cat_bins(bins_w, _views_bins(gmap, store, slots[len(w_act):],
                                                    proj, intr, cfg))
        ov_seen = ov_seen or bool(bins.overflow.any())
        pm_seen = max(pm_seen, int(bins.num_pairs.max()))

        nv = slots.shape[0]
        params = gmap.params.map(lambda x: x.detach().requires_grad_(True))
        dtaus = torch.zeros((nv, 6), device=dev, requires_grad=True)
        dexps = torch.zeros((nv, 2), device=dev, requires_grad=True)
        taps = torch.zeros((nv, gmap.capacity, 2), device=dev, requires_grad=True)
        T_vs = se3_exp(dtaus) @ store.T_cw[slots]
        exp_abs = store.exposure[slots] + dexps
        out = rasterize_multi(*_activated(params), gmap.alive, T_vs, proj,
                              torch.zeros(3, device=dev), mean2d_offsets=taps,
                              config=cfg.raster, bins=bins, **kw)
        images_ab = (torch.exp(exp_abs[:, 0])[:, None, None, None] * out.color
                     + exp_abs[:, 1][:, None, None, None])
        if cfg.refine:
            per_view = refine_loss(images_ab, fetch_images(store, slots), out.depth,
                                   store.depths[slots], store.motion[slots])
        else:
            per_view = mapping_loss_rgbd(
                images_ab, out.depth, fetch_images(store, slots), store.depths[slots],
                motion_mask=store.motion[slots], alpha=cfg.alpha,
                rgb_boundary_threshold=cfg.rgb_boundary_threshold,
                rm_dynamic=cfg.rm_dynamic,
            )
        iso = cfg.isotropic_weight * isotropic_loss(torch.exp(params.scaling), gmap.alive)
        loss = torch.sum(per_view) + iso
        grads = torch.autograd.grad(loss, list(params) + [dtaus, dexps, taps])
        g_params = type(gmap.params)(*grads[:5])
        g_taus, g_exps, g_taps = grads[5:]

        with torch.no_grad():
            loss_val = loss.detach()
            # densification stats (radii > 0 on the rendered views)
            upd = (out.radii > 0).to(torch.float32)
            norms = torch.linalg.norm(g_taps, dim=-1)
            gmap = gmap._replace(
                grad_accum=gmap.grad_accum + torch.sum(norms * upd, dim=0),
                denom=gmap.denom + torch.sum(upd, dim=0),
            )
            if i > step_after:
                adv = max(0, i - max(step_after + 1, 0))
                mult = expon_lr(float(iter_base + adv), 1.0, cfg.xyz_lr_ratio,
                                max_steps=cfg.xyz_lr_max_steps)
                p2, adam = adam_step(gmap.params, g_params, adam, cfg.lrs,
                                     gmap.alive, xyz_lr_mult=mult)
                gmap = gmap._replace(params=p2)
            if cfg.refine:
                continue

            # pose + exposure step of the window views
            gp = torch.zeros((vw, 8), device=dev)
            act = torch.as_tensor(w_act, device=dev, dtype=torch.long)
            gp[act] = torch.cat([g_taus[:len(w_act)], g_exps[:len(w_act)]], dim=1)
            gp = gp * mask8
            count = pose_adam.count + 1
            mu = b1 * pose_adam.mu + (1 - b1) * gp
            nu = b2 * pose_adam.nu + (1 - b2) * gp * gp
            step = pose_lr[None] * (mu / (1 - b1**count)) / (
                torch.sqrt(nu / (1 - b2**count)) + eps)
            upd8 = (-step * mask8)[act]
            store.T_cw[w_slots] = se3_exp(upd8[:, :6]) @ store.T_cw[w_slots]
            store.exposure[w_slots] = store.exposure[w_slots] + upd8[:, 6:8]
            pose_adam = PoseAdam(mu=mu, nu=nu, count=count)

    return MapChunkResult(
        gmap=gmap, adam=adam, store=store, pose_adam=pose_adam,
        final_loss=float(loss_val), overflow=ov_seen, num_pairs=pm_seen,
    )


def window_visibility(gmap: GaussianMap, store: KeyframeStore, window_slots,
                      window_valid, intr: Intrinsics, cfg: MappingConfig = MappingConfig()):
    """(Vw, capacity) bool — n_touched > 0 per window view at current
    poses; False on invalid views."""
    dev = gmap.alive.device
    window_valid = np.asarray(window_valid, bool)
    vis = torch.zeros((len(window_valid), gmap.capacity), dtype=torch.bool, device=dev)
    act = np.nonzero(window_valid)[0]
    if act.size:
        with torch.no_grad():
            slots = torch.as_tensor(np.asarray(window_slots)[act], device=dev, dtype=torch.long)
            out = rasterize_multi(*_activated(gmap.params), gmap.alive, store.T_cw[slots],
                                  intr.proj(device=dev), torch.zeros(3, device=dev),
                                  config=cfg.raster, **intr.raster_kw())
            vis[torch.as_tensor(act, device=dev)] = out.n_touched > 0
    return vis


def render_keyframe(gmap: GaussianMap, T_cw: torch.Tensor, intr: Intrinsics,
                    cfg: MappingConfig = MappingConfig()):
    """Render the map at pose T_cw (a stored keyframe's, or a tracked
    one)."""
    with torch.no_grad():
        return rasterize(*_activated(gmap.params), gmap.alive, T_cw,
                         intr.proj(device=T_cw.device), torch.zeros(3, device=T_cw.device),
                         config=cfg.raster, **intr.raster_kw())
