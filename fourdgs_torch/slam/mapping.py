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
With a mesh (`parallel.Mesh`) each iteration's views are split over its
ranks, whose gradients are summed; the chunk's loop is the same on one
device, run as a group of one rank.
The densify / opacity-reset cadence runs on the host between chunks.

With `MappingConfig.monocular` the loss is RGB only (`mapping_loss_rgb`).
`extra_masks` (the `rm_initdy` reprojection masks, one per window view)
are ANDed into the RGB-D loss's pixel masks of the window views; the
replay views take none.

With `MappingConfig.refine` (colour refinement) every iteration's view
set is instead `num_views` distinct keyframes drawn from the whole pool
(`refine_picks`), binned afresh, under (1 - lambda) L1 + lambda (1 - SSIM)
+ 0.1 L1 depth, motion-masked; only the map parameters step.

Spans (utils/trace.py): `map_chunk` (work: the iterations), with one
`map_iter` per iteration. Sync sites: the pose mask's reads
(`map.pose_mask`), the learning rates' and the window's copies
(`map.lr_h2d`, `map.window_h2d`), each iteration's view slots and ids
(`map.slots_h2d`, `map.ids_h2d`; `map.masks_h2d` with extra masks), and
at the end the loss (`map.loss`) and the overflow and pair count
(`map.seen`).
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
from fourdgs_torch.parallel.comm import Comm
from fourdgs_torch.slam.camera import Intrinsics
from fourdgs_torch.slam.keyframes import KeyframeStore, fetch_images
from fourdgs_torch.slam.losses import isotropic_loss, mapping_loss_rgb, mapping_loss_rgbd
from fourdgs_torch.utils.trace import span, sync


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
    monocular: bool = False       # RGB-only loss
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


def _view_losses(params, gmap: GaussianMap, store: KeyframeStore, slots: torch.Tensor,
                 ems, proj, intr: Intrinsics, cfg: MappingConfig, bins=None):
    """One batched render of the views at store slots `slots` and their
    per-view losses, with the leaves the gradients are taken at: returns
    (per-view losses, render outputs, dtaus (V, 6), dexps (V, 2), taps
    (V, capacity, 2)). `ems`: (V, H, W) bool extra masks or None; `bins`
    None bins afresh."""
    dev = gmap.alive.device
    nv = slots.shape[0]
    dtaus = torch.zeros((nv, 6), device=dev, requires_grad=True)
    dexps = torch.zeros((nv, 2), device=dev, requires_grad=True)
    taps = torch.zeros((nv, gmap.capacity, 2), device=dev, requires_grad=True)
    T_vs = se3_exp(dtaus) @ store.T_cw[slots]
    exp_abs = store.exposure[slots] + dexps
    out = rasterize_multi(*_activated(params), gmap.alive, T_vs, proj,
                          torch.zeros(3, device=dev), mean2d_offsets=taps,
                          config=cfg.raster, bins=bins, **intr.raster_kw())
    images_ab = (torch.exp(exp_abs[:, 0])[:, None, None, None] * out.color
                 + exp_abs[:, 1][:, None, None, None])
    if cfg.refine:
        per_view = refine_loss(images_ab, fetch_images(store, slots), out.depth,
                               store.depths[slots], store.motion[slots])
    elif cfg.monocular:
        per_view = mapping_loss_rgb(images_ab, fetch_images(store, slots),
                                    rgb_boundary_threshold=cfg.rgb_boundary_threshold)
    else:
        per_view = mapping_loss_rgbd(
            images_ab, out.depth, fetch_images(store, slots), store.depths[slots],
            motion_mask=store.motion[slots], alpha=cfg.alpha,
            rgb_boundary_threshold=cfg.rgb_boundary_threshold,
            rm_dynamic=cfg.rm_dynamic, extra_mask=ems,
        )
    return per_view, out, dtaus, dexps, taps


def _map_step(gmap: GaussianMap, adam: AdamState, g_params, i: int, step_after: int,
              iter_base: int, cfg: MappingConfig):
    """The map parameters' Adam step of iteration i, gated by i >
    step_after, at the xyz learning rate of the global iteration count."""
    if i <= step_after:
        return gmap, adam
    adv = max(0, i - max(step_after + 1, 0))
    mult = expon_lr(float(iter_base + adv), 1.0, cfg.xyz_lr_ratio,
                    max_steps=cfg.xyz_lr_max_steps)
    p2, adam = adam_step(gmap.params, g_params, adam, cfg.lrs, gmap.alive, xyz_lr_mult=mult)
    return gmap._replace(params=p2), adam


def _pose_step(pose_adam: PoseAdam, gp: torch.Tensor, mask8: torch.Tensor,
               pose_lr: torch.Tensor, store: KeyframeStore, act: torch.Tensor,
               slots: torch.Tensor) -> PoseAdam:
    """The pose and exposure Adam step of the window views from their
    (Vw, 8) gradients [trans, rot, exposure]; the views `act` (at store
    `slots`) move, in place in `store`."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    gp = gp * mask8
    count = pose_adam.count + 1
    mu = b1 * pose_adam.mu + (1 - b1) * gp
    nu = b2 * pose_adam.nu + (1 - b2) * gp * gp
    step = pose_lr[None] * (mu / (1 - b1**count)) / (torch.sqrt(nu / (1 - b2**count)) + eps)
    upd8 = (-step * mask8)[act]
    store.T_cw[slots] = se3_exp(upd8[:, :6]) @ store.T_cw[slots]
    store.exposure[slots] = store.exposure[slots] + upd8[:, 6:8]
    return PoseAdam(mu=mu, nu=nu, count=count)


def _pose_mask(store: KeyframeStore, window_slots: np.ndarray, window_valid: np.ndarray,
               opt_pose: np.ndarray, dev) -> torch.Tensor:
    """The (Vw, 8) step mask of the window views' [trans, rot, exposure]:
    pose rows for valid views with uid != 0 and opt_pose, exposure rows for
    valid views with uid != 0."""
    with sync("map.pose_mask", 3):   # the slots' copy, the uids' read, the mask's copy
        uid_ok = (store.uids[torch.as_tensor(window_slots, device=dev, dtype=torch.long)]
                  .cpu().numpy() != 0) & window_valid
        return torch.as_tensor(
            np.concatenate([np.repeat((opt_pose & uid_ok)[:, None], 6, 1),
                            np.repeat(uid_ok[:, None], 2, 1)], 1),
            dtype=torch.float32, device=dev,
        )


def _pose_lr(cfg: MappingConfig, dev) -> torch.Tensor:
    """(8,) learning rates of a window view's [trans, rot, exposure]."""
    with sync("map.lr_h2d"):
        return torch.tensor([cfg.lr_trans] * 3 + [cfg.lr_rot] * 3 + [cfg.lr_exposure] * 2,
                            device=dev)


def _replay_slots(picks_i, rand_pool: np.ndarray, size: int, vr: int) -> np.ndarray:
    """The iteration's replay slots from its raw draws, made distinct."""
    r1, r2 = int(picks_i[0]), int(picks_i[1])
    r2 = (r2 + 1 if r2 >= r1 else r2) % size
    return np.asarray([rand_pool[r1], rand_pool[r2]][:vr])


def _plan_views(window_slots: np.ndarray, window_valid: np.ndarray, rand_pool: np.ndarray,
                rand_pool_size: int, picks, num_iters: int, cfg: MappingConfig):
    """Every iteration's view set as (num_iters, nv) store slots and
    validity: [window views | distinct replay picks], or in refine mode
    the `refine_picks` of the whole pool."""
    vw, vr, nv = cfg.num_window_views, cfg.num_random_views, cfg.num_views
    slots = np.zeros((num_iters, nv), np.int64)
    valid = np.zeros((num_iters, nv), bool)
    size = max(rand_pool_size, 1)
    for i in range(num_iters):
        if cfg.refine:
            slots[i], valid[i] = refine_picks(picks[i], rand_pool, rand_pool_size, nv)
        else:
            slots[i, :vw], valid[i, :vw] = window_slots, window_valid
            slots[i, vw:] = _replay_slots(picks[i], rand_pool, size, vr)
            valid[i, vw:] = np.arange(vr) < min(rand_pool_size, vr)
    return slots, valid


def _compact_store(store: KeyframeStore, slots: np.ndarray):
    """The store's slots `slots` (any order, repeats allowed) as a store
    of their own, which is what a mesh rank is sent. Returns (that store,
    the used slots sorted, as a tensor; `local`, a map from a slot of
    `store` to its index in the new one)."""
    used = np.unique(slots)
    local = np.zeros(max(int(used.max(initial=0)) + 1, 1), np.int64)
    local[used] = np.arange(used.size)
    idx = torch.as_tensor(used, device=store.valid.device, dtype=torch.long)
    return KeyframeStore(*(x[idx] for x in store)), idx, local


def rank_block(ids: np.ndarray, rank: int, size: int) -> np.ndarray:
    """Rank `rank`'s contiguous block of the valid view ids `ids`, padded
    with invalid views to a multiple of `size`. The reference pads the
    whole view set instead, so that a rank whose block holds only invalid
    views renders nothing; here every rank renders while there are as
    many valid views as ranks. The gradients' sum is the same."""
    block = -(-ids.size // size)
    return ids[rank * block:(rank + 1) * block]


def _cat_some(*bins):
    """`cat_bins` of those of `bins` that are not None."""
    out = None
    for b in bins:
        if b is not None:
            out = b if out is None else cat_bins(out, b)
    return out


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
    extra_masks: torch.Tensor | None = None,   # (Vw, H, W) bool reprojection masks
    mesh=None,                  # a parallel.Mesh: the views sharded over its ranks
) -> MapChunkResult:
    """The chunk runs as `_map_chunk_rank`: on one device as a group of one
    rank, or with `mesh` on each of its ranks, each iteration's valid
    views split in contiguous blocks over them (`rank_block`). A rank is
    sent the chunk's keyframes once (`_compact_store`); on a mesh every
    view is binned afresh every iteration, as the reference's mesh
    branch does."""
    with span("map_chunk", num_iters):
        window_slots = np.asarray(window_slots)
        window_valid = np.asarray(window_valid, bool)
        dev = store.valid.device
        slots_all, valid_all = _plan_views(window_slots, window_valid, np.asarray(rand_pool),
                                           rand_pool_size, picks, num_iters, cfg)
        mask8 = _pose_mask(store, window_slots, window_valid, np.asarray(opt_pose, bool), dev)
        if mesh is None:
            res = _map_chunk_rank(Comm.local(dev), gmap, adam, store, window_slots, window_valid,
                                  mask8, slots_all, valid_all, pose_adam, num_iters, step_after,
                                  iter_base, intr, cfg, extra_masks, max(cfg.rebin_every, 1))
        else:
            sent, idx, local = _compact_store(store, np.concatenate(
                [slots_all[valid_all], window_slots[window_valid]]))
            res = mesh.run(_map_chunk_rank, gmap, adam, sent,
                           np.where(window_valid, local[window_slots * window_valid], 0),
                           window_valid, mask8,
                           np.where(valid_all, local[slots_all * valid_all], 0), valid_all,
                           pose_adam, num_iters, step_after, iter_base, intr, cfg,
                           extra_masks, 1)
            store.T_cw[idx] = res.T_cw
            store.exposure[idx] = res.exposure
        return MapChunkResult(gmap=res.gmap, adam=res.adam, store=store, pose_adam=res.pose_adam,
                              final_loss=res.final_loss, overflow=res.overflow,
                              num_pairs=res.num_pairs)


class _RankResult(NamedTuple):
    """What every rank holds after `_map_chunk_rank`, bit for bit alike."""
    gmap: GaussianMap
    adam: AdamState
    pose_adam: PoseAdam
    T_cw: torch.Tensor       # the rank's store's poses and exposures
    exposure: torch.Tensor
    final_loss: float
    overflow: bool
    num_pairs: int


def _map_chunk_rank(comm, gmap: GaussianMap, adam: AdamState, store: KeyframeStore,
                    window_slots: np.ndarray, window_valid: np.ndarray, mask8: torch.Tensor,
                    slots_all: np.ndarray, valid_all: np.ndarray, pose_adam: PoseAdam,
                    num_iters: int, step_after: int, iter_base: int, intr: Intrinsics,
                    cfg: MappingConfig, extra_masks, rebin_every: int) -> _RankResult:
    """One rank of `map_chunk`, every rank alike: per iteration, render and
    differentiate this rank's block of the valid views (`rank_block`),
    rank 0 adding the isotropic term once; `psum` the loss, the map's
    gradients, the per-view pose and exposure gradients and the
    densification statistics; then every rank takes the same steps from the
    same sums. The overflow and pair count are `pmax`'d once, at the end.
    The bins of the rank's window views are made every `rebin_every`
    iterations (its block of them holds for the chunk), the others' every
    iteration. `slots_all` and `window_slots` index `store`."""
    dev = comm.device
    proj = intr.proj(device=dev)
    vw = cfg.num_window_views
    nv = slots_all.shape[1]
    fixed = 0 if cfg.refine else vw     # the leading views whose bins are reused
    w_act = np.nonzero(window_valid)[0]
    with sync("map.window_h2d", 2):
        act = torch.as_tensor(w_act, device=dev, dtype=torch.long)
        w_slots = torch.as_tensor(window_slots[w_act], device=dev, dtype=torch.long)
    pose_lr = _pose_lr(cfg, dev)
    cap = gmap.capacity
    sizes = [p.numel() for p in gmap.params]
    n_p = sum(sizes)
    loss_val = torch.tensor(float("inf"))
    seen = torch.zeros(2, dtype=torch.long, device=dev)   # overflow, most pairs of a view
    for i in range(num_iters):
        with span("map_iter"):
            ids = rank_block(np.nonzero(valid_all[i])[0], comm.rank, comm.size)
            n_fix = int((ids < fixed).sum())
            with sync("map.slots_h2d"):
                slots = torch.as_tensor(slots_all[i, ids], device=dev, dtype=torch.long)
            if i % rebin_every == 0:
                bins_w = (_views_bins(gmap, store, slots[:n_fix], proj, intr, cfg) if n_fix
                          else None)
            params = gmap.params.map(lambda x: x.detach().requires_grad_(True))
            pack = torch.zeros(1 + n_p + nv * 8 + 2 * cap, device=dev)
            loss = torch.zeros((), device=dev)
            leaves = list(params)
            if ids.size:
                bins = _cat_some(bins_w, _views_bins(gmap, store, slots[n_fix:], proj, intr, cfg)
                                if ids.size > n_fix else None)
                seen = torch.maximum(seen, torch.stack([bins.overflow.any().long(),
                                                        bins.num_pairs.max().long()]))
                ems = None
                if extra_masks is not None:
                    ems = torch.ones((ids.size,) + extra_masks.shape[1:], dtype=torch.bool,
                                     device=dev)
                    win = ids < vw
                    with sync("map.masks_h2d", 2):
                        ems[torch.as_tensor(np.nonzero(win)[0], device=dev)] = extra_masks[
                            torch.as_tensor(ids[win], device=dev)]
                per_view, out, dtaus, dexps, taps = _view_losses(params, gmap, store, slots, ems,
                                                                  proj, intr, cfg, bins)
                loss = torch.sum(per_view)
                leaves += [dtaus, dexps, taps]
            if comm.rank == 0:
                loss = loss + cfg.isotropic_weight * isotropic_loss(torch.exp(params.scaling),
                                                                    gmap.alive)
            if loss.requires_grad:
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            else:
                grads = [torch.zeros_like(x) for x in leaves]
            with torch.no_grad():
                pack[0] = loss
                pack[1:1 + n_p] = torch.cat([g.reshape(-1) for g in grads[:5]])
                if ids.size:
                    g_taus, g_exps, g_taps = grads[5:]
                    g8 = pack[1 + n_p:1 + n_p + nv * 8].view(nv, 8)
                    with sync("map.ids_h2d"):
                        g8_rows = torch.as_tensor(ids, device=dev)
                    g8[g8_rows] = torch.cat([g_taus, g_exps], dim=1)
                    upd = (out.radii > 0).to(torch.float32)
                    norms = torch.linalg.norm(g_taps, dim=-1)
                    pack[-2 * cap:-cap] = torch.sum(norms * upd, dim=0)
                    pack[-cap:] = torch.sum(upd, dim=0)
                pack = comm.psum(pack)
                loss_val = pack[0]
                g_params = type(gmap.params)(*(g.view_as(p) for g, p in zip(
                    torch.split(pack[1:1 + n_p], sizes), gmap.params)))
                gmap = gmap._replace(grad_accum=gmap.grad_accum + pack[-2 * cap:-cap],
                                     denom=gmap.denom + pack[-cap:])
                gmap, adam = _map_step(gmap, adam, g_params, i, step_after, iter_base, cfg)
                if cfg.refine:
                    continue
                gp = torch.zeros((vw, 8), device=dev)
                gp[act] = pack[1 + n_p:1 + n_p + vw * 8].view(vw, 8)[act]
                pose_adam = _pose_step(pose_adam, gp, mask8, pose_lr, store, act, w_slots)
    seen = comm.pmax(seen)
    with sync("map.loss"):
        final_loss = float(loss_val)
    with sync("map.seen", 2):
        overflow, num_pairs = bool(seen[0]), int(seen[1])
    return _RankResult(gmap=gmap, adam=adam, pose_adam=pose_adam, T_cw=store.T_cw,
                       exposure=store.exposure, final_loss=final_loss,
                       overflow=overflow, num_pairs=num_pairs)


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
            with sync("map.visibility_h2d", 2):
                slots = torch.as_tensor(np.asarray(window_slots)[act], device=dev,
                                        dtype=torch.long)
                act_t = torch.as_tensor(act, device=dev)
            out = rasterize_multi(*_activated(gmap.params), gmap.alive, store.T_cw[slots],
                                  intr.proj(device=dev), torch.zeros(3, device=dev),
                                  config=cfg.raster, **intr.raster_kw())
            vis[act_t] = out.n_touched > 0
    return vis


def render_keyframe(gmap: GaussianMap, T_cw: torch.Tensor, intr: Intrinsics,
                    cfg: MappingConfig = MappingConfig()):
    """Render the map at pose T_cw (a stored keyframe's, or a tracked
    one)."""
    with torch.no_grad():
        return rasterize(*_activated(gmap.params), gmap.alive, T_cw,
                         intr.proj(device=T_cw.device), torch.zeros(3, device=T_cw.device),
                         config=cfg.raster, **intr.raster_kw())
