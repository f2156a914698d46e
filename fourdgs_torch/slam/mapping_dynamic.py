"""4D mapping: deformation-aware map optimization with flow supervision
(port of fourdgs/slam/mapping_dynamic.py, single device).

Extends the static `map_chunk` with the deformation field:

  - each main view (window and replay keyframe) renders the map with its
    dynamic Gaussians deformed by the control-node warp at the view's time,
  - each window view with an earlier keyframe adds two flow renders, at
    the view's camera and time and at the pair's, whose colour channels
    carry the signed NDC scene flow between the two and the dygs flag;
    an L1 to the precomputed optical flow on dynamic pixels, weighted by
    `flow_weight` in the first half of the chunk and `flow_weight_fine` in
    the second (`phase_weights`), where the dynamic pixels of the mapping
    loss also count twice; the payload is projected through a constant
    view camera (`_payload_camera`, a departure from the reference),
  - ARAP and elastic regularizers of the field at each main view's time,
    1e-3 on window views and 1e-4 on replay views,
  - an Adam of its own for the field (lr 8e-4, eps 1e-15).

All renders of an iteration are one `rasterize_multi`, so one launch of
each compositor kernel: [main views | flow views at the view camera | flow
views at the pair camera], each with its own deformed geometry, camera
and payload. Views that add nothing to the loss are not rendered (invalid
window views, and flow views of a window view without an earlier
keyframe), so the number of views varies with the window. All MLP
evaluations of an iteration (the warp's view and pair times, the
regularizers' time samples) are one batched call, and the KNN of the
Gaussians to the nodes, which does not depend on time, is taken once per
iteration. Window and flow views are re-binned every `rebin_every`
iterations at that iteration's geometry, replay views every iteration.

`warmup_network` is the deformation warmup on the keyframe that starts
the dynamic phase: network loss, map and field steps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fourdgs_torch.geometry.se3 import se3_exp
from fourdgs_torch.models import deform as D
from fourdgs_torch.models.gaussian_map import AdamState, GaussianMap, adam_step, expon_lr
from fourdgs_torch.ops.rasterize.api import (
    compute_bins_multi,
    flow_payload,
    rasterize,
    rasterize_multi,
)
from fourdgs_torch.ops.rasterize.binning import cat_bins
from fourdgs_torch.slam.camera import Intrinsics
from fourdgs_torch.slam.keyframes import KeyframeStore, fetch_images
from fourdgs_torch.slam.losses import (
    isotropic_loss,
    mapping_loss_rgbd,
    masked_flow_l1,
    network_loss_rgbd,
)
from fourdgs_torch.slam.mapping import MappingConfig, PoseAdam, _activated

DEFORM_LR = 8e-4     # position_lr_init x spatial_lr_scale (5)
REG_WINDOW, REG_REPLAY = 1e-3, 1e-4


class DeformAdam(NamedTuple):
    mu: D.ControlNodeFloats
    nu: D.ControlNodeFloats
    count: int


def init_deform_adam(cn: D.ControlNodes) -> DeformAdam:
    like = D.cn_floats(cn)
    z = D.from_leaves([torch.zeros_like(t) for t in D.leaves(like)], like)
    return DeformAdam(mu=z, nu=z, count=0)


def _adam_flat(p, g, mu, nu, count: int, lr: float = DEFORM_LR, b1=0.9, b2=0.999,
               eps=1e-15):
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    step = lr * (mu / (1 - b1**count)) / (torch.sqrt(nu / (1 - b2**count)) + eps)
    return p - step, mu, nu


def deform_adam_step(cn_f: D.ControlNodeFloats, grads: D.ControlNodeFloats,
                     state: DeformAdam, lr: float = DEFORM_LR, b1=0.9, b2=0.999,
                     eps=1e-15):
    """One Adam step of the field's parameters. Returns (parameters,
    state)."""
    count = state.count + 1
    p, mu, nu = _adam_flat(D.flatten(cn_f), D.flatten(grads), D.flatten(state.mu),
                           D.flatten(state.nu), count, lr, b1, b2, eps)
    return D.unflatten(p, cn_f), DeformAdam(D.unflatten(mu, cn_f), D.unflatten(nu, cn_f),
                                            count)


def phase_weights(i: int, num_iters: int, flow_weight: float,
                  flow_weight_fine: float | None):
    """The phase switch of a mapping chunk: iterations i < num_iters / 2
    run with the dynamic up-weighting and `flow_weight`, the rest without
    it and with `flow_weight_fine` (`flow_weight` when None). Returns
    (dynamic, flow weight)."""
    dynamic = i * 2 < num_iters
    fine = flow_weight if flow_weight_fine is None else flow_weight_fine
    return dynamic, (flow_weight if dynamic else fine)


def _deformed_render(gmap: GaussianMap, cn: D.ControlNodes, T_cw, t, proj,
                     intr: Intrinsics, cfg: MappingConfig):
    """One render of the map with its dynamic Gaussians deformed to time
    t. Returns (outputs, (d_xyz, d_rot, d_scale))."""
    d = D.warp(cn, gmap.params.xyz.detach(), t, motion_mask=gmap.dygs)
    xyz, scales, quats, opac, rgb = _activated(gmap.params)
    out = rasterize(xyz + d[0], scales + d[2], quats + d[1], opac, rgb, gmap.alive, T_cw,
                    proj, torch.zeros(3, device=xyz.device), config=cfg.raster,
                    **intr.raster_kw())
    return out, d


def _payload_camera(T_view: torch.Tensor) -> torch.Tensor:
    """The view cameras the flow payloads are projected through, held
    constant: the flow loss reaches a window view's pose only through where
    its flow render's splats land. The reference also differentiates the
    payload, ndc(x2, P T_pair) - ndc(x1, P T_view), with respect to the
    pose (fourdgs/slam/mapping_dynamic.py:279-281). Where the field does
    not yet carry the blob's motion, that path lowers the flow loss by
    moving the camera: on the `bench.py --dynamic` run it pulled the
    window's keyframes 25-90 mm off in two 4D phases, against 5-9 mm
    without it (dynamic_runs.py; ROADMAP, faults against the reference)."""
    return T_view.detach()


def _dyn_view_geometry(params, deform, dygs: torch.Tensor, store: KeyframeStore,
                       main_slots: torch.Tensor, pair_slots: torch.Tensor,
                       flow_main: torch.Tensor, dtaus: torch.Tensor, proj: torch.Tensor):
    """Per-view geometry, payloads and cameras of the batched render:
    [nm main views | nf flow views at the view camera | nf at the pair
    camera]. `deform` = (d_xyz, d_rot, d_scale), each (nm + nf, N, .): the
    warp at the main views' times, then at the pairs' times; flow view j
    belongs to main view flow_main[j]. Main views carry the live map plus
    the deformation; flow views detach the map (only the deformation and,
    through the splats' positions, the view's pose get gradients)."""
    d_xyz, d_rot, d_scale = deform
    xyz, scales, quats, opac, rgb = _activated(params)
    nm, n = main_slots.shape[0], xyz.shape[0]
    T_main = se3_exp(dtaus) @ store.T_cw[main_slots]
    T_pair = store.T_cw[pair_slots]
    T_view = T_main[flow_main]
    x1 = xyz.detach() + d_xyz[flow_main]
    x2 = xyz.detach() + d_xyz[nm:]
    flow12 = flow_payload(x1, x2, proj @ _payload_camera(T_view), proj @ T_pair, dygs)
    payload21 = torch.cat([-flow12[..., :2], flow12[..., 2:]], dim=-1)
    nf = flow12.shape[0]
    means = torch.cat([xyz + d_xyz[:nm], x1, x2])
    scl = torch.cat([scales + d_scale[:nm], scales.detach() + d_scale[flow_main],
                     scales.detach() + d_scale[nm:]])
    qts = torch.cat([quats + d_rot[:nm], quats.detach() + d_rot[flow_main],
                     quats.detach() + d_rot[nm:]])
    opacs = torch.cat([opac.expand(nm, n), opac.detach().expand(2 * nf, n)])
    colors = torch.cat([rgb.expand(nm, n, 3), flow12, payload21])
    return means, scl, qts, opacs, colors, torch.cat([T_main, T_view, T_pair])


class DynChunkResult(NamedTuple):
    gmap: GaussianMap
    adam: AdamState
    store: KeyframeStore
    pose_adam: PoseAdam
    deform: D.ControlNodes
    deform_adam: DeformAdam
    final_loss: float
    overflow: bool   # any render binned more than max_pairs pairs
    num_pairs: int   # max pairs per view seen in the chunk


def map_chunk_dynamic(
    gmap: GaussianMap,
    adam: AdamState,
    store: KeyframeStore,
    cn: D.ControlNodes,
    deform_adam: DeformAdam,
    window_slots: np.ndarray,     # (Vw,) int store slots (key_opt order)
    window_valid: np.ndarray,     # (Vw,) bool
    opt_pose: np.ndarray,         # (Vw,) bool
    flow_pair_slots: np.ndarray,  # (Vw,) slot of the closest earlier keyframe, -1: none
    flow_fwd: torch.Tensor,       # (Vw, 2, H, W) normalized flow pair -> view
    flow_bwd: torch.Tensor,       # (Vw, 2, H, W) normalized flow view -> pair
    rand_pool: np.ndarray,
    rand_pool_size: int,
    pose_adam: PoseAdam,
    draws,                        # (picks, arap_u, elastic_u) of `draws.dynamic_chunk`
    num_iters: int,
    step_after: int,
    iter_base: int,
    intr: Intrinsics,
    cfg: MappingConfig = MappingConfig(),
    flow_weight: float = 3.0,
    flow_weight_fine: float | None = None,
    time_interval: float = 1.0 / 100,
) -> DynChunkResult:
    picks, arap_u, elastic_u = draws
    dev = gmap.alive.device
    proj = intr.proj(device=dev)
    kw = intr.raster_kw()
    vw, vr = cfg.num_window_views, cfg.num_random_views
    window_slots = np.asarray(window_slots)
    window_valid = np.asarray(window_valid, bool)
    pair_np = np.asarray(flow_pair_slots)
    w_act = np.nonzero(window_valid)[0]
    f_act = np.nonzero(window_valid & (pair_np >= 0))[0]       # window views with a pair
    nw, nf = len(w_act), len(f_act)
    lt = lambda a: torch.as_tensor(np.asarray(a), device=dev, dtype=torch.long)  # noqa: E731
    w_slots, f_pairs = lt(window_slots[w_act]), lt(pair_np[f_act])
    flow_main = lt(np.searchsorted(w_act, f_act))
    fmot_b = ~store.motion[lt(window_slots[f_act])]
    fmot_f = ~store.motion[f_pairs]
    fwd_t, bwd_t = flow_fwd[lt(f_act)], flow_bwd[lt(f_act)]
    uid_ok = (store.uids[lt(window_slots)].cpu().numpy() != 0) & window_valid
    mask8 = torch.as_tensor(
        np.concatenate([np.repeat((opt_pose & uid_ok)[:, None], 6, 1),
                        np.repeat(uid_ok[:, None], 2, 1)], 1),
        dtype=torch.float32, device=dev,
    )
    pose_lr = torch.tensor([cfg.lr_trans] * 3 + [cfg.lr_rot] * 3 + [cfg.lr_exposure] * 2,
                           device=dev)
    size = max(rand_pool_size, 1)
    rand_valid = np.arange(vr) < min(rand_pool_size, vr)
    reg_w = torch.tensor([REG_WINDOW] * vw + [REG_REPLAY] * vr, device=dev)
    delta_t = 5 * time_interval

    valid_n = cn.valid
    like = D.cn_floats(cn)
    flat, mu_f, nu_f = (D.flatten(x) for x in (like, deform_adam.mu, deform_adam.nu))
    d_count = deform_adam.count
    # the nodes never move (every use detaches them): the elastic term's
    # neighbours hold for the whole chunk
    el_knn = D.knn_nodes(cn, cn.nodes, 3)

    loss_val = torch.tensor(float("inf"))
    ov_seen = torch.zeros((), dtype=torch.bool, device=dev)
    pm_seen = torch.zeros((), dtype=torch.long, device=dev)
    rb = max(cfg.rebin_every, 1)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def deform_at(cn_p, xyz, t_warp, t_reg):
        """The warp at times t_warp (T,) and the node positions at the
        regularizers' samples t_reg (...): one MLP call."""
        nd = D.node_deform(cn_p, torch.cat([t_warp, t_reg.reshape(-1)]))
        nt = t_warp.shape[0]
        w, idx = D.knn_nodes(cn_p, xyz)
        warp = D.blend_deform(tuple(x[:nt] for x in nd), D.blend_weights(cn_p, w, idx), idx,
                              gmap.dygs)
        nodes_t = cn_p.nodes.detach() + nd[0][nt:].reshape(t_reg.shape + cn_p.nodes.shape)
        return warp, nodes_t

    for i in range(num_iters):
        r1, r2 = int(picks[i, 0]), int(picks[i, 1])
        r2 = (r2 + 1 if r2 >= r1 else r2) % size
        r_slots = np.asarray([rand_pool[r1], rand_pool[r2]][:vr])[rand_valid]
        main_slots = lt(np.concatenate([window_slots[w_act], r_slots]))
        main_v = lt(np.concatenate([w_act, vw + np.nonzero(rand_valid)[0]]))
        nm = main_slots.shape[0]
        dynamic_phase, flow_w = phase_weights(i, num_iters, flow_weight, flow_weight_fine)
        t_main = store.times[main_slots]
        t_pair = store.times[f_pairs]

        if i % rb == 0:
            # window and flow bins at this iteration's geometry
            with torch.no_grad():
                cn0 = D.cn_merge(D.unflatten(flat, like), valid_n)
                t_w = torch.cat([t_main[:nw], t_pair])
                d0, _ = deform_at(cn0, gmap.params.xyz, t_w, t_w[:0])
                m, s, q, o, _, T0 = _dyn_view_geometry(
                    gmap.params, d0, gmap.dygs, store, w_slots, f_pairs, flow_main,
                    torch.zeros((nw, 6), device=dev), proj)
                bins_w = compute_bins_multi(m[:nw], s[:nw], q[:nw], gmap.alive, T0[:nw], proj,
                                            o[:nw], config=cfg.raster, **kw)
                bins_f = compute_bins_multi(m[nw:], s[nw:], q[nw:], gmap.alive, T0[nw:], proj,
                                            o[nw:], config=cfg.raster, **kw) if nf else None

        params = gmap.params.map(lambda x: x.detach().requires_grad_(True))
        flat_p = flat.detach().requires_grad_(True)
        dtaus = torch.zeros((nm, 6), device=dev, requires_grad=True)
        dexps = torch.zeros((nm, 2), device=dev, requires_grad=True)
        taps = torch.zeros((nm + 2 * nf, gmap.capacity, 2), device=dev, requires_grad=True)
        cn_p = D.cn_merge(D.unflatten(flat_p, like), valid_n)

        t_reg = torch.cat([D.sample_times(arap_u[i, main_v, 0], arap_u[i, main_v, 1:],
                                          t_main, delta_t),
                           D.sample_times(elastic_u[i, main_v, 0], elastic_u[i, main_v, 1:],
                                          t_main, delta_t)], dim=1)   # (nm, 2 + 8)
        warp, nodes_t = deform_at(cn_p, params.xyz, torch.cat([t_main, t_pair]), t_reg)
        means, scl, qts, opacs, colors, T_all = _dyn_view_geometry(
            params, warp, gmap.dygs, store, main_slots, f_pairs, flow_main, dtaus, proj)
        bins = bins_w
        if nm > nw:
            bins = cat_bins(bins_w, compute_bins_multi(
                means[nw:nm], scl[nw:nm], qts[nw:nm], gmap.alive, T_all[nw:nm], proj,
                opacs[nw:nm], config=cfg.raster, **kw))
        if nf:
            bins = cat_bins(bins, bins_f)
        ov_seen = ov_seen | bins.overflow.any()
        pm_seen = torch.maximum(pm_seen, bins.num_pairs.max())
        out = rasterize_multi(means, scl, qts, opacs, colors, gmap.alive, T_all, proj,
                              torch.zeros(3, device=dev), mean2d_offsets=taps,
                              config=cfg.raster, bins=bins, **kw)

        exp_abs = store.exposure[main_slots] + dexps
        images_ab = (torch.exp(exp_abs[:, 0])[:, None, None, None] * out.color[:nm]
                     + exp_abs[:, 1][:, None, None, None])
        main_l = mapping_loss_rgbd(
            images_ab, out.depth[:nm], fetch_images(store, main_slots), store.depths[main_slots],
            motion_mask=store.motion[main_slots], alpha=cfg.alpha,
            rgb_boundary_threshold=cfg.rgb_boundary_threshold, rm_dynamic=False,
            dynamic=dynamic_phase,
        )
        loss = torch.sum(main_l)
        if nf:
            fb = masked_flow_l1(out.color[nm:nm + nf, :2], bwd_t, fmot_b)
            ff = masked_flow_l1(out.color[nm + nf:, :2], fwd_t, fmot_f)
            loss = loss + torch.sum(flow_w * (fb + ff))
        regs = (D.arap_from_nodes(nodes_t[:, :2], valid_n)
                + D.elastic_from_nodes(nodes_t[:, 2:], D.blend_weights(cn_p, *el_knn)[:, 1:],
                                       el_knn[1][:, 1:], valid_n))
        loss = loss + torch.sum(reg_w[main_v] * regs)
        loss = loss + cfg.isotropic_weight * isotropic_loss(torch.exp(params.scaling),
                                                            gmap.alive)
        grads = torch.autograd.grad(loss, list(params) + [flat_p, dtaus, dexps, taps],
                                    allow_unused=True, materialize_grads=True)
        g_params = type(gmap.params)(*grads[:5])
        g_flat, g_taus, g_exps, g_taps = grads[5:]

        with torch.no_grad():
            loss_val = loss.detach()
            upd = (out.radii[:nm] > 0).to(torch.float32)
            norms = torch.linalg.norm(g_taps[:nm], dim=-1)
            gmap = gmap._replace(
                grad_accum=gmap.grad_accum + torch.sum(norms * upd, dim=0),
                denom=gmap.denom + torch.sum(upd, dim=0),
            )
            if i > step_after:
                adv = max(0, i - max(step_after + 1, 0))
                mult = expon_lr(float(iter_base + adv), 1.0, cfg.xyz_lr_ratio,
                                max_steps=cfg.xyz_lr_max_steps)
                p2, adam = adam_step(gmap.params, g_params, adam, cfg.lrs, gmap.alive,
                                     xyz_lr_mult=mult)
                gmap = gmap._replace(params=p2)
            d_count += 1
            flat, mu_f, nu_f = _adam_flat(flat, g_flat, mu_f, nu_f, d_count)

            # pose + exposure step of the window views
            gp = torch.zeros((vw, 8), device=dev)
            act = lt(w_act)
            gp[act] = torch.cat([g_taus[:nw], g_exps[:nw]], dim=1)
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

    return DynChunkResult(
        gmap=gmap, adam=adam, store=store, pose_adam=pose_adam,
        deform=D.cn_merge(D.unflatten(flat, like), valid_n),
        deform_adam=DeformAdam(D.unflatten(mu_f, like), D.unflatten(nu_f, like), d_count),
        final_loss=float(loss_val), overflow=bool(ov_seen), num_pairs=int(pm_seen),
    )


def warmup_network(
    gmap: GaussianMap,
    adam: AdamState,
    cn: D.ControlNodes,
    deform_adam: DeformAdam,
    store: KeyframeStore,
    slot: int,
    num_iters: int,
    intr: Intrinsics,
    cfg: MappingConfig = MappingConfig(),
):
    """Deformation warmup on the keyframe at `slot`: `num_iters` steps of
    the network loss (dynamic pixels x3) on its deformed render, each an
    Adam step of the map and of the field. Returns (gmap, adam, cn,
    deform_adam, last loss)."""
    dev = gmap.alive.device
    proj = intr.proj(device=dev)
    image_gt = fetch_images(store, slot)
    depth_gt, motion, t_kf, T_kf = (store.depths[slot], store.motion[slot], store.times[slot],
                                    store.T_cw[slot])
    like = D.cn_floats(cn)
    flat, mu_f, nu_f = (D.flatten(x) for x in (like, deform_adam.mu, deform_adam.nu))
    d_count = deform_adam.count
    loss_val = torch.tensor(float("inf"))
    for _ in range(num_iters):
        params = gmap.params.map(lambda x: x.detach().requires_grad_(True))
        flat_p = flat.detach().requires_grad_(True)
        cn_p = D.cn_merge(D.unflatten(flat_p, like), cn.valid)
        out, _ = _deformed_render(gmap._replace(params=params), cn_p, T_kf, t_kf, proj,
                                  intr, cfg)
        loss = network_loss_rgbd(out.color, out.depth, out.alpha, image_gt, depth_gt,
                                 motion_mask=motion, dynamic=True)
        grads = torch.autograd.grad(loss, list(params) + [flat_p], allow_unused=True,
                                    materialize_grads=True)
        with torch.no_grad():
            loss_val = loss.detach()
            p2, adam = adam_step(gmap.params, type(gmap.params)(*grads[:5]), adam, cfg.lrs,
                                 gmap.alive)
            gmap = gmap._replace(params=p2)
            d_count += 1
            flat, mu_f, nu_f = _adam_flat(flat, grads[5], mu_f, nu_f, d_count)
    return (gmap, adam, D.cn_merge(D.unflatten(flat, like), cn.valid),
            DeformAdam(D.unflatten(mu_f, like), D.unflatten(nu_f, like), d_count),
            float(loss_val))
