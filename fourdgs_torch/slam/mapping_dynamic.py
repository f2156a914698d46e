"""4D mapping: deformation-aware map optimization with flow supervision
(port of fourdgs/slam/mapping_dynamic.py).

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
On a mesh the views are sharded over its ranks as `mapping.map_chunk`
shards them.

`warmup_network` is the deformation warmup on the keyframe that starts
the dynamic phase: network loss, map and field steps.

Spans (utils/trace.py): `map_chunk_dynamic` (work: the iterations), with
one `dyn_iter` per iteration. Sync sites: `mapping.py`'s pose mask and
learning rates, the regularizer weights' copy (`dyn.reg_h2d`), every
index array copied to the device (`dyn.index_h2d`), and at the end the
loss (`dyn.loss`) and the overflow and pair count (`dyn.seen`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fourdgs_torch.geometry.se3 import se3_exp
from fourdgs_torch.models import deform as D
from fourdgs_torch.models.gaussian_map import AdamState, GaussianMap, adam_step
from fourdgs_torch.ops.rasterize.api import (
    compute_bins_multi,
    flow_payload,
    rasterize,
    rasterize_multi,
)
from fourdgs_torch.slam.camera import Intrinsics
from fourdgs_torch.slam.keyframes import KeyframeStore, fetch_images
from fourdgs_torch.slam.losses import (
    isotropic_loss,
    mapping_loss_rgbd,
    masked_flow_l1,
    network_loss_rgbd,
)
from fourdgs_torch.parallel.comm import Comm
from fourdgs_torch.utils.trace import span, sync
from fourdgs_torch.slam.mapping import (
    MappingConfig,
    PoseAdam,
    _activated,
    _cat_some,
    _compact_store,
    _map_step,
    _plan_views,
    _pose_lr,
    _pose_mask,
    _pose_step,
    rank_block,
)

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


def _deform_at(cn_p: D.ControlNodes, xyz: torch.Tensor, dygs: torch.Tensor,
               t_warp: torch.Tensor, t_reg: torch.Tensor):
    """The warp of the Gaussians at times t_warp (T,) and the node
    positions at the regularizers' samples t_reg (...): one MLP call."""
    nd = D.node_deform(cn_p, torch.cat([t_warp, t_reg.reshape(-1)]))
    nt = t_warp.shape[0]
    w, idx = D.knn_nodes(cn_p, xyz)
    warp = D.blend_deform(tuple(x[:nt] for x in nd), D.blend_weights(cn_p, w, idx), idx, dygs)
    nodes_t = cn_p.nodes.detach() + nd[0][nt:].reshape(t_reg.shape + cn_p.nodes.shape)
    return warp, nodes_t


def _regularizers(cn_p: D.ControlNodes, nodes_t: torch.Tensor, el_knn) -> torch.Tensor:
    """(V,) ARAP + elastic energies of the node positions (V, 2 + 8, M, 3)
    at each view's ARAP samples, then its elastic samples."""
    valid_n = cn_p.valid
    return (D.arap_from_nodes(nodes_t[:, :2], valid_n)
            + D.elastic_from_nodes(nodes_t[:, 2:], D.blend_weights(cn_p, *el_knn)[:, 1:],
                                   el_knn[1][:, 1:], valid_n))


def _reg_times(arap_u, elastic_u, t_main, delta_t):
    """(V, 2 + 8) regularizer sample times around the views' times from
    their draws (V, 3) and (V, 9)."""
    return torch.cat([D.sample_times(arap_u[:, 0], arap_u[:, 1:], t_main, delta_t),
                      D.sample_times(elastic_u[:, 0], elastic_u[:, 1:], t_main, delta_t)],
                     dim=1)


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
    mesh=None,                    # a parallel.Mesh: the views sharded over its ranks
) -> DynChunkResult:
    """The chunk runs as `_dynamic_rank`: on one device as a group of one
    rank, or with `mesh` on each of its ranks, each iteration's valid
    views [main | flow at the view camera | flow at the pair camera] split
    in contiguous blocks over them (`mapping.rank_block`). A rank is sent
    the chunk's keyframes once; on a mesh every view is binned afresh
    every iteration, as the reference's mesh branch does."""
    with span("map_chunk_dynamic", num_iters):
        picks, arap_u, elastic_u = draws
        window_slots = np.asarray(window_slots)
        window_valid = np.asarray(window_valid, bool)
        pair_np = np.asarray(flow_pair_slots)
        f_valid = window_valid & (pair_np >= 0)
        dev = store.valid.device
        slots_all, valid_all = _plan_views(window_slots, window_valid, np.asarray(rand_pool),
                                           rand_pool_size, picks, num_iters, cfg)
        mask8 = _pose_mask(store, window_slots, window_valid, np.asarray(opt_pose, bool), dev)
        rest = (pose_adam, arap_u, elastic_u, num_iters, step_after, iter_base, intr, cfg,
                flow_weight, flow_weight_fine, time_interval)
        if mesh is None:
            res = _dynamic_rank(Comm.local(dev), gmap, adam, store, cn, deform_adam, slots_all,
                                valid_all, np.where(f_valid, pair_np, -1), mask8, flow_fwd,
                                flow_bwd, *rest, max(cfg.rebin_every, 1))
        else:
            sent, idx, local = _compact_store(store, np.concatenate([slots_all[valid_all],
                                                                     pair_np[f_valid]]))
            res = mesh.run(_dynamic_rank, gmap, adam, sent, cn, deform_adam,
                           np.where(valid_all, local[slots_all * valid_all], 0), valid_all,
                           np.where(f_valid, local[np.where(f_valid, pair_np, 0)], -1), mask8,
                           flow_fwd, flow_bwd, *rest, 1)
            store.T_cw[idx] = res.T_cw
            store.exposure[idx] = res.exposure
        return DynChunkResult(gmap=res.gmap, adam=res.adam, store=store, pose_adam=res.pose_adam,
                              deform=res.deform, deform_adam=res.deform_adam,
                              final_loss=res.final_loss, overflow=res.overflow,
                              num_pairs=res.num_pairs)


class _DynRankResult(NamedTuple):
    """What every rank holds after `_dynamic_rank`, bit for bit alike."""
    gmap: GaussianMap
    adam: AdamState
    pose_adam: PoseAdam
    T_cw: torch.Tensor       # the rank's store's poses and exposures
    exposure: torch.Tensor
    deform: D.ControlNodes
    deform_adam: DeformAdam
    final_loss: float
    overflow: bool
    num_pairs: int


def _dynamic_rank(comm, gmap: GaussianMap, adam: AdamState, store: KeyframeStore,
                  cn: D.ControlNodes, deform_adam: DeformAdam, slots_all: np.ndarray,
                  valid_all: np.ndarray, pairs: np.ndarray, mask8: torch.Tensor,
                  flow_fwd: torch.Tensor, flow_bwd: torch.Tensor, pose_adam: PoseAdam,
                  arap_u: torch.Tensor, elastic_u: torch.Tensor, num_iters: int,
                  step_after: int, iter_base: int, intr: Intrinsics, cfg: MappingConfig,
                  flow_weight: float, flow_weight_fine: float | None,
                  time_interval: float, rebin_every: int) -> _DynRankResult:
    """One rank of `map_chunk_dynamic`, every rank alike. The view set's
    global ids are [nv main | vw flow at the view camera | vw flow at the
    pair camera]; a rank renders its block of the valid ones
    (`mapping.rank_block`), warping the field at their times only (a flow
    view needs its window view's and its pair's), and rank 0 adds the
    regularizers and the isotropic term once, with the caller's draws. The
    loss, the map's and the field's gradients, the per-view pose and
    exposure gradients and the densification statistics are `psum`'d;
    then every rank takes the same steps from the same sums. The overflow
    and pair count are `pmax`'d once, at the end. The bins of the rank's
    window and flow views (its block of them holds for the chunk) are made
    every `rebin_every` iterations at that iteration's geometry, the
    replay views' every iteration. `slots_all` (main views per iteration)
    and `pairs` (per window view, -1: no flow pair) index `store`."""
    dev = comm.device
    proj = intr.proj(device=dev)
    kw = intr.raster_kw()
    vw, nv = cfg.num_window_views, cfg.num_views

    def lt(a):
        with sync("dyn.index_h2d"):
            return torch.as_tensor(np.asarray(a), device=dev, dtype=torch.long)

    f_valid = pairs >= 0
    w_valid = valid_all[0, :vw]
    act = lt(np.nonzero(w_valid)[0])
    w_slots = lt(slots_all[0, :vw][w_valid])
    pose_lr = _pose_lr(cfg, dev)
    with sync("dyn.reg_h2d"):
        reg_w = torch.tensor([REG_WINDOW] * vw + [REG_REPLAY] * (nv - vw), device=dev)
    delta_t = 5 * time_interval
    valid_n = cn.valid
    like = D.cn_floats(cn)
    flat, mu_f, nu_f = (D.flatten(x) for x in (like, deform_adam.mu, deform_adam.nu))
    d_count = deform_adam.count
    # the nodes never move (every use detaches them): the elastic term's
    # neighbours hold for the whole chunk
    el_knn = D.knn_nodes(cn, cn.nodes, 3)
    cap = gmap.capacity
    sizes = [p.numel() for p in gmap.params]
    n_p, n_d = sum(sizes), flat.numel()
    loss_val = torch.tensor(float("inf"))
    seen = torch.zeros(2, dtype=torch.long, device=dev)   # overflow, most pairs of a view

    for i in range(num_iters):
        with span("dyn_iter"):
            slots_i, valid_i = slots_all[i], valid_all[i]
            view_ok = np.concatenate([valid_i, f_valid, f_valid])
            ids = rank_block(np.nonzero(view_ok)[0], comm.rank, comm.size)
            m_ids = ids[ids < nv]                              # main views rendered here
            fb = ids[(ids >= nv) & (ids < nv + vw)] - nv       # window views of flow renders
            ff = ids[ids >= nv + vw] - nv - vw
            flows = np.union1d(fb, ff)
            need = np.union1d(m_ids, flows)                    # main views whose geometry is used
            n_w = int((m_ids < vw).sum())                      # window main views rendered here
            dynamic_phase, flow_w = phase_weights(i, num_iters, flow_weight, flow_weight_fine)

            if i % rebin_every == 0:
                # window and flow bins at this iteration's geometry
                bins_w = bins_f = None
                need_w = need[need < vw]
                if need_w.size:
                    with torch.no_grad():
                        cn0 = D.cn_merge(D.unflatten(flat, like), valid_n)
                        t_w = torch.cat([store.times[lt(slots_i[need_w])],
                                         store.times[lt(pairs[flows])]])
                        d0, _ = _deform_at(cn0, gmap.params.xyz, gmap.dygs, t_w, t_w[:0])
                        geo = _dyn_view_geometry(
                            gmap.params, d0, gmap.dygs, store, lt(slots_i[need_w]),
                            lt(pairs[flows]), lt(np.searchsorted(need_w, flows)),
                            torch.zeros((need_w.size, 6), device=dev), proj)
                        bins_w, bins_f = (_bins_of(geo, lt(rows), gmap.alive, proj, cfg, kw)
                                          for rows in _render_rows(need_w, flows, m_ids[:n_w],
                                                                   fb, ff))

            params = gmap.params.map(lambda x: x.detach().requires_grad_(True))
            flat_p = flat.detach().requires_grad_(True)
            cn_p = D.cn_merge(D.unflatten(flat_p, like), valid_n)
            loss = torch.zeros((), device=dev)
            leaves = list(params) + [flat_p]
            pack = torch.zeros(1 + n_p + n_d + nv * 8 + 2 * cap, device=dev)
            t_warp = torch.cat([store.times[lt(slots_i[need])], store.times[lt(pairs[flows])]])
            if comm.rank == 0:
                main_v = np.nonzero(valid_i)[0]
                t_reg = _reg_times(arap_u[i, lt(main_v)], elastic_u[i, lt(main_v)],
                                   store.times[lt(slots_i[main_v])], delta_t)
            else:
                t_reg = t_warp.new_zeros((0, 10))
            if need.size or comm.rank == 0:
                warp, nodes_t = _deform_at(cn_p, params.xyz, gmap.dygs, t_warp, t_reg)
            if need.size:
                dtaus = torch.zeros((need.size, 6), device=dev, requires_grad=True)
                dexps = torch.zeros((m_ids.size, 2), device=dev, requires_grad=True)
                geo = _dyn_view_geometry(params, warp, gmap.dygs, store, lt(slots_i[need]),
                                         lt(pairs[flows]), lt(np.searchsorted(need, flows)), dtaus,
                                         proj)
                rows_m, rows_f = _render_rows(need, flows, m_ids, fb, ff)
                means, scl, qts, opacs, colors, T_all = (x[lt(np.concatenate([rows_m, rows_f]))]
                                                         for x in geo)
                taps = torch.zeros((means.shape[0], cap, 2), device=dev, requires_grad=True)
                nm = m_ids.size
                bins = _cat_some(bins_w, compute_bins_multi(
                    means[n_w:nm], scl[n_w:nm], qts[n_w:nm], gmap.alive, T_all[n_w:nm], proj,
                    opacs[n_w:nm], config=cfg.raster, **kw) if nm > n_w else None, bins_f)
                seen = torch.maximum(seen, torch.stack([bins.overflow.any().long(),
                                                        bins.num_pairs.max().long()]))
                out = rasterize_multi(means, scl, qts, opacs, colors, gmap.alive, T_all, proj,
                                      torch.zeros(3, device=dev), mean2d_offsets=taps,
                                      config=cfg.raster, bins=bins, **kw)
                m_slots = lt(slots_i[m_ids])
                exp_abs = store.exposure[m_slots] + dexps
                images_ab = (torch.exp(exp_abs[:, 0])[:, None, None, None] * out.color[:nm]
                             + exp_abs[:, 1][:, None, None, None])
                main_l = mapping_loss_rgbd(
                    images_ab, out.depth[:nm], fetch_images(store, m_slots), store.depths[m_slots],
                    motion_mask=store.motion[m_slots], alpha=cfg.alpha,
                    rgb_boundary_threshold=cfg.rgb_boundary_threshold, rm_dynamic=False,
                    dynamic=dynamic_phase,
                )
                loss = loss + torch.sum(main_l)
                if fb.size:
                    lb = masked_flow_l1(out.color[nm:nm + fb.size, :2], flow_bwd[lt(fb)],
                                        ~store.motion[lt(slots_i[fb])])
                    loss = loss + torch.sum(flow_w * lb)
                if ff.size:
                    lf = masked_flow_l1(out.color[nm + fb.size:, :2], flow_fwd[lt(ff)],
                                        ~store.motion[lt(pairs[ff])])
                    loss = loss + torch.sum(flow_w * lf)
                leaves += [dtaus, dexps, taps]
            if comm.rank == 0:
                loss = loss + torch.sum(reg_w[lt(main_v)] * _regularizers(cn_p, nodes_t, el_knn))
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
                pack[1 + n_p:1 + n_p + n_d] = grads[5]
                if need.size:
                    g_taus, g_exps, g_taps = grads[6:]
                    g8 = pack[1 + n_p + n_d:1 + n_p + n_d + nv * 8].view(nv, 8)
                    g8[lt(need), :6] = g_taus
                    g8[lt(m_ids), 6:] = g_exps
                    upd = (out.radii[:nm] > 0).to(torch.float32)
                    norms = torch.linalg.norm(g_taps[:nm], dim=-1)
                    pack[-2 * cap:-cap] = torch.sum(norms * upd, dim=0)
                    pack[-cap:] = torch.sum(upd, dim=0)
                pack = comm.psum(pack)
                loss_val = pack[0]
                g_params = type(gmap.params)(*(g.view_as(p) for g, p in zip(
                    torch.split(pack[1:1 + n_p], sizes), gmap.params)))
                gmap = gmap._replace(grad_accum=gmap.grad_accum + pack[-2 * cap:-cap],
                                     denom=gmap.denom + pack[-cap:])
                gmap, adam = _map_step(gmap, adam, g_params, i, step_after, iter_base, cfg)
                d_count += 1
                flat, mu_f, nu_f = _adam_flat(flat, pack[1 + n_p:1 + n_p + n_d], mu_f, nu_f,
                                              d_count)
                gp = torch.zeros((vw, 8), device=dev)
                gp[act] = pack[1 + n_p + n_d:1 + n_p + n_d + vw * 8].view(vw, 8)[act]
                pose_adam = _pose_step(pose_adam, gp, mask8, pose_lr, store, act, w_slots)

    seen = comm.pmax(seen)
    with sync("dyn.loss"):
        final_loss = float(loss_val)
    with sync("dyn.seen", 2):
        overflow, num_pairs = bool(seen[0]), int(seen[1])
    return _DynRankResult(
        gmap=gmap, adam=adam, pose_adam=pose_adam, T_cw=store.T_cw, exposure=store.exposure,
        deform=D.cn_merge(D.unflatten(flat, like), valid_n),
        deform_adam=DeformAdam(D.unflatten(mu_f, like), D.unflatten(nu_f, like), d_count),
        final_loss=final_loss, overflow=overflow, num_pairs=num_pairs)


def _render_rows(need: np.ndarray, flows: np.ndarray, m_ids, fb, ff):
    """Where the main views `m_ids` and the flow views `fb` (at the view
    camera) and `ff` (at the pair camera) stand in the rows of
    `_dyn_view_geometry` over the main views `need` and the flow pairs of
    `flows`: (main rows, flow rows)."""
    n, nf = need.size, flows.size
    return (np.searchsorted(need, m_ids),
            np.concatenate([n + np.searchsorted(flows, fb), n + nf + np.searchsorted(flows, ff)]))


def _bins_of(geo, rows: torch.Tensor, alive, proj, cfg: MappingConfig, kw):
    """The bins of the rows `rows` of a `_dyn_view_geometry`, None for no
    row."""
    if not rows.shape[0]:
        return None
    m, s, q, o, _, T = (x[rows] for x in geo)
    return compute_bins_multi(m, s, q, alive, T, proj, o, config=cfg.raster, **kw)


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
