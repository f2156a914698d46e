# Frozen copy of fourdgs_torch/slam/keyframes.py (lines 1-232,
# commit c19f610): the port's plain path, kept as the benchmark's
# reference, unchanged but for its imports, which name these copies.
"""Device-resident keyframe store and window management (port of
fourdgs/slam/keyframes.py).

Keyframes live in one fixed-capacity set of device tensors (images as
uint8) so that mapping can gather any keyframe, including the random
replay picks. The store is updated in place: a functional copy per
keyframe would duplicate every stored image and depth map.

The window policy (translation/covisibility keyframe test, window
eviction, covisibility-overlap selection) is host-side numpy. The
depth-reprojection mask of `rm_initdy` (`reproject_mask`) runs on the
device of its inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.slam.camera import Frame


class KeyframeStore(NamedTuple):
    images_u8: torch.Tensor  # (M, 3, H, W) uint8
    depths: torch.Tensor     # (M, H, W) f32
    motion: torch.Tensor     # (M, H, W) bool (True = static)
    times: torch.Tensor      # (M,)
    uids: torch.Tensor       # (M,) int32
    T_cw: torch.Tensor       # (M, 4, 4) current pose estimates
    exposure: torch.Tensor   # (M, 2)
    valid: torch.Tensor      # (M,) bool

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


def empty_store(capacity: int, height: int, width: int,
                device: torch.device | str) -> KeyframeStore:
    return KeyframeStore(
        images_u8=torch.zeros((capacity, 3, height, width), dtype=torch.uint8, device=device),
        depths=torch.zeros((capacity, height, width), device=device),
        motion=torch.ones((capacity, height, width), dtype=torch.bool, device=device),
        times=torch.zeros((capacity,), device=device),
        uids=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        T_cw=torch.eye(4, device=device).repeat(capacity, 1, 1),
        exposure=torch.zeros((capacity, 2), device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def store_keyframe(store: KeyframeStore, slot: int, frame: Frame, T_cw,
                   exposure) -> KeyframeStore:
    """Write `frame` into `slot` (in place) and return the store."""
    store.images_u8[slot] = torch.clamp(frame.image * 255.0 + 0.5, 0, 255).to(torch.uint8)
    store.depths[slot] = frame.depth
    store.motion[slot] = frame.motion_mask
    store.times[slot] = float(frame.time)
    store.uids[slot] = int(frame.uid)
    store.T_cw[slot] = torch.as_tensor(T_cw, dtype=torch.float32)
    store.exposure[slot] = torch.as_tensor(exposure, dtype=torch.float32)
    store.valid[slot] = True
    return store


def fetch_images(store: KeyframeStore, slots) -> torch.Tensor:
    return store.images_u8[slots].to(torch.float32) / 255.0


# ---------------------------------------------------------------------------
# Host-side window policy (small-matrix math on numpy poses)
# ---------------------------------------------------------------------------


def is_keyframe(
    T_cur: np.ndarray,
    T_last_kf: np.ndarray,
    median_depth: float,
    cur_visibility: np.ndarray,
    last_kf_visibility: np.ndarray,
    kf_translation: float,
    kf_min_translation: float,
    kf_overlap: float,
) -> bool:
    """Translation + covisibility-IoU keyframe test."""
    rel = T_cur @ np.linalg.inv(T_last_kf)
    dist = float(np.linalg.norm(rel[:3, 3]))
    dist_check = dist > kf_translation * median_depth
    dist_check2 = dist > kf_min_translation * median_depth
    union = np.count_nonzero(cur_visibility | last_kf_visibility)
    inter = np.count_nonzero(cur_visibility & last_kf_visibility)
    ratio = inter / union if union > 0 else 0.0
    return bool((ratio < kf_overlap and dist_check2) or dist_check)


def add_to_window(
    cur_idx: int,
    cur_visibility: np.ndarray,
    occ_visibility: dict[int, np.ndarray],
    window: list[int],
    poses: dict[int, np.ndarray],
    kf_cutoff: float,
    window_size: int,
    initialized: bool = True,
) -> tuple[list[int], int | None]:
    """Prepend the new keyframe, evict the last low-overlap frame
    (Szymkiewicz-Simpson vs the current frame), then if over capacity
    evict the frame maximizing sqrt(d(i,0)) * sum_j 1/d(i,j)."""
    n_dont_touch = 2
    window = [cur_idx] + window
    removed = None
    to_remove = []
    for kf_idx in window[n_dont_touch:]:
        vis = occ_visibility[kf_idx]
        inter = np.count_nonzero(cur_visibility & vis)
        denom = min(np.count_nonzero(cur_visibility), np.count_nonzero(vis))
        cut = kf_cutoff if initialized else 0.4
        if denom == 0 or inter / denom <= cut:
            to_remove.append(kf_idx)
    if to_remove:
        window.remove(to_remove[-1])
        removed = to_remove[-1]

    if len(window) > window_size:
        inv_w2c_0 = np.linalg.inv(poses[cur_idx])
        scores = []
        for i in range(n_dont_touch, len(window)):
            T_i = poses[window[i]]
            inv_dists = []
            for j in range(n_dont_touch, len(window)):
                if i == j:
                    continue
                T_ij = T_i @ np.linalg.inv(poses[window[j]])
                inv_dists.append(1.0 / (np.linalg.norm(T_ij[:3, 3]) + 1e-6))
            T_i0 = T_i @ inv_w2c_0
            k = float(np.sqrt(np.linalg.norm(T_i0[:3, 3])))
            scores.append(k * sum(inv_dists))
        idx = int(np.argmax(scores))
        removed = window[n_dont_touch + idx]
        window.remove(removed)
    return window, removed


def keyframe_selection_overlap(
    depth0: np.ndarray,
    T0: np.ndarray,
    intrinsics,
    candidate_poses: dict[int, np.ndarray],
    before_uid: int,
    max_selected: int,
    rng: np.random.Generator,
    sample_pixels: int = 1600,
) -> list[int]:
    """Project the anchor keyframe's depth into candidate keyframes and
    keep those with any overlap, permuted and truncated as the reference
    does (its sort by overlap is dead code)."""
    h, w = depth0.shape
    vs, us = np.nonzero(depth0 > 0)
    if vs.size == 0:
        return []
    if vs.size > sample_pixels:
        pick = rng.choice(vs.size, sample_pixels, replace=False)
        vs, us = vs[pick], us[pick]
    z = depth0[vs, us]
    x = (us - intrinsics.cx) * z / intrinsics.fx
    y = (vs - intrinsics.cy) * z / intrinsics.fy
    pts_cam = np.stack([x, y, z, np.ones_like(z)], axis=0)
    pts_w = np.linalg.inv(T0) @ pts_cam

    ranked = []
    for uid, T in candidate_poses.items():
        if uid >= before_uid:
            continue
        pc = (T @ pts_w)[:3]
        zc = pc[2] + 1e-5
        u = intrinsics.fx * pc[0] / zc + intrinsics.cx
        v = intrinsics.fy * pc[1] / zc + intrinsics.cy
        edge = 20
        ok = (u > edge) & (u < w - edge) & (v > edge) & (v < h - edge) & (zc > 0)
        ranked.append((uid, float(np.mean(ok))))
    ranked = [u for u, p in sorted(ranked, key=lambda t: -t[1]) if p > 0.0]
    return list(rng.permutation(np.array(ranked, dtype=np.int64)))[:max_selected] if ranked else []


# ---------------------------------------------------------------------------
# Depth-reprojection consistency mask
# ---------------------------------------------------------------------------


def _dilate3x3(mask: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Binary dilation of an (H, W) bool mask by a 3x3 square, `iters`
    times; pixels outside the image count as False."""
    m = mask.to(torch.float32)[None, None]
    for _ in range(iters):
        m = F.max_pool2d(m, 3, stride=1, padding=1)
    return m[0, 0] > 0


def reproject_mask(
    anchor_depth: torch.Tensor,   # (H, W) f32 — anchor keyframe depth
    anchor_static: torch.Tensor,  # (H, W) bool — anchor motion mask (True = static)
    T_anchor_cw: torch.Tensor,    # (4, 4) anchor world->camera
    T_curr_cw: torch.Tensor,      # (4, 4) current-view world->camera
    fx: float, fy: float, cx: float, cy: float,
) -> torch.Tensor:
    """True on the pixels of the current view that the anchor keyframe's
    valid static depth does not cover: the depth is back-projected,
    reprojected into the current view, the pixels hit (coordinates
    truncated toward zero) marked, dilated three times by 3x3, and the
    complement returned. An anchor with no valid static depth gives all
    True. Runs on the inputs' device."""
    h, w = anchor_depth.shape
    dev = anchor_depth.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
    valid = (anchor_depth > 0) & anchor_static
    d = anchor_depth
    pts_c = torch.stack([(xs - cx) / fx * d, (ys - cy) / fy * d, d, torch.ones_like(d)],
                        dim=-1).reshape(-1, 4)
    pts = (pts_c @ torch.linalg.inv(T_anchor_cw).T) @ T_curr_cw.T
    z = pts[:, 2] + 1e-5
    u = pts[:, 0] / z * fx + cx
    v = pts[:, 1] / z * fy + cy
    # u >= 0 and u < w is trunc(u) in [0, w): the bounds test on the float
    # coordinates, before a cast that could overflow
    ok = valid.reshape(-1) & (z > 1e-5) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    hit = torch.zeros(h * w, dtype=torch.bool, device=dev)
    hit[v[ok].to(torch.int64) * w + u[ok].to(torch.int64)] = True
    return ~_dilate3x3(hit.reshape(h, w)) | ~torch.any(valid)
