"""Optical flow for the flow losses of 4D mapping (port of
fourdgs/perception/flow.py without the forward-backward consistency masks,
which the runner does not use).

A provider maps a frame pair (uid1, uid2) to pixel flows (fwd, bwd), each
(H, W, 2): fwd from frame uid2 to uid1, bwd from uid1 to uid2.
`SyntheticFlowProvider` computes them exactly for the synthetic sequence
(camera reprojection of the ground-truth depth plus the blob's known
motion). The RAFT and GMA networks that give recorded sequences their
flow are not ported yet; `network_weights` finds their weight files.
`FlowCache` keeps each pair's flows normalized to the loss's units
(px / [W, H] * 2), channel first. All host numpy: a pair's flow is
computed once per run.
"""

from __future__ import annotations

import os

import numpy as np

# weight files of the flow networks, relative to the working directory
WEIGHTS_PATHS = {
    "raft": ("pretrained/raft-things.npz", "pretrained/raft-things.pth"),
    "gma": ("pretrained/gma-things.npz", "pretrained/gma-things.pth"),
}


def network_weights(flow_model: str) -> str | None:
    """The first existing weights file of flow network `flow_model` ('raft'
    or 'gma'), or None."""
    return next((p for p in WEIGHTS_PATHS[flow_model] if os.path.exists(p)), None)


def normalize_flow(flow_px: np.ndarray) -> np.ndarray:
    """(H, W, 2) pixel flow -> px / [W, H] * 2."""
    h, w = flow_px.shape[:2]
    return flow_px / np.array([w, h], np.float32) * 2.0


class FlowCache:
    """Per-(uid1, uid2) flows: `get` returns ((2, H, W) fwd, (2, H, W) bwd)
    in normalized units."""

    def __init__(self, provider):
        self.provider = provider
        self._cache: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}

    def get(self, uid1: int, uid2: int):
        key = (uid1, uid2)
        if key not in self._cache:
            fwd_px, bwd_px = self.provider(uid1, uid2)
            self._cache[key] = (normalize_flow(fwd_px).transpose(2, 0, 1),
                                normalize_flow(bwd_px).transpose(2, 0, 1))
        return self._cache[key]


class SyntheticFlowProvider:
    """Exact optical flow of the synthetic dataset: every pixel of one frame
    is back-projected with its ground-truth depth, moved with the blob if
    it is dynamic, and projected into the other frame."""

    def __init__(self, dataset):
        self.dataset = dataset

    def _flow(self, uid_a: int, uid_b: int) -> np.ndarray:
        from fourdgs_torch.data.synthetic import blob_offset

        ds = self.dataset
        _, depth, T_a, motion = ds[uid_a]
        T_b = ds.poses[uid_b]
        h, w = depth.shape
        v, u = np.mgrid[0:h, 0:w].astype(np.float32)
        z = depth
        x = (u - ds.cx) * z / ds.fx
        y = (v - ds.cy) * z / ds.fy
        pc = np.stack([x, y, z], -1).reshape(-1, 3)
        Ra, ta = T_a[:3, :3], T_a[:3, 3]
        pw = (pc - ta) @ Ra
        if ds.blob is not None:
            t_a = uid_a / max(ds.num_imgs - 1, 1)
            t_b = uid_b / max(ds.num_imgs - 1, 1)
            delta = blob_offset(t_b) - blob_offset(t_a)
            dyn = (~motion).reshape(-1)
            pw = pw + dyn[:, None] * delta[None]
        pb = pw @ T_b[:3, :3].T + T_b[:3, 3]
        zb = np.maximum(pb[:, 2], 1e-6)
        ub = ds.fx * pb[:, 0] / zb + ds.cx
        vb = ds.fy * pb[:, 1] / zb + ds.cy
        flow = np.stack([ub - u.reshape(-1), vb - v.reshape(-1)], -1)
        flow = flow.reshape(h, w, 2).astype(np.float32)
        flow[depth <= 0] = 0.0
        return flow

    def __call__(self, uid1: int, uid2: int):
        return self._flow(uid2, uid1), self._flow(uid1, uid2)
