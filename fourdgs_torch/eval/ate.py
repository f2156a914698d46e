"""Absolute trajectory error: Horn alignment + RMSE (port of
`align_horn` and `evaluate_ate` in fourdgs/eval/ate.py)."""

from __future__ import annotations

import numpy as np


def align_horn(model: np.ndarray, data: np.ndarray):
    """Align two (3, N) trajectories: rot, trans minimizing
    ||rot @ model + trans - data||^2 (no scale)."""
    model_zero = model - model.mean(1, keepdims=True)
    data_zero = data - data.mean(1, keepdims=True)
    W = model_zero @ data_zero.T
    U, _, Vt = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vt
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    err = rot @ model + trans - data
    return rot, trans, np.sqrt(np.sum(err * err, axis=0))


def evaluate_ate(poses_est: list[np.ndarray], poses_gt: list[np.ndarray]) -> dict:
    """Poses are world-to-camera 4x4; compares camera centers."""
    def centers(poses):
        return np.stack([-T[:3, :3].T @ T[:3, 3] for T in poses], axis=1)

    _, _, trans_error = align_horn(centers(poses_est), centers(poses_gt))
    return {
        "compared_pose_pairs": int(trans_error.shape[0]),
        "rmse": float(np.sqrt(np.mean(trans_error**2))),
        "mean": float(np.mean(trans_error)),
        "median": float(np.median(trans_error)),
        "std": float(np.std(trans_error)),
        "min": float(np.min(trans_error)),
        "max": float(np.max(trans_error)),
    }
