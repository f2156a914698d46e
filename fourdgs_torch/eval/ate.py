"""Absolute trajectory error and trajectory artifacts (port of
fourdgs/eval/ate.py).

`evaluate_ate` aligns estimated and ground-truth camera centres with
Horn's closed-form rotation (no scale) and reports the RMSE; the runner
calls it, and `save_trajectory`, without scale on monocular runs too, as
the reference does (`evaluate_evo(monocular=True)` is the Sim(3) APE);
`save_trajectory` also writes `pose.txt`, `plot/ATE_<label>.json`, the
evo-style APE statistics `plot/stats_<label>.json` and the per-frame
trajectories `plot/trj_<label>.json`. Plots are drawn only where
matplotlib imports.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fourdgs_torch.geometry.quaternion import rotmat_to_quat


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


def _centers(poses) -> np.ndarray:
    """(3, N) camera centres of world-to-camera poses."""
    return np.stack([-T[:3, :3].T @ T[:3, 3] for T in poses], axis=1)


def evaluate_ate(poses_est: list[np.ndarray], poses_gt: list[np.ndarray]) -> dict:
    """Poses are world-to-camera 4x4; compares camera centers."""
    _, _, trans_error = align_horn(_centers(poses_est), _centers(poses_gt))
    return {
        "compared_pose_pairs": int(trans_error.shape[0]),
        "rmse": float(np.sqrt(np.mean(trans_error**2))),
        "mean": float(np.mean(trans_error)),
        "median": float(np.median(trans_error)),
        "std": float(np.std(trans_error)),
        "min": float(np.min(trans_error)),
        "max": float(np.max(trans_error)),
    }


def umeyama_alignment(model: np.ndarray, data: np.ndarray, with_scale: bool = False):
    """Umeyama alignment of (3, N) point sets: (rot, trans, scale)
    minimizing ||scale * rot @ model + trans - data||^2, the scale 1 unless
    `with_scale` (monocular)."""
    mu_m = model.mean(1, keepdims=True)
    mu_d = data.mean(1, keepdims=True)
    model_zero = model - mu_m
    n = model.shape[1]
    U, d, Vt = np.linalg.svd((data - mu_d) @ model_zero.T / n)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vt
    scale = float(np.trace(np.diag(d) @ S) / ((model_zero**2).sum() / n)) if with_scale else 1.0
    return rot, mu_d - scale * rot @ mu_m, scale


def _plot(draw, path: str) -> None:
    """Draw a figure with `draw(fig, ax)` into `path` where matplotlib
    imports; nothing otherwise."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(6, 6))
    draw(fig, ax)
    fig.savefig(path, dpi=90)
    plt.close(fig)


def evaluate_evo(poses_gt: list[np.ndarray], poses_est: list[np.ndarray], plot_dir: str,
                 label: str = "final", monocular: bool = False) -> float:
    """evo-style APE of camera-to-world poses: Umeyama-align the estimate to
    the ground truth (with scale when `monocular`), take the translation
    errors, write `stats_<label>.json` (and a plot). Returns the RMSE."""
    t_gt = np.stack([T[:3, 3] for T in poses_gt], axis=1)
    t_est = np.stack([T[:3, 3] for T in poses_est], axis=1)
    rot, trans, scale = umeyama_alignment(t_est, t_gt, with_scale=monocular)
    t_al = scale * rot @ t_est + trans
    err = np.linalg.norm(t_gt - t_al, axis=0)
    stats = {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(np.mean(err)),
        "median": float(np.median(err)),
        "std": float(np.std(err)),
        "min": float(np.min(err)),
        "max": float(np.max(err)),
        "sse": float(np.sum(err**2)),
    }
    os.makedirs(plot_dir, exist_ok=True)
    with open(os.path.join(plot_dir, f"stats_{label}.json"), "w") as f:
        json.dump(stats, f, indent=4)

    def draw(fig, ax):
        ax.set_title(f"ATE RMSE: {stats['rmse']:.5f}")
        ax.plot(t_gt[0], t_gt[1], "--", color="gray", label="gt")
        sc = ax.scatter(t_al[0], t_al[1], c=err, cmap="jet", s=4, label="est")
        fig.colorbar(sc, ax=ax, label="APE [m]")
        ax.legend()
        ax.set_aspect("equal", adjustable="datalim")

    _plot(draw, os.path.join(plot_dir, f"evo_2dplot_{label}.png"))
    return stats["rmse"]


def write_trj_json(poses_est: list[np.ndarray], poses_gt: list[np.ndarray],
                   frame_ids: list[int], plot_dir: str, label: str = "final") -> None:
    """`trj_<label>.json`: frame ids and camera-to-world matrices of the
    estimate and the ground truth."""
    trj = {
        "trj_id": [int(i) for i in frame_ids],
        "trj_est": [np.linalg.inv(T).tolist() for T in poses_est],
        "trj_gt": [np.linalg.inv(T).tolist() for T in poses_gt],
    }
    os.makedirs(plot_dir, exist_ok=True)
    with open(os.path.join(plot_dir, f"trj_{label}.json"), "w") as f:
        json.dump(trj, f, indent=4)


def save_trajectory(poses_est: list[np.ndarray], poses_gt: list[np.ndarray],
                    frame_ids: list[int], save_dir: str, label: str = "final",
                    plot: bool = True) -> dict:
    """`pose.txt` (id tx ty tz qx qy qz qw of camera-to-world), the ATE and
    APE statistics and the trajectories under `plot/`; returns the ATE
    statistics with `ape_rmse`."""
    plot_dir = os.path.join(save_dir, "plot")
    os.makedirs(plot_dir, exist_ok=True)
    lines = []
    for fid, T in zip(frame_ids, poses_est):
        T_wc = np.linalg.inv(T)
        q = rotmat_to_quat(torch.as_tensor(T_wc[:3, :3], dtype=torch.float32)).numpy()
        t = T_wc[:3, 3]
        lines.append(f"{fid} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                     f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")
    with open(os.path.join(save_dir, "pose.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

    stats = evaluate_ate(poses_est, poses_gt)
    with open(os.path.join(plot_dir, f"ATE_{label}.json"), "w") as f:
        json.dump(stats, f, indent=4)
    ape_rmse = evaluate_evo([np.linalg.inv(T) for T in poses_gt],
                            [np.linalg.inv(T) for T in poses_est], plot_dir, label)
    stats = dict(stats, ape_rmse=ape_rmse)
    write_trj_json(poses_est, poses_gt, frame_ids, plot_dir, label)

    if plot:
        ce, cg = _centers(poses_est), _centers(poses_gt)
        rot, trans, _ = align_horn(ce, cg)
        ce_al = rot @ ce + trans

        def draw(fig, ax):
            ax.plot(cg[0], cg[2], "k--", label="gt")
            ax.plot(ce_al[0], ce_al[2], "b-", label="est (aligned)")
            ax.legend()
            ax.set_title(f"ATE RMSE {stats['rmse']:.4f} m")

        _plot(draw, os.path.join(plot_dir, f"ATE_{label}.png"))
    return stats
