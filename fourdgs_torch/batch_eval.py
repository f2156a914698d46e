"""Multi-sequence batch evaluation (counterpart of scripts/batch_eval.py):

    python -m fourdgs_torch.batch_eval --configs configs/rgbd/tum/*.yaml \
        [--frames N] [--interval N] [--dynamic] [--out DIR] [--device cuda|cpu]
    python -m fourdgs_torch.batch_eval --synthetic 3 --frames 20

Runs SLAM over each config (and, with `--synthetic K`, over K synthetic
sequences seeded 0..K-1 at 80x60) and writes one row per sequence, with
the keys sequence, fps, ate_rmse, psnr, ssim, l1_depth and n_gaussians, to
`<out>/summary.json`; each run's artifacts go to `<out>/<sequence>/`. It
runs on the CUDA card unless `--device cpu` is given; without a card it
exits non-zero. `main(argv)` returns the rows.
"""

from __future__ import annotations

import argparse
import json
import os

from fourdgs_torch.device import resolve_device
from fourdgs_torch.utils.config import ConfigDict, load_config
from fourdgs_torch.utils.logging import Log


def synthetic_config(num_frames: int = 15, w: int = 80, h: int = 60) -> ConfigDict:
    """The small static synthetic configuration the reference's batch
    evaluation takes from its end-to-end test."""
    return ConfigDict.wrap({
        "Results": {"save_results": False, "use_gui": False, "eval_rendering": True},
        "Dataset": {
            "type": "synthetic", "sensor_type": "depth", "dataset_path": "",
            "num_frames": num_frames, "points_per_wall": 1500, "pcd_downsample": 16,
            "pcd_downsample_init": 8, "adaptive_pointsize": True, "point_size": 0.05,
            "Calibration": {"fx": 80.0, "fy": 80.0, "cx": (w - 1) / 2, "cy": (h - 1) / 2,
                            "width": w, "height": h, "depth_scale": 1.0, "distorted": False},
        },
        "Training": {
            "init_itr_num": 40, "init_gaussian_update": 30, "init_gaussian_reset": 2000,
            "init_gaussian_th": 0.005, "init_gaussian_extent": 30, "tracking_itr_num": 30,
            "mapping_itr_num": 15, "keyframe_mapping_iters": 15,
            "gaussian_update_every": 10000, "gaussian_update_offset": 50, "gaussian_th": 0.7,
            "gaussian_extent": 1.0, "gaussian_reset": 20001, "size_threshold": 20,
            "kf_interval": 5, "window_size": 3, "pose_window": 2, "edge_threshold": 1.1,
            "rgb_boundary_threshold": 0.01, "alpha": 0.9, "kf_translation": 0.08,
            "kf_min_translation": 0.05, "kf_overlap": 0.9, "kf_cutoff": 0.3,
            "single_thread": True, "monocular": False,
            "lr": {"cam_rot_delta": 0.003, "cam_trans_delta": 0.001},
        },
        "opt_params": {"densify_grad_threshold": 0.0002},
        "model_params": {"sh_degree": 0, "dynamic_model": False},
    })


def run_one(config, name: str, args, device) -> dict:
    from fourdgs_torch.slam.runner import SLAM

    save_dir = os.path.join(args.out, name)
    os.makedirs(save_dir, exist_ok=True)
    slam = SLAM(config, save_dir=save_dir, save_interval=args.interval, dynamic=args.dynamic,
                max_frames=args.frames, device=device)
    metrics = slam.run()
    ate = slam.eval_ate("batch")
    rend = slam.eval_rendering("batch", interval=max(args.interval, 1))
    row = {
        "sequence": name,
        "fps": round(metrics["fps"], 4),
        "ate_rmse": round(ate["rmse"], 5),
        "psnr": rend["mean_psnr"],
        "ssim": rend["mean_ssim"],
        "l1_depth": rend["mean_l1_depth"],
        "n_gaussians": metrics["n_gaussians"],
    }
    Log(f"{name}: {row}", tag="Eval")
    return row


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description="batch evaluation (PyTorch/CUDA port)")
    ap.add_argument("--configs", nargs="*", default=[])
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--interval", type=int, default=5)
    ap.add_argument("--dynamic", action="store_true")
    ap.add_argument("--out", default="results/batch_eval")
    ap.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"fourdgs_torch.batch_eval: {e}") from e

    rows = []
    for path in args.configs:
        cfg = load_config(path)
        cfg["Results"]["save_results"] = True
        rows.append(run_one(cfg, os.path.splitext(os.path.basename(path))[0], args, device))
    for i in range(args.synthetic):
        cfg = synthetic_config(num_frames=args.frames or 15)
        cfg["Dataset"]["seed"] = i
        rows.append(run_one(cfg, f"synthetic_{i}", args, device))

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(rows, f, indent=2)
    print(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    main()
