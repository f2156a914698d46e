"""Command line of the port (counterpart of slam.py):

    python -m fourdgs_torch.cli --config configs/rgbd/tum/fr3_walking_xyz.yaml \
        [--eval] [--dynamic] [--interval N] [--max-frames N] [--capacity N] \
        [--checkpoint PATH] [--resume PATH] [--device cuda|cpu]

It runs on the CUDA card unless `--device cpu` is given; without a card it
exits non-zero. With `Results.save_results` (forced by `--eval`) the run
writes `<save_dir>/<config name>_<timestamp>/`: `config.yml`, the
trajectory (`pose.txt`, `plot/`), and `point_cloud/<label>/point_cloud.ply`.
`--eval` then evaluates the renders (`psnr/before_opt/`), refines colour
for `Training.refinement_iters` iterations (1500 by default) and
evaluates again (`psnr/after_opt/`); `--interval` strides the image
dumps. `--checkpoint` saves the whole state
after the run, `--resume` loads one before it. With `Results.use_wandb`,
`--eval` also logs the final metrics table to wandb, its FPS the run's
`fps_steady` where it has one, else `fps`. `main(argv)` returns the
metrics.
"""

from __future__ import annotations

import argparse
import os
import time

import yaml

from fourdgs_torch.device import resolve_device
from fourdgs_torch.utils.config import load_config
from fourdgs_torch.utils.logging import Log


def _wandb_table(wandb, before: dict, after: dict, ate_rmse: float, fps: float):
    """The final metrics table: one row each before and after refinement.
    A failing wandb is logged and the run goes on."""
    try:
        table = wandb.Table(columns=["tag", "psnr", "ssim", "lpips", "RMSE ATE", "FPS"])
        for tag, r in (("Before", before), ("After", after)):
            table.add_data(tag, r["mean_psnr"], r["mean_ssim"], r["mean_lpips"], ate_rmse, fps)
        wandb.log({"Metrics": table})
    except Exception as e:
        Log(f"wandb metrics table failed: {e}")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="4DGS-SLAM (PyTorch/CUDA port)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--dynamic", action="store_true")
    parser.add_argument("--interval", type=int, default=50)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--capacity", type=int, default=1 << 14)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="save the whole state here after the run")
    parser.add_argument("--resume", type=str, default=None,
                        help="load the whole state from a checkpoint before the run")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"fourdgs_torch.cli: {e}") from e

    config = load_config(args.config)
    if args.eval:
        config["Results"]["save_results"] = True
        config["Results"]["use_gui"] = False
        config["Results"]["eval_rendering"] = True

    save_dir = None
    if config["Results"].get("save_results", False):
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        name = os.path.splitext(os.path.basename(args.config))[0]
        save_dir = os.path.join(config["Results"]["save_dir"], f"{name}_{stamp}")
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "config.yml"), "w") as f:
            yaml.safe_dump(config.to_plain(), f)

    from fourdgs_torch.slam.runner import SLAM

    # the with block keeps a mesh (Training.mesh_devices) open from the run
    # through colour refinement, and closes it at the end or on an error
    with SLAM(config, save_dir=save_dir, save_interval=args.interval, dynamic=args.dynamic,
              max_frames=args.max_frames, capacity=args.capacity, device=device) as slam:
        if args.resume:
            slam.load_checkpoint(args.resume)
            Log(f"Resumed from {args.resume} (iteration {slam.iteration_count})")
        metrics = slam.run()
        if args.checkpoint:
            slam.save_checkpoint(args.checkpoint)
            Log(f"Checkpoint saved to {args.checkpoint}")

        if config["Results"].get("eval_rendering", False):
            ate = slam.eval_ate("final")
            Log(f"ATE RMSE: {ate['rmse']:.4f} m", tag="Eval")
            # metrics over every frame; --interval strides the image dumps only
            before = slam.eval_rendering("before_opt")
            Log(f"before_opt: {before}", tag="Eval")
            slam.save("final_before_opt")
            slam.color_refinement(int(config["Training"].get("refinement_iters", 1500)))
            after = slam.eval_rendering("after_opt")
            Log(f"after_opt: {after}", tag="Eval")
            metrics.update({"ate_rmse": ate["rmse"], "psnr_before": before["mean_psnr"],
                            "psnr_after": after["mean_psnr"], "ssim_after": after["mean_ssim"],
                            "l1_depth_after": after["mean_l1_depth"],
                            "lpips_before": before["mean_lpips"],
                            "lpips_after": after["mean_lpips"]})
            if slam._wandb is not None:
                _wandb_table(slam._wandb, before, after, ate["rmse"],
                             metrics.get("fps_steady", metrics.get("fps")))
        slam.save("final")
    Log(f"Done. metrics={metrics}")
    return metrics


if __name__ == "__main__":
    main()
