"""A cell cut to a size the CPU runs in seconds, for the benchmark's own
tests: 160x120 (intrinsics scaled), a sparse room, few iterations."""

from __future__ import annotations


def shrink(cfg: dict, mix: dict, slam_kw: dict) -> None:
    cal = cfg["Dataset"]["Calibration"]
    for k in ("fx", "fy", "cx", "cy"):
        cal[k] = float(cal[k]) / 4.0
    cal["width"], cal["height"] = 160, 120
    tr = cfg["Training"]
    tr.update(init_itr_num=30, init_gaussian_update=10, init_gaussian_reset=20,
              tracking_itr_num=12, keyframe_mapping_iters=12)
    cfg["Dataset"]["pcd_downsample"] = 8
    cfg["Dataset"]["pcd_downsample_init"] = 4
    cfg.setdefault("ModelHiddenParams", {})["node_num"] = 64
    mix["points_per_wall"] = 300
    mix["frames"] = min(int(mix["frames"]), 40)
    slam_kw.update(capacity=4096, max_capacity=8192, max_keyframes=16)
