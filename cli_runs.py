#!/usr/bin/env python3
"""Runs of the command line on chip_smoke.py's cli-phase sequence on one
NVIDIA GPU, in variants, to see what sets the keyframes' camera errors.

    python3 cli_runs.py [--json PATH] [--frames N] [--scale S] [--strides P] \
        [--iters F] [--capacity C] VARIANT [VARIANT ...]

Each VARIANT runs `fourdgs_torch.cli.main` without `--eval` on the
44-frame 640x480 dynamic synthetic sequence in TUM layout with the config
of chip_smoke.py phase 7 (configs/rgbd/tum/base_config.yaml, dystart 8),
or a reduced one: its first N frames (the camera and the blob move as much
per frame), at S times the resolution and the intrinsics, the pixel
strides of the points that spawn Gaussians times P, the iterations per
tracked frame and per keyframe phase (chip_smoke.ITER_KEYS) divided by F,
from a map capacity of C (2^15 unless asked; it grows as the map fills):
  dynamic       --dynamic, as chip_smoke.py runs it
  static        without --dynamic: static mapping, the segmenter's masks
                kept out of its loss
  no_segmenter  --dynamic with model_params.dynamic_model false: no
                segmenter, every pixel static
  static_scene  without --dynamic, on the same sequence without the moving
                blob
  no_segmenter_scene  no_segmenter on the sequence without the blob
and prints one JSON line per run: ATE, keyframes, the pixels segmented
dynamic per frame, each frame's camera-centre error and estimated and true
world-to-camera pose, and for each keyframe's mapping phase the window's
errors before and after it. A run is causal, so the first k frames of a
run are those of a k-frame run of the same sequence.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
VARIANTS = {   # command-line flags, config lines and the blob of each variant
    "dynamic": (["--dynamic"], "", True),
    "static": ([], "", True),
    "no_segmenter": (["--dynamic"], "model_params:\n  dynamic_model: false\n", True),
    "static_scene": ([], "", False),
    "no_segmenter_scene": (["--dynamic"], "model_params:\n  dynamic_model: false\n", False),
}


def trace_mapping_phases(slam_cls) -> list:
    """Record, for every keyframe mapping phase of the SLAM runs that follow,
    the window's camera errors before and after it."""
    import chip_smoke as CS

    phases = []
    for name in ("_run_mapping", "_run_mapping_dynamic"):
        original = getattr(slam_cls, name)

        def traced(self, *a, _original=original, _name=name, **k):
            window = list(self.window)
            before = CS.centre_errors_mm(self, window)
            _original(self, *a, **k)
            phases.append({"phase": _name, "keyframe": window[0],
                           "centre_err_mm_before": before,
                           "centre_err_mm_after": CS.centre_errors_mm(self, window)})

        setattr(slam_cls, name, traced)
    return phases


def run(variant: str, tmp: str, frames: int, scale: float, strides: float,
        iters: int, capacity: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke as CS
    from fourdgs_torch import cli
    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.slam.runner import SLAM

    flags, extra, blob = VARIANTS[variant]
    frames = frames or CS.CLI_FRAMES
    cfg = CS.write_cli_sequence(tmp, extra, blob, frames=frames, scale=scale, strides=strides,
                                iters=iters)
    phases = trace_mapping_phases(SLAM)
    with CS.observe_stages(SLAM, {}) as seen:
        t = time.time()
        cli.main(["--config", cfg, "--capacity", str(capacity or KC.CAPACITY)] + flags)
        torch.cuda.synchronize()
        seconds = time.time() - t
    slam = seen["slams"][0]
    shutil.rmtree(slam.save_dir, ignore_errors=True)
    with contextlib.suppress(OSError):
        os.rmdir(os.path.dirname(slam.save_dir))   # the results directory, if now empty
    masks = slam.dataset.dynamic_masks
    return {"variant": variant, "frames": frames, "scale": scale, "strides": strides,
            "iters": iters, "capacity": capacity or KC.CAPACITY,
            "size": [slam.intr.width, slam.intr.height], "ate_rmse_m": slam.eval_ate()["rmse"],
            "keyframes": list(slam.kf_indices), "deform_init": slam.deform_init,
            "dynamic_px_per_frame": [int(masks[i].sum()) for i in sorted(masks)],
            "centre_err_mm": CS.centre_errors_mm(slam), "mapping_phases": phases,
            "poses_est": {i: slam.poses_est[i].tolist() for i in sorted(slam.poses_est)},
            "poses_gt": {i: np.asarray(slam.dataset.poses[i]).tolist() for i in sorted(slam.poses_est)},
            "seconds": seconds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", help="also write the runs to this file")
    ap.add_argument("--frames", type=int, help="frames of the sequence run (all 44 if not given)")
    ap.add_argument("--scale", type=float, default=1.0, help="of 640x480 and the intrinsics")
    ap.add_argument("--strides", type=float, default=1.0, help="of the point strides")
    ap.add_argument("--iters", type=int, default=1, help="divides the iteration counts")
    ap.add_argument("--capacity", type=int, help="of the map at the start (2^15 if not given)")
    ap.add_argument("variants", nargs="+", choices=sorted(VARIANTS))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("cli_runs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.chdir(HERE)   # the config's inherit_from and save_dir are relative to it
    import chip_smoke as CS
    from fourdgs_torch.slam.runner import SLAM

    runs = []
    originals = {n: getattr(SLAM, n) for n in ("_run_mapping", "_run_mapping_dynamic")}
    for variant in args.variants:
        tmp = tempfile.mkdtemp(prefix="fourdgs_cli_runs_")
        try:
            runs.append(run(variant, tmp, args.frames, args.scale, args.strides, args.iters,
                            args.capacity))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            for n, fn in originals.items():
                setattr(SLAM, n, fn)
        print(json.dumps(runs[-1]), flush=True)
        CS.log(f"{variant}: ATE {runs[-1]['ate_rmse_m'] * 1e3:.2f} mm, "
               f"{runs[-1]['seconds']:.0f} s")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
