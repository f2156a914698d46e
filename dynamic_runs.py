#!/usr/bin/env python3
"""Runs of chip_smoke.py's 4D phase on one NVIDIA GPU, as it is and in
variants, to measure the spread of its quality and what drives the
keyframe poses of its 4D mapping phases.

    python3 dynamic_runs.py [--json PATH] VARIANT [VARIANT ...]

Each VARIANT runs SLAM(dynamic=True) at the `bench.py --dynamic`
configuration on 15 of its 40 frames, as chip_smoke.py phase 6 does; name
a variant twice to run it twice, and join changes with "+"
(`reference_payload_camera+no_densify`):
  base        the configuration and the port as they are
  no_flow     flow weights 0: no flow loss in 4D mapping
  no_densify  no densify after the 4D keyframe phases
  reference_payload_camera
              the flow payloads projected through the live view cameras,
              as the reference does, so that the flow loss also reaches a
              view's pose through its payload (the port holds that
              camera constant: slam/mapping_dynamic.py `_payload_camera`)
and prints one JSON line per run: ATE, PSNR, the dynamic Gaussians spawned
and alive at the end, each frame's camera-centre error and, for each 4D
keyframe phase, the window's errors before and after it and the dynamic
Gaussians alive after its densify.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHANGES = {   # configuration changes of each variant
    "base": {},
    "no_flow": {"flow_loss": 0, "flow_loss_fine": 0},
    "no_densify": {"gaussian_update_every": 1 << 30},
    "reference_payload_camera": {},
}
N_FRAMES = 15


def run(variant: str) -> dict:
    import torch

    import chip_smoke as CS
    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.slam import mapping_dynamic as mdyn
    from fourdgs_torch.slam.runner import SLAM

    parts = variant.split("+")
    cfg = KC.bench_dynamic_config(40)
    for part in parts:
        cfg["Training"].update(CHANGES[part])
    t = time.time()
    slam = SLAM(cfg, dynamic=True, max_frames=N_FRAMES, capacity=KC.CAPACITY,
                max_capacity=KC.CAPACITY, max_keyframes=64)
    phases = CS.trace_dynamic_phases(slam)
    payload_camera = mdyn._payload_camera
    if "reference_payload_camera" in parts:
        mdyn._payload_camera = lambda T_view: T_view
    try:
        metrics = slam.run()
    finally:
        mdyn._payload_camera = payload_camera
    rend = slam.eval_rendering()
    out = {"variant": variant, "ate_rmse_m": slam.eval_ate()["rmse"],
           "psnr": rend["mean_psnr"], "keyframes": list(slam.kf_indices),
           "dynamic_spawned": metrics.get("dygs_spawned", 0),
           "dynamic_alive": int((slam.gmap.dygs & slam.gmap.alive).sum()),
           "centre_err_mm": CS.centre_errors_mm(slam), "phases_4d": phases,
           "seconds": time.time() - t}
    del slam
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("variants", nargs="+", metavar="VARIANT")
    ap.add_argument("--json", help="also write the runs to this file")
    args = ap.parse_args()
    for v in args.variants:
        if not set(v.split("+")) <= set(CHANGES):
            ap.error(f"unknown variant {v!r}: join names of {sorted(CHANGES)} with '+'")

    import torch

    if not torch.cuda.is_available():
        print("dynamic_runs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for v in args.variants:
        runs.append(run(v))
        print(json.dumps(runs[-1]), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
