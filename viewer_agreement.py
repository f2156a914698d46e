#!/usr/bin/env python3
"""The live viewer's renders on one NVIDIA GPU against the same renders of
a CPU copy of the map, over many orbits: how far the two devices' float32
paths part, and why (chip_smoke.py phase 14 holds one orbit).

    python3 viewer_agreement.py [--orbits N] [--json PATH]

Runs chip_smoke.py phase 5's SLAM (10 frames of bench.py's sequence at
640x480), then renders the viewer's current view and N novel views (x in
-0.1..0.1, yaw -60..60 degrees) at its last frame through
`fourdgs_torch.gui.viewer.render_views` on the card and on a CPU copy of
the map. Prints one JSON line per view: the share of pixels within
chip_smoke.RENDER_TOL and the largest difference (colour, depth), the
largest difference of the colour in 8-bit levels, the Gaussians applied
at a different number of pixels on the two devices (n_touched), the
largest relative difference of the compositor's input fields, the
largest difference of the card's compositor outputs from the plain
version on CPU copies of the same inputs, and those outputs held against
the plain version on the card (chip_smoke._same_inputs); then a summary
line and the card's name and power limit. About 3 minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import types


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--orbits", type=int, default=15)
    ap.add_argument("--json", help="also write every line to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("viewer_agreement: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as CS
    from fourdgs_torch import convert
    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.gui import viewer as V
    from fourdgs_torch.ops.rasterize import compositor as C
    from fourdgs_torch.ops.rasterize import kernels as K
    from fourdgs_torch.slam.runner import SLAM

    K.build()
    slam = SLAM(KC.bench_config(40), max_frames=10, capacity=KC.CAPACITY,
                max_capacity=KC.CAPACITY, max_keyframes=64)
    slam.run()
    cpu = types.SimpleNamespace(
        gmap=convert.gaussian_map_from_arrays(convert.gaussian_map_to_arrays(slam.gmap), "cpu"),
        poses_est=slam.poses_est, intr=slam.intr, map_cfg=slam.map_cfg,
        kf_indices=slam.kf_indices, device=torch.device("cpu"))
    frame = max(slam.poses_est)
    T = np.asarray(slam.poses_est[frame], np.float32)

    calls = []
    composite_forward = C.composite_forward

    def recording(fields, bins, grid):
        out = composite_forward(fields, bins, grid)
        calls.append((fields, bins, grid, out))
        return out

    C.composite_forward = recording
    rows = []
    n = max(args.orbits, 1)
    for i in range(n):
        f = i / max(n - 1, 1)
        orbit = np.asarray([0.1 * ((i % 3) - 1), -0.05, 0.0, 0.0,
                            np.deg2rad(-60.0 + 120.0 * f), 0.0], np.float32)
        t = time.time()
        calls.clear()
        card = V.render_views(slam, T, orbit)
        card_calls = list(calls)
        calls.clear()
        host = V.render_views(cpu, T, orbit)
        host_calls = list(calls)
        for v, name in enumerate(("current", "novel")):
            if name == "current" and i > 0:
                continue   # the same view at every orbit
            a, b = card[v], host[v]
            fk, fh = card_calls[v][0].cpu(), host_calls[v][0]
            bins, grid, got = card_calls[v][1:]
            plain = C.composite_forward_plain(fk, type(bins)(*(x.cpu() for x in bins)), grid)[0]
            d = (got[0].cpu() - plain).abs()
            row = {"orbit": orbit.tolist(), "view": name,
                   "color": CS._agree(a.color, b.color, CS.RENDER_TOL["color"]),
                   "depth": CS._agree(a.depth, b.depth, CS.RENDER_TOL["depth"]),
                   "png_levels": CS._png_levels(a.color, b.color),
                   "n_touched_differs": int((a.n_touched.cpu() != b.n_touched).sum()),
                   "fields_max_rel": float(((fk - fh).abs() / fh.abs().clamp(min=1e-6)).max()),
                   "cpu_plain_same_inputs": {"color": float(d[:, :3].max()),
                                             "depth": float(d[:, 3].max()),
                                             "T_final": float(d[:, 4].max())},
                   "same_inputs": CS._same_inputs([card_calls[v]]),
                   "seconds": time.time() - t}
            rows.append(row)
            print(json.dumps(row), flush=True)
    C.composite_forward = composite_forward
    outside = [r for r in rows if r["color"]["within"] < 1.0 or r["depth"]["within"] < 1.0]
    summary = {"views": len(rows), "views_outside_render_tol": len(outside),
               "views_with_n_touched_differing": sum(r["n_touched_differs"] > 0 for r in rows),
               "outside_with_n_touched_differing": sum(r["n_touched_differs"] > 0
                                                       for r in outside),
               "min_within": min(min(r["color"]["within"], r["depth"]["within"]) for r in rows),
               "color_max_abs": max(r["color"]["max_abs"] for r in rows),
               "depth_max_abs": max(r["depth"]["max_abs"] for r in rows),
               "png_levels": max(r["png_levels"] for r in rows),
               "fields_max_rel": max(r["fields_max_rel"] for r in rows),
               "cpu_plain_same_inputs": {k: max(r["cpu_plain_same_inputs"][k] for r in rows)
                                         for k in ("color", "depth", "T_final")},
               "same_inputs_ok": all(r["same_inputs"]["ok"] for r in rows)}
    print(json.dumps(summary), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "views": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
