#!/usr/bin/env python3
"""chip_smoke.py's multi-device phase alone, on one NVIDIA GPU (or two).

    python3 mesh_runs.py [--json PATH]

Builds the compositor kernels, holds them against their plain versions
at each rank's block of the full 4D window (chip_smoke.py phase 3 at
`mesh_blocks()`), then runs chip_smoke.py phase 13: the static and 4D
windows on a 2-rank mesh against one device, the 4D window timed at 1
and MESH_DYN_ITERS iterations with each mesh call's seconds, and phase
5's 10-frame run on the mesh. Prints phase 13's lines as chip_smoke.py
does, and exits non-zero where chip_smoke.py would. About 2.5 minutes
on an H100.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", help="also write every measurement to this file")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as C
    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.ops.rasterize import kernels as K

    K.build()
    slam, frames = KC.sample_map()
    held = set(C.VIEWS)
    record = {"compare": {}}
    for views, n_flow in C.mesh_blocks():
        r = C.compare_kernels(slam, views, seed=views + n_flow, n_flow=n_flow)
        record["compare"][f"{views}_{n_flow}flow"] = r
        C.log(f"compare {views} views ({n_flow} flow): " + json.dumps(r))
        if not r["ok"]:
            raise SystemExit(f"kernel disagrees with its plain version at {views} views")
        held.add(views)
    del slam, frames
    wrappers = {"composite_fwd": K.composite_fwd, "composite_bwd": K.composite_bwd}
    t = time.time()
    record["mesh"] = C.mesh_phase(wrappers, held)
    C.log(f"phase mesh: {time.time() - t:.1f}s")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
