#!/usr/bin/env python3
"""chip_smoke.py's multi-device phase alone, on one NVIDIA GPU (or two).

    python3 mesh_runs.py [--json PATH] [--spread N]

Builds the compositor kernels, holds them against their plain versions
at each rank's block of the full 4D window (chip_smoke.py phase 3 at
`mesh_blocks()`), then runs chip_smoke.py phase 13: the static and 4D
windows on a 2-rank mesh against one device, the 4D window timed at 1
and MESH_DYN_ITERS iterations with each mesh call's seconds, and phase
5's 10-frame run on the mesh. Prints phase 13's lines as chip_smoke.py
does, and exits non-zero where chip_smoke.py would. About 2.5 minutes
on an H100.

With `--spread N` it runs instead phase 13's static chunk of MESH_ITERS
iterations from the same state N times on one device and twice on the
2-rank mesh, and prints each run's largest differences (chip_smoke.py
`_map_diffs`) from the first one-device run, and the second mesh run's
from the first: how far the chunk differs from itself on one device (the
backward's float atomics sum in a different order each run, and Adam
grows the rounding) beside how far the mesh differs from one device.
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
    ap.add_argument("--spread", type=int, default=0, metavar="N",
                    help="one-device runs of the static chunk to compare (at least 2)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as C
    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.ops.rasterize import kernels as K

    K.build()
    if args.spread:
        record = {"spread": spread(C, args.spread)}
        C.log("spread: " + json.dumps(record["spread"]))
        write(args.json, record)
        return 0
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
    write(args.json, record)
    return 0


def spread(C, n: int) -> dict:
    """The static chunk of C.MESH_ITERS iterations from one state: `n` runs
    on one device, 2 on the mesh; their differences."""
    from fourdgs_torch.parallel import make_mesh

    slam, _ = C.mesh_state(dynamic=False)
    ones = [C.mesh_static_chunk(slam, C.MESH_ITERS, None)[0] for _ in range(max(n, 2))]
    with make_mesh(C.MESH_RANKS, ["cuda:0"] * C.MESH_RANKS) as mesh:
        meshes = [C.mesh_static_chunk(slam, C.MESH_ITERS, mesh)[0] for _ in range(2)]
    return {"iters": C.MESH_ITERS,
            "one_device_vs_first": [C._map_diffs(r, ones[0]) for r in ones[1:]],
            "mesh_vs_first_one_device": [C._map_diffs(r, ones[0]) for r in meshes],
            "mesh_vs_mesh": C._map_diffs(meshes[1], meshes[0])}


def write(path, record):
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=1, default=str)


if __name__ == "__main__":
    sys.exit(main())
