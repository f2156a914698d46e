#!/usr/bin/env python3
"""Time versions of the port's compositor kernels against each other on one
NVIDIA GPU, in turns, on chip_smoke.py's phase-3 inputs (640x480, 1, 2 and
10 views of the map after 100 initialisation iterations).

    python3 compositor_ab.py NAME=CSRC_DIR [NAME=CSRC_DIR ...] [--json PATH]

Each CSRC_DIR is laid out like fourdgs_torch/ops/rasterize/csrc, with the
C interface that fourdgs_torch/ops/rasterize/kernels.py loads (an earlier
commit's comes from `git archive`). Every version is built as the port
builds its own (kernels.build) and its ptxas report printed, then held
against the plain torch versions by kernel_check.hold, the criterion
chip_smoke.py applies; the script exits 1 if any version fails it. Then
the versions are timed round by round, the order reversed every other
round (a b b a ...), each time as CUDA events over 50 back-to-back
launches of the kernel alone into buffers allocated beforehand (no
allocation or zero fill in the time). Prints one JSON line per (version,
views) with the median and every round's time, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROUNDS = 10
REPS = 50
VIEWS = (1, 2, 10)


class Case:
    """One shape's inputs, the plain results, and output buffers that the
    kernels are launched into."""

    def __init__(self, fields, bins, grid, seed: int):
        import torch

        from fourdgs_torch import kernel_check as KC
        from fourdgs_torch.ops.rasterize import compositor as C

        self.grid = grid
        dev = fields.device
        vt = bins.tile_start.shape[0]
        self.out = torch.empty((vt, C.NOUT, C.NPIX), dtype=torch.float32, device=dev)
        self.n_contrib = torch.empty((vt, C.NPIX), dtype=torch.int32, device=dev)
        self.n_touched = torch.zeros(fields.shape[:2], dtype=torch.int32, device=dev)
        self.dfields = torch.zeros_like(fields)
        self.ref = KC.reference(fields, bins, grid, seed)
        self.args = (fields, bins.pair_gid, bins.tile_start, bins.tile_count)
        self.kw = dict(tiles_per_view=grid.tiles, tx_n=grid.tx_n)

    def fwd(self, fn):
        from fourdgs_torch.ops.rasterize import kernels as K

        K.fwd_into(fn, *self.args, **self.kw, width=self.grid.width, height=self.grid.height,
                   out=self.out, n_contrib=self.n_contrib, n_touched=self.n_touched)

    def bwd(self, fn, out, n_contrib, grad_out):
        from fourdgs_torch.ops.rasterize import kernels as K

        K.bwd_into(fn, *self.args, out, n_contrib, grad_out, **self.kw, dfields=self.dfields)

    def hold(self, fns) -> dict:
        from fourdgs_torch import kernel_check as KC

        def fwd():
            self.n_touched.zero_()
            self.fwd(fns["composite_fwd"])
            return self.out, self.n_contrib, self.n_touched

        def bwd(out, n_contrib, grad_out):
            self.dfields.zero_()
            self.bwd(fns["composite_bwd"], out, n_contrib, grad_out)
            return self.dfields

        return KC.hold(fwd, bwd, self.ref)


def cull_stats(fields, bins, grid) -> dict:
    """(warp, pair) combinations of the kernels' 8x4 warp blocks: all of
    them, those the cull keeps (the pair's extent, compositor.pair_extent,
    meets the block), and those with a valid pixel (what a perfect cull
    would keep)."""
    import torch

    from fourdgs_torch.ops.rasterize import compositor as C

    vt = bins.tile_start.shape[0]
    dev = fields.device
    px, py, _ = C._pixels(vt, grid, dev)
    # first pixel of each warp's block, warp w at column w & 1, row w >> 1
    x0 = px[:, 0].double()[:, None, None] + torch.tensor([0.0, 8.0] * 4, device=dev)
    y0 = py[:, 0].double()[:, None, None] + torch.tensor([0.0, 0.0, 4.0, 4.0, 8.0, 8.0,
                                                          12.0, 12.0], device=dev)
    total = kept = needed = 0
    kmax = int(bins.tile_count.max())
    for k0 in range(0, kmax, C.KB):
        kb = min(C.KB, kmax - k0)
        f, _, _, _, _, _, valid = C._pair_block(fields, bins, k0, kb, px, py, grid)
        has = (torch.arange(k0, k0 + kb, device=dev)[None] < bins.tile_count[:, None])[..., None]
        box = C.pair_extent(f)[:, :, None]                  # (VT, kb, 1, 4)
        meets = ((box[..., 1] >= x0) & (box[..., 0] <= x0 + 7)
                 & (box[..., 3] >= y0) & (box[..., 2] <= y0 + 3))
        vw = valid.view(vt, kb, 4, 4, 2, 8).any(dim=5).any(dim=3).reshape(vt, kb, 8)
        total += int(has.sum()) * 8
        kept += int((meets & has).sum())
        needed += int(vw.sum())
    return {"warp_pairs": total, "kept_by_cull": kept, "with_a_valid_pixel": needed}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("versions", nargs="+", help="NAME=CSRC_DIR")
    ap.add_argument("--json", help="also write every measurement to this file")
    args = ap.parse_args()

    import statistics

    import torch

    if not torch.cuda.is_available():
        print("compositor_ab: no CUDA device", file=sys.stderr)
        return 2
    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.ops.rasterize import kernels as K

    versions = {}
    for v in args.versions:
        name, _, path = v.partition("=")
        versions[name] = Path(path).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t = time.time()
    fns = {}
    for name, src in versions.items():
        for k, rep in sorted(K.build(csrc=src).items()):
            print(f"nvcc {name} {K.SOURCES[k]}:\n" + "\n".join(
                ln for ln in rep.splitlines() if "ptxas info" in ln or "spill" in ln), flush=True)
        fns[name] = {k: K.load(k, csrc=src) for k in K.SOURCES}
    print(f"build: {time.time() - t:.1f}s", flush=True)

    slam, _ = KC.sample_map()
    cases = {}
    for views in VIEWS:
        fields, bins, grid = KC.compositor_inputs(slam, views)
        cases[views] = Case(fields, bins, grid, seed=views)
        print(f"views {views}: {int(bins.pair_gid.numel())} pairs, "
              f"kmax {int(bins.tile_count.max())}, {slam.gmap.num_alive} Gaussians, "
              f"cull {json.dumps(cull_stats(fields, bins, grid))}", flush=True)

    failed = []
    for name in versions:
        for views, case in cases.items():
            r = case.hold(fns[name])
            print(json.dumps({"check": name, "views": views, **r}), flush=True)
            if not r["ok"]:
                failed.append((name, views))
    if failed:
        print(f"compositor_ab: fails against the plain versions: {failed}", file=sys.stderr)
        return 1

    times = {(n, v, k): [] for n in versions for v in cases for k in ("fwd", "bwd")}
    order = list(versions)
    for rnd in range(ROUNDS):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            fwd, bwd = fns[name]["composite_fwd"], fns[name]["composite_bwd"]
            for views, case in cases.items():
                ref = case.ref
                times[(name, views, "fwd")].append(KC.cuda_ms(lambda: case.fwd(fwd), REPS))
                times[(name, views, "bwd")].append(KC.cuda_ms(
                    lambda: case.bwd(bwd, ref.out, ref.n_contrib, ref.grad_out), REPS))

    record = {"card": smi, "rounds": ROUNDS, "reps": REPS, "results": []}
    for name in versions:
        for views in cases:
            row = {"version": name, "views": views}
            for k in ("fwd", "bwd"):
                ts = times[(name, views, k)]
                row[f"{k}_ms"] = statistics.median(ts)
                row[f"{k}_rounds"] = ts
            record["results"].append(row)
            print(json.dumps(row), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
