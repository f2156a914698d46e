#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Phases, one line each, in order (any failure exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    both compositor kernels from fourdgs_torch/ops/rasterize/csrc
  3. compare  each kernel against its plain torch version at 640x480 with 1,
              2 and 10 views of a map initialised from the synthetic
              sequence (fourdgs_torch/kernel_check.py: forward outputs,
              n_contrib and n_touched exactly equal, gradients within 1e-5
              of each field's largest magnitude); with times and bounds
  4. tracking 100 track_frame iterations at 640x480, capacity 2^15, with a
              device profile of the loop
  5. slam     SLAM.run at the benchmark's width and capacity on 10 frames,
              held to ATE < 0.05 m, PSNR > 15 and L1 depth < 1.2
  6. kernels  one JSON line: per kernel its launches during the SLAM phase
              (in all and by number of views), largest error against its
              plain version, times and bound at 10 views (the full mapping
              window), and (*_1view, *_2view) at 1 and 2 views
then the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
VIEWS = (1, 2, 10)      # tracking and initialisation, this run's mapping, the full window
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_OPS_S = 67e12  # H100 SXM fp32 outside the tensor cores
# per (pixel, pair) operation counts of the kernels' arithmetic
# (composite_common.cuh, composite_fwd.cu, composite_bwd.cu): every
# add, multiply, compare, min/max, divide, exp and log1p counts as one
FWD_OPS_VISITED = 16   # dx, dy, power, exp, op*e, clamp, two validity tests
FWD_OPS_APPLIED = 18   # log1p, cum, exp, T test, 1/(1-alpha), t_before, w, 4 fma, T>0.5
BWD_OPS_VISITED = 16
BWD_OPS_APPLIED = 65   # recompute, T recovery, u, dalpha, suffix, 10 gradients and sums

T0 = time.time()


def log(msg: str):
    print(f"[{time.time() - T0:8.1f}s] {msg}", flush=True)


def work_counts(fields, bins, grid, n_contrib):
    """(pairs visited, pairs applied) over all pixels up to each pixel's
    last applied pair: the work this data needs."""
    import torch

    from fourdgs_torch.ops.rasterize import compositor as C

    px, py, _ = C._pixels(bins.tile_start.shape[0], grid, fields.device)
    kmax = int(bins.tile_count.max())
    applied = 0
    for k0 in range(0, kmax, C.KB):
        kb = min(C.KB, kmax - k0)
        *_, valid = C._pair_block(fields, bins, k0, kb, px, py, grid)
        k = torch.arange(k0, k0 + kb, device=fields.device)
        applied += int((valid & (k[None, :, None] < n_contrib[:, None])).sum())
    return int(n_contrib.sum()), applied


def compare_kernels(slam, n_views: int, seed: int) -> dict:
    """Hold both kernels' wrappers against their plain versions on
    `n_views` views of the current map at the sequence's ground-truth
    poses, and time them."""
    import torch

    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.ops.rasterize import compositor as C
    from fourdgs_torch.ops.rasterize import kernels as K

    dev = slam.device
    fields, bins, grid = KC.compositor_inputs(slam, n_views)
    args = (fields, bins.pair_gid, bins.tile_start, bins.tile_count)
    kw = dict(tiles_per_view=grid.tiles, tx_n=grid.tx_n)
    fwd = lambda: K.composite_fwd(*args, width=grid.width, height=grid.height, **kw)  # noqa: E731
    bwd = lambda out, nc, g: K.composite_bwd(*args, out, nc, g, **kw)  # noqa: E731
    ref = KC.reference(fields, bins, grid, seed)
    held = KC.hold(fwd, bwd, ref)

    reps = 20
    out_k, nc_k, _ = fwd()
    fwd_ms = KC.cuda_ms(fwd, reps)
    bwd_ms = KC.cuda_ms(lambda: bwd(out_k, nc_k, ref.grad_out), reps)
    plain_fwd_ms = KC.cuda_ms(lambda: C.composite_forward_plain(fields, bins, grid), 2)
    plain_bwd_ms = KC.cuda_ms(lambda: C.composite_backward_plain(
        fields, bins, grid, ref.out, ref.n_contrib, ref.grad_out), 2)

    visited, applied = work_counts(fields, bins, grid, ref.n_contrib)
    n_pairs = int(bins.pair_gid.numel())
    rows = int(torch.unique(bins.pair_gid.long()
                            + (torch.repeat_interleave(
                                torch.arange(bins.tile_count.numel(), device=dev) // grid.tiles,
                                bins.tile_count.long()) * fields.shape[1])).numel())
    vt = bins.tile_start.numel()
    npix = vt * C.NPIX
    fwd_bytes = rows * 40 + n_pairs * 4 + vt * 8 + npix * (5 * 4 + 4) + fields.shape[0] * fields.shape[1] * 4
    bwd_bytes = rows * 40 + n_pairs * 4 + vt * 8 + npix * (4 + 4 + 5 * 4) + rows * 40
    fwd_ops = FWD_OPS_VISITED * visited + FWD_OPS_APPLIED * applied
    bwd_ops = BWD_OPS_VISITED * (visited - applied) + BWD_OPS_APPLIED * applied

    def bound(nbytes, ops):
        t_b, t_o = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_OPS_S * 1e3
        return (max(t_b, t_o), "bytes" if t_b >= t_o else "operations")

    fb, fby = bound(fwd_bytes, fwd_ops)
    bb, bby = bound(bwd_bytes, bwd_ops)
    return {
        "views": n_views, "gaussians": slam.gmap.num_alive, "pairs": n_pairs,
        "kmax": int(bins.tile_count.max()), "visited": visited, "applied": applied,
        "err": held["err"], "ok": held["ok"],
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "plain_fwd_ms": plain_fwd_ms,
        "plain_bwd_ms": plain_bwd_ms,
        "fwd_bytes": fwd_bytes, "fwd_ops": fwd_ops, "fwd_bound_ms": fb, "fwd_bound_by": fby,
        "bwd_bytes": bwd_bytes, "bwd_ops": bwd_ops, "bwd_bound_ms": bb, "bwd_bound_by": bby,
    }


def profile_tracking(slam, frame, T_init, cfg, iters: int, ms_per_iter: float) -> dict:
    """Device time and launches of `iters` tracking iterations under the
    profiler. The idle share sets that device time against `ms_per_iter`,
    the iteration's wall time measured without the profiler, which slows
    the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fourdgs_torch.slam.tracking import track_frame

    short = cfg._replace(max_iters=iters)
    track_frame(slam.gmap, frame, T_init, torch.zeros(2, device=slam.device), slam.intr, short)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        res = track_frame(slam.gmap, frame, T_init, torch.zeros(2, device=slam.device),
                          slam.intr, short)
        torch.cuda.synchronize()
        wall = time.time() - t
    kernels = [e for e in prof.key_averages() if e.device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    n = max(res.n_iters, 1)
    busy_ms = busy_us / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:6]
    return {
        "iters": res.n_iters, "profiled_wall_ms_per_iter": wall * 1e3 / n,
        "device_busy_ms_per_iter": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / ms_per_iter),
        "kernel_launches_per_iter": launches / n,
        "top_kernels": [{"kernel": e.key[:80], "ms_per_iter": e.device_time_total / 1e3 / n,
                         "calls_per_iter": e.count / n} for e in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", help="also write every measurement to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from fourdgs_torch import kernel_check as KC
        from fourdgs_torch.ops.rasterize import kernels as K
    except ImportError as e:
        print(f"chip_smoke: the fourdgs_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    from fourdgs_torch.slam.runner import SLAM
    from fourdgs_torch.slam.tracking import track_frame

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; nvidia-smi: {smi}")
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    t = time.time()
    reports = K.build()
    record["build_s"] = time.time() - t
    log(f"build: {record['build_s']:.1f}s (" + ", ".join(sorted(K.SOURCES)) + ")")
    for name, rep in sorted(reports.items()):
        print(f"nvcc {K.SOURCES[name]}:\n" + "\n".join(
            ln for ln in rep.splitlines() if "ptxas info" in ln or "spill" in ln), flush=True)

    # ---- phase 3: kernels against their plain versions on an initialised map
    t = time.time()
    log("compare: map from 100 init iterations on frame 0 of the synthetic sequence "
        "(the SLAM phase runs the full 1050)")
    slam, frames = KC.sample_map()
    compare = {}
    for views in VIEWS:
        compare[views] = r = compare_kernels(slam, views, seed=views)
        log(f"compare {KC.WIDTH}x{KC.HEIGHT}x{views}: " + json.dumps(r))
        if not r["ok"]:
            raise SystemExit(f"kernel disagrees with its plain version at {views} views: {r['err']}")
    record["compare"] = compare
    log(f"phase compare: {time.time() - t:.1f}s")

    # ---- phase 4: tracking
    t = time.time()
    tcfg = slam.track_cfg._replace(converged_threshold=0.0)
    T_init = slam._pose_tensor(slam.poses_est[0])
    torch.cuda.synchronize()
    t_track = time.time()
    res = track_frame(slam.gmap, frames[1], T_init, torch.zeros(2, device=slam.device),
                      slam.intr, tcfg)
    torch.cuda.synchronize()
    track_ms = (time.time() - t_track) * 1e3 / max(res.n_iters, 1)
    import numpy as np

    c_est = -res.T_cw[:3, :3].T @ res.T_cw[:3, 3]
    T_gt = torch.as_tensor(slam.dataset.poses[1], dtype=torch.float32, device=slam.device)
    c_gt = -T_gt[:3, :3].T @ T_gt[:3, 3]
    tracking = {"iters": res.n_iters, "ms_per_iter": track_ms,
                "camera_center_err_m": float(torch.linalg.norm(c_est - c_gt)),
                "gaussians": slam.gmap.num_alive, "pairs": res.num_pairs,
                "profile": profile_tracking(slam, frames[1], T_init, tcfg, 16, track_ms)}
    record["tracking"] = tracking
    log("tracking: " + json.dumps(tracking))
    log(f"phase tracking: {time.time() - t:.1f}s")
    del slam, frames
    torch.cuda.empty_cache()

    # ---- phase 5: SLAM.run, the main path; only launches here are counted
    t = time.time()
    log("slam cuts against bench.py: 10 frames of its 40-frame sequence; widths, "
        "capacity 2^15, iteration counts, window 8 + 2 replay unchanged")
    slam = SLAM(KC.bench_config(40), max_frames=10, capacity=KC.CAPACITY,
                max_capacity=KC.CAPACITY, max_keyframes=64)
    wrappers = {"composite_fwd": K.composite_fwd, "composite_bwd": K.composite_bwd}
    for k in wrappers.values():
        k.launches_by_views.clear()
    metrics = slam.run()
    by_views = {name: dict(k.launches_by_views) for name, k in wrappers.items()}
    launches = {name: sum(n.values()) for name, n in by_views.items()}
    ate = slam.eval_ate()["rmse"]
    rend = slam.eval_rendering()
    result = {"ate_rmse_m": ate, "psnr": rend["mean_psnr"], "l1_depth": rend["mean_l1_depth"],
              "ssim": rend["mean_ssim"], "fps": metrics["fps"], "keyframes": len(slam.kf_indices),
              "gaussians": slam.gmap.num_alive, "max_pairs_per_view": slam.max_pairs_seen,
              "phase_s": metrics["phase_s"], "launches": launches,
              "launches_by_views": by_views}
    record["slam"] = result
    log("slam: " + json.dumps(result))
    log(f"phase slam: {time.time() - t:.1f}s")
    if not (ate < 0.05 and rend["mean_psnr"] > 15 and rend["mean_l1_depth"] < 1.2):
        raise SystemExit(f"SLAM result out of bounds: {result}")
    if min(launches.values()) <= 0 or len(slam.kf_indices) < 2:
        raise SystemExit(f"the SLAM phase did not run both kernels and a keyframe: {result}")
    if not all(np.isfinite(slam.poses_est[i]).all() for i in slam.poses_est):
        raise SystemExit("non-finite pose")

    # ---- phase 6: the kernels line; ms, plain_ms and bound_ms are at 10
    # views (the full mapping window), the *_1view and *_2view keys at the
    # shapes this run launched (tracking and initialisation; mapping with
    # its 2 keyframes); max_abs_err over all three
    def entry(name, short, replaces, err_keys):
        timed = {"ms": f"{short}_ms", "plain_ms": f"plain_{short}_ms",
                 "bound_ms": f"{short}_bound_ms", "bound_by": f"{short}_bound_by"}
        e = {"name": name, "route": "cuda",
             "source": f"fourdgs_torch/ops/rasterize/csrc/{name}.cu",
             "replaces": replaces, "launches": launches[name],
             "launches_by_views": by_views[name],
             "max_abs_err": max(compare[v]["err"][k] for v in VIEWS for k in err_keys),
             **{key: compare[10][src] for key, src in timed.items()}, "library_ms": None}
        for v in (1, 2):
            e.update({f"{key}_{v}view": compare[v][src] for key, src in timed.items()})
        return e

    line = {"kernels": [
        entry("composite_fwd", "fwd", "fourdgs/ops/rasterize/tile_kernel.py:147",
              ("color", "depth", "T_final")),
        entry("composite_bwd", "bwd", "fourdgs/ops/rasterize/tile_kernel.py:226",
              ("grad_abs",)),
    ]}
    record["kernels"] = line["kernels"]
    record["total_s"] = time.time() - T0
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
