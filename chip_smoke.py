#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Phases, one line each, in order (any failure exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    both compositor kernels from fourdgs_torch/ops/rasterize/csrc
  3. compare  each kernel against its plain torch version at 640x480 on
              views of a map initialised from the synthetic sequence, at
              every number of views in VIEWS: 1, 2 and 10 (tracking, the
              static phase's mapping, the full static window), 26 (the
              full 4D window: 10 views of RGB and 16 whose colour channels
              carry signed flow payloads), the numbers the dynamic and
              cli phases launch, and each rank's block of the 4D window
              in phase 13 (13 views of which 3, and 13 of which 13, carry
              flow payloads); and at 80x60, on the map of `batch_eval
              --synthetic` (its lower tile row 12 pixels high: the
              kernels' partial tiles), at each number of views in
              BATCH_VIEWS, which phase 14's batch_eval launches
              (fourdgs_torch/kernel_check.py: forward
              outputs, n_contrib and n_touched exactly equal, gradients
              within 1e-5 of each field's largest magnitude); with times
              and bounds
  4. tracking 100 track_frame iterations at 640x480, capacity 2^15, with a
              device profile of the loop
  5. slam     SLAM.run(warmup_frames=1) at the benchmark's width and
              capacity on 10 frames, held to ATE < 0.05 m, PSNR > 15 and L1
              depth < 1.2 and to fps_steady set; prints fps (the whole run)
              and fps_steady (frames 1-9: frame 0's 1,050-iteration
              initialisation left out) and the steady state's phase seconds
  6. dynamic  SLAM(dynamic=True).run at the `bench.py --dynamic` width and
              capacity on 15 of its 40 frames (keyframes 0, 5, 8 = dystart
              and 13), held to ATE < 0.08 m, PSNR > 14, keyframe 8, more
              than 20 dynamic Gaussians spawned at dystart, some of them
              alive at the end, and a learned motion of those; with each
              frame's camera-centre error, the window's before and after
              each 4D keyframe phase, the seconds per phase, ms per
              dynamic mapping iteration and a device profile of one
  7. cli      the command line, fourdgs_torch.cli.main(... --eval --dynamic
              --interval 5), on a 44-frame 640x480 dynamic synthetic
              sequence written in TUM layout to a temporary directory,
              with a config inheriting configs/rgbd/tum/base_config.yaml
              (only the sequence, its calibration and dystart 8 set):
              TUM loader, motion segmenter, 4D SLAM (no flow loss: no
              flow weights are found), ATE, evaluation, 1500 refinement iterations
              at 10 views (44 frames make the 10 keyframes that need),
              evaluation, artifacts, a checkpoint resumed with --resume;
              held to ATE < 0.08 m, PSNR after refinement > 14 dB and not
              below before, the artifact tree, pixels segmented dynamic,
              the resumed map equal to the checkpointed one, and every
              refinement iteration at 10 views; with the seconds per stage
              and the launches by number of views per stage
              (and, with a seeded LPIPS weights file in
              $FOURDGS_LPIPS_WEIGHTS, a finite mean LPIPS before and after
              refinement; no flow weights are found, so no flow loss)
  8. perception  RAFT (20 iterations) and GMA (12, gamma 0.7) at 640x480
              and the published widths, on two frames of the dynamic
              synthetic sequence, weights seeded from torch.Generators,
              through their providers: the card's flows held against the
              port's own CPU run of the same modules and weights within
              FLOW_TOL px, the forward-backward masks on at least
              MASK_AGREE of pixels, and LPIPS card against CPU within rtol
              1e-4; with ms per flow and per LPIPS pair (CUDA events)
  9. flow     the command line, fourdgs_torch.cli.main(... --dynamic
              --interval 5), on a 14-frame 640x480 dynamic synthetic
              sequence written in CoFusion layout (the blob's exact masks in
              mask_colour/, so the deformation initialises at dystart 8),
              with a config inheriting configs/rgbd/cofusion/base_config.yaml
              and a seeded pretrained/raft-things.npz and a seeded
              full-width pretrained/yolov9e-seg.npz in its (temporary)
              working directory: RAFT on the card supervises 4D mapping, and
              YOLOv9e-seg on the card segments each frame (mask_colour/
              then overrides its masks, as in the reference). Held: flow
              weight 3, every window view with an earlier keyframe given its
              flow, each pair computed once, keyframes 0, 5, 8, 13 and
              FLOW_VIEW_LAUNCHES compositor launches per kernel in 4D
              chunks with flow views, finite poses; the runner's segmenter
              the port's Yolov9SegSegmenter, called once per frame, its
              forward on CUDA; printed, not held (seeded weights give no
              real supervision): ATE, PSNR, seconds per stage, the share of
              consistent mask pixels
 10. segmentation  YOLOv9e-seg at the published widths (60.5 M parameters,
              weights seeded from a torch.Generator) through
              Yolov9SegSegmenter on the card and on the CPU, on a 640x480
              frame of the dynamic synthetic sequence: boxes, scores, mask
              coefficients and prototypes card against CPU within SEG_TOL of
              each output's largest magnitude, and the masks on at least
              SEG_MASK_AGREE of pixels at a conf set between the SEG_CANDIDATES-th
              and the next score of the configured classes (person, chair),
              so NMS and the mask composition run on that many detections;
              with ms per frame (the segmenter's call, at that conf and at
              0.25), ms per forward (CUDA events), device time, idle share
              and launches per forward (torch.profiler), and GFLOP per frame
              (convolutions, counted on the meta device) with its bound
 11. kernels  one JSON line: per kernel its launches in the SLAM phase, in
              the dynamic phase, in the cli phase, in the flow phase, in
              the two runs of phase 12, in phase 13's run and in phase 14's
              viewer, view_ply and batch_eval (in all, by
              number of views, phase 13's per rank, and the cli phase's
              refinement by number of views), phase 13's per rank by
              number of views in its static and 4D chunks, largest error
              against its plain version, times and bound at 10 views (the
              full static window), and (*_1view, *_2view, *_26view) at 1, 2
              and 26 views; printed after phase 14
 12. monocular  SLAM(cfg).run() with Training.monocular at bench.py's
              widths and capacity on its 40-frame synthetic sequence,
              written in TUM layout to a temporary directory and read back
              with sensor_type: monocular (no depth read): tracking at 1
              view, mapping before initialisation at the window's views,
              the 300-iteration initial bundle adjustment when the window of
              8 fills (keyframe 35; with no depth, covisibility selection
              picks nothing, so it renders window[:3] and 2 replay views).
              Held: finite poses, initialised through that bundle adjustment
              (or, if the window never fills, at least one recovery),
              no depth read, ATE after Sim(3) alignment < 0.08 m, PSNR > 14;
              printed: the runner's unscaled ATE, each frame's centre
              error, seconds per phase, ms per tracking iteration, launches
              by number of views per mapping phase. Then phase 5's 10-frame
              run with Training.rm_initdy, held to phase 5's limits, its
              reprojection masks made on the card and each equal to the
              port's CPU reproject_mask on the same inputs on at least
              RM_MASK_AGREE of pixels; printed: ms per mask, the share of
              pixels removed
 13. mesh     multi-device mapping (fourdgs_torch/parallel/): 2 ranks sharing
              cuda:0 over gloo (and, with two cards or more, 2 ranks on
              cuda:0 and cuda:1 over NCCL): the collectives, then map_chunk
              over the full static window (10 views) at bench.py's widths
              and capacity against one device after 1 iteration (loss
              1e-5 relative, map 2e-5, poses 1e-5, denom exact: the
              tolerances of tests/test_parallel.py) and after MESH_ITERS
              (loss 2e-3, map 3e-2, poses 2e-3), and map_chunk_dynamic over
              the full 4D window (26 views) after 1 (the map 2e-5, the
              field 2e-4), every rank launching both kernels at a number
              of views held in phase 3; then phase 5's run with the
              runner's mesh (`slam.mesh`) the 2 ranks on cuda:0, held to
              phase 5's limits, every rank launching both kernels and no
              worker importing jax or fourdgs; printed: ms per mapping
              iteration on one device and on the mesh, static and 4D
              (4D chunks of 1 and MESH_DYN_ITERS iterations, so that the
              cost per chunk and per iteration part), each mesh call's
              seconds sending its arguments, in each rank's work and
              checksum and waiting (`Mesh.seconds`), collective ms and
              bytes per iteration, launches per rank by number of views
 14. last modules  on phase 5's finished map: the live viewer
              (fourdgs_torch/gui/viewer.py) with an HTTP port, driven over
              /ctl (pause holds wait_if_paused, resume, orbit), then
              VIEWER_UPDATES updates at the last frame on the card (2
              forward launches at 1 view each, no backward) and one on a
              CPU copy of the map: the renders (current view, novel view,
              depth) within RENDER_TOL (tests/test_rasterizer.py's) on
              RENDER_AGREE of pixels and the colour PNGs within one level
              on every value, the card's compositor calls equal to the
              plain version on the same inputs on the card,
              points.bin the alive count strided to
              at most 2^15 rows, status.json the frame, the port free after
              close; fourdgs_torch.view_ply.main on that map saved as PLY,
              VIEW_PLY_FRAMES orbit frames at 640x480 on the card (one
              forward launch each) and with --device cpu, the PNGs within
              one level on every value; HexPlane at
              4DGaussians' defaults and the hash grid at its defaults on
              FIELD_POINTS points, forward and backward, card against CPU
              (values within FIELD_TOL, gradients within FIELD_GRAD_TOL of
              each largest magnitude); extend_nodes at NODES nodes equal,
              acc_loss within FIELD_TOL and its gradients ACC_GRAD_TOL;
              fourdgs_torch.batch_eval --synthetic 1 --frames BATCH_FRAMES
              on the card held to ATE < 0.05 m and PSNR > 15, every launch
              at a number of views phase 3 held at 80x60; and
              load_dataset(type: realsense) raising RuntimeError without
              pyrealsense2. The kernels line then carries the viewer's and
              view_ply's launches (launches_viewer, launches_view_ply) and
              batch_eval's by number of views (launches_by_views_batch_eval)
then the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# numbers of views held in phase 3: tracking and initialisation (1), the
# static phase's mapping (2), the full static window (10), the full 4D
# window (26), what the dynamic phase launches besides: its window
# visibility (3, 4), its first dynamic keyframe (7 = 3 views and 2 flow
# pairs) and its second (10 = 4 and 3), and what the cli phase's window
# launches as it grows to 8 keyframes and 2 replay views (3 to 10, without
# flow views); its refinement launches 10
VIEWS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 26)
FLOW_VIEWS = {7: 4, 26: 16}   # of those views, how many carry flow payloads
# held besides: 10 views of which 6 carry flow payloads, the second 4D
# keyframe of the dynamic and flow phases (4 window views and 3 flow pairs)
FLOW_SHAPES = ((10, 6),)
# numbers of views held in phase 3 at 80x60, on batch_eval --synthetic's
# map: what its run launches (tracking and evaluation 1, mapping its
# window of at most window_size 3 keyframes)
BATCH_VIEWS = (1, 2, 3)
CLI_FRAMES = 44   # keyframes 0, 5, 8 (dystart), 13, ..., 43: ten, for refinement at 10 views
# keyframes 0, 5, 8 (dystart) and 13, the last frame: two 4D phases, three
# flow pairs (with 18 frames the script took 659 s on an H100 80GB HBM3 at 700 W)
FLOW_FRAMES = 14
FLOW_TOL = 5e-2   # px, card against CPU, RAFT and GMA flows at 640x480
MASK_AGREE = 0.999
# 200 iterations of each of the flow phase's two 4D chunks with flow pairs
FLOW_VIEW_LAUNCHES = 400
SEG_TOL = 1e-3    # of each output's largest magnitude, YOLOv9e-seg card against CPU
SEG_MASK_AGREE = 0.9999
SEG_CANDIDATES = 40   # detections of the configured classes the segmentation phase keeps
# added to the seeded person-class bias of each level in the segmentation
# phase: seeded class scores peak on a few classes, person rarely among them
SEG_PERSON_RAISE = 1.0
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


def compare_kernels(slam, n_views: int, seed: int, n_flow: int | None = None) -> dict:
    """Hold both kernels' wrappers against their plain versions on
    `n_views` views of the current map at the sequence's ground-truth
    poses (the last `n_flow`, by default FLOW_VIEWS[n_views], with flow
    payloads), and time them."""
    import torch

    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.ops.rasterize import compositor as C
    from fourdgs_torch.ops.rasterize import kernels as K

    dev = slam.device
    n_flow = FLOW_VIEWS.get(n_views, 0) if n_flow is None else n_flow
    fields, bins, grid = KC.compositor_inputs(slam, n_views, n_flow, seed)
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
        "views": n_views, "flow_views": n_flow, "width": grid.width, "height": grid.height,
        "gaussians": slam.gmap.num_alive,
        "pairs": n_pairs,
        "kmax": int(bins.tile_count.max()), "visited": visited, "applied": applied,
        "err": held["err"], "ok": held["ok"],
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "plain_fwd_ms": plain_fwd_ms,
        "plain_bwd_ms": plain_bwd_ms,
        "fwd_bytes": fwd_bytes, "fwd_ops": fwd_ops, "fwd_bound_ms": fb, "fwd_bound_by": fby,
        "bwd_bytes": bwd_bytes, "bwd_ops": bwd_ops, "bwd_bound_ms": bb, "bwd_bound_by": bby,
    }


def profile_tracking(slam, frame, T_init, cfg, iters: int, ms_per_iter: float) -> dict:
    """Device time and launches of `iters` tracking iterations under the
    profiler, against `ms_per_iter`, the iteration's wall time measured
    without it."""
    import torch

    from fourdgs_torch.slam.tracking import track_frame

    short = cfg._replace(max_iters=iters)
    run = lambda: track_frame(slam.gmap, frame, T_init,  # noqa: E731
                              torch.zeros(2, device=slam.device), slam.intr, short)
    n = max(run().n_iters, 1)
    return {"iters": n, **_device_profile(run, n, ms_per_iter)}


def _device_profile(fn, n_iters: int, ms_per_iter: float) -> dict:
    """Device time and launches of `fn()` (n_iters iterations) under the
    profiler, set against `ms_per_iter`, the wall time per iteration
    measured without it (the profiler slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t
    kernels = [e for e in prof.key_averages() if e.device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / n_iters
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    return {
        "profiled_wall_ms_per_iter": wall * 1e3 / n_iters,
        "device_busy_ms_per_iter": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / ms_per_iter),
        "kernel_launches_per_iter": sum(e.count for e in kernels) / n_iters,
        "top_kernels": [{"kernel": e.key[:80], "ms_per_iter": e.device_time_total / 1e3 / n_iters,
                         "calls_per_iter": e.count / n_iters} for e in top],
    }


def profile_dynamic(slam, iters: int) -> dict:
    """`iters` dynamic mapping iterations on the finished run's window (the
    runner's own chunk call), timed by the wall clock, then one under the
    profiler. Moves the window's poses and the map, and resets the
    forward's launch counts: run it after the run is evaluated and its
    counts read."""
    import torch

    from fourdgs_torch.ops.rasterize import kernels as K

    slam._map_dynamic(1, -1)
    torch.cuda.synchronize()
    K.composite_fwd.launches_by_views.clear()
    t = time.time()
    slam._map_dynamic(iters, -1)
    torch.cuda.synchronize()
    ms = (time.time() - t) * 1e3 / iters
    by_views = dict(K.composite_fwd.launches_by_views)
    return {"iters": iters, "views": max(by_views, key=by_views.get), "ms_per_iter": ms,
            "profile": _device_profile(lambda: slam._map_dynamic(1, -1), 1, ms)}


def centre_errors_mm(slam, frames=None) -> dict:
    """Camera-centre error against the ground truth, in mm, unaligned
    (frame 0 starts at its ground-truth pose), of each tracked frame or
    of `frames`."""
    import numpy as np

    def centre(T):
        T = np.asarray(T, np.float64)
        return -T[:3, :3].T @ T[:3, 3]

    return {i: float(np.linalg.norm(centre(slam.poses_est[i]) - centre(slam.dataset.poses[i]))
                     * 1e3) for i in sorted(slam.poses_est if frames is None else frames)}


def trace_dynamic_phases(slam) -> list:
    """Record, for each 4D keyframe phase of `slam`, the window's camera
    errors before and after it and the dynamic Gaussians alive after its
    densify. Returns the list that fills as the run goes."""
    phases = []
    run_phase = slam._run_mapping_dynamic

    def traced(total_iters, step_after):
        window = list(slam.window)
        before = centre_errors_mm(slam, window)
        run_phase(total_iters, step_after)
        phases.append({"keyframe": window[0], "centre_err_mm_before": before,
                       "centre_err_mm_after": centre_errors_mm(slam, window),
                       "dynamic_alive": int((slam.gmap.dygs & slam.gmap.alive).sum())})

    slam._run_mapping_dynamic = traced
    return phases


@contextlib.contextmanager
def observe_stages(slam_cls, wrappers):
    """While open: the SLAM instances made (`seen["slams"]`), and per stage
    of the command line (`run`, `eval_ate`, `eval_rendering` by label,
    `color_refinement`) its seconds, synchronised, and the launches by
    number of views of each kernel wrapper during it."""
    import torch

    seen = {"slams": [], "stages": {}}
    names = ("run", "eval_ate", "eval_rendering", "color_refinement")
    originals = {name: getattr(slam_cls, name) for name in names}
    original_init = slam_cls.__init__

    def init(self, *a, **k):
        original_init(self, *a, **k)
        seen["slams"].append(self)

    def staged(name, fn):
        def stage(self, *a, **k):
            before = {w: dict(k_.launches_by_views) for w, k_ in wrappers.items()}
            torch.cuda.synchronize()
            t = time.time()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            label = a[0] if a and isinstance(a[0], str) else k.get("label")
            key = f"{name}_{label}" if name.startswith("eval") else name
            seen["stages"][key] = {"s": time.time() - t, "launches_by_views": {
                w: {v: n - before[w].get(v, 0) for v, n in k_.launches_by_views.items()
                    if n - before[w].get(v, 0)} for w, k_ in wrappers.items()}}
            return out
        return stage

    slam_cls.__init__ = init
    for name, fn in originals.items():
        setattr(slam_cls, name, staged(name, fn))
    try:
        yield seen
    finally:
        slam_cls.__init__ = original_init
        for name, fn in originals.items():
            setattr(slam_cls, name, fn)


# the iterations per tracked frame and per keyframe phase, which
# `write_cli_sequence(iters=F)` divides by F (frame 0's initialisation, a
# one-off, keeps its 1050 and its densify and reset cadence)
ITER_KEYS = {"tracking_itr_num": 100, "keyframe_mapping_iters": 200}
# base_config.yaml's pixel strides of the points that spawn Gaussians
PCD_STRIDES = {"pcd_downsample": 128, "pcd_downsample_init": 32}


def write_cli_sequence(tmp: str, extra_yaml: str = "", blob: bool = True,
                       frames: int = CLI_FRAMES, scale: float = 1.0, strides: float = 1.0,
                       iters: int = 1, device: str = "cuda") -> str:
    """Write the cli phase's sequence (`frames` frames, CLI_FRAMES unless
    asked, of the dynamic synthetic sequence at 640x480, or with `blob`
    False of the static one, in TUM layout) and its config under `tmp`;
    returns the config's path. The config inherits
    configs/rgbd/tum/base_config.yaml and sets the sequence, its
    calibration, dystart 8 and `extra_yaml`. A shorter sequence is the first
    `frames` of the CLI_FRAMES-frame one (the camera and the blob move as
    much per frame); `scale` scales the resolution and the intrinsics with
    it; `strides` scales base_config.yaml's pixel strides of the points
    that spawn Gaussians (scale squared spawns as many as at 640x480);
    `iters` divides the counts of ITER_KEYS (base_config.yaml's and the
    runner's defaults)."""
    import torch

    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.data.synthetic import SyntheticDataset, write_tum_format

    seq = os.path.join(tmp, "seq")
    seq_cfg = (KC.bench_dynamic_config if blob else KC.bench_config)(CLI_FRAMES)
    c = seq_cfg["Dataset"]["Calibration"]
    for k in ("fx", "fy", "cx", "cy"):
        c[k] = c[k] * scale
    c["width"], c["height"] = round(c["width"] * scale), round(c["height"] * scale)
    synthetic = SyntheticDataset(None, "", seq_cfg, device=device)
    synthetic.num_imgs = frames
    write_tum_format(synthetic, seq)
    cfg = os.path.join(tmp, "synthetic_tum_dynamic.yaml")
    pcd = "".join(f"  {k}: {max(1, round(n * strides))}\n"
                  for k, n in PCD_STRIDES.items()) if strides != 1 else ""
    training = {"dystart": 8}
    if iters != 1:
        training.update({k: max(1, round(n / iters)) for k, n in ITER_KEYS.items()})
    with open(cfg, "w") as f:
        f.write("inherit_from: configs/rgbd/tum/base_config.yaml\n"
                f"Dataset:\n  dataset_path: {seq}\n{pcd}  Calibration:\n"
                + "".join(f"    {k}: {c[k]}\n" for k in ("fx", "fy", "cx", "cy", "width",
                                                        "height"))
                + "    depth_scale: 5000.0\n    distorted: false\n"
                "Training:\n" + "".join(f"  {k}: {v}\n" for k, v in training.items())
                + extra_yaml)
    del synthetic
    if device == "cuda":
        torch.cuda.empty_cache()
    return cfg


def cli_phase(wrappers) -> dict:
    """The command line on a recorded-layout sequence (phase 7); returns its
    record, with the launches by number of views in `launches_by_views`
    and those of the refinement in `refinement_by_views`."""
    import numpy as np
    import torch

    from fourdgs_torch import cli
    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.slam.runner import SLAM

    tmp = tempfile.mkdtemp(prefix="fourdgs_cli_")
    run_dirs = []
    try:
        t = time.time()
        cfg = write_cli_sequence(tmp)
        write_s = time.time() - t
        ck = os.path.join(tmp, "checkpoint.npz")
        common = ["--config", cfg, "--dynamic", "--capacity", str(KC.CAPACITY)]
        for k in wrappers.values():
            k.launches_by_views.clear()
        with observe_stages(SLAM, wrappers) as seen:
            metrics = cli.main(common + ["--eval", "--interval", "5", "--checkpoint", ck])
        by_views = {name: dict(k.launches_by_views) for name, k in wrappers.items()}
        slam = seen["slams"][0]
        run_dirs.append(slam.save_dir)
        with observe_stages(SLAM, wrappers) as seen_resume:
            cli.main(common + ["--resume", ck, "--max-frames", "0"])
        resumed = seen_resume["slams"][0]
        run_dirs.append(resumed.save_dir)

        def read(*parts):
            with open(os.path.join(*parts), "rb") as f:
                return f.read()

        resumed_equal = (read(resumed.save_dir, "point_cloud", "final", "point_cloud.ply")
                         == read(slam.save_dir, "point_cloud", "final_before_opt",
                                 "point_cloud.ply"))
        artifacts = ("config.yml", "pose.txt", "plot/stats_final.json", "plot/trj_final.json",
                     "psnr/before_opt/final_result.json", "psnr/after_opt/final_result.json",
                     "point_cloud/final/point_cloud.ply")
        missing = [a for a in artifacts if not os.path.exists(os.path.join(slam.save_dir, a))]
        masks = slam.dataset.dynamic_masks
        dynamic_px = [int(masks[i].sum()) for i in sorted(masks)]
        t_dec = time.time()
        for i in range(len(slam.dataset)):
            slam.dataset._read_color(i)
            slam.dataset._read_depth(i)
        decode_ms = (time.time() - t_dec) * 1e3 / len(slam.dataset)
        stages = seen["stages"]
        refine = stages["color_refinement"]["launches_by_views"]
        iters = int(slam.config["Training"].get("refinement_iters", 1500))
        out = {
            "frames": metrics["n_frames"], "ate_rmse_m": metrics["ate_rmse"],
            "psnr_before": metrics["psnr_before"], "psnr_after": metrics["psnr_after"],
            "ssim_after": metrics["ssim_after"], "l1_depth_after": metrics["l1_depth_after"],
            "lpips_before": metrics["lpips_before"], "lpips_after": metrics["lpips_after"],
            "flow_weight": slam.flow_weight,
            "keyframes": list(slam.kf_indices), "gaussians": slam.gmap.num_alive,
            "deform_init": slam.deform_init, "dynamic_gaussians": int(
                (slam.gmap.dygs & slam.gmap.alive).sum()),
            "dynamic_px_per_frame": dynamic_px, "missing_artifacts": missing,
            "resumed_map_equal": resumed_equal, "refinement_iters": iters,
            "seconds": {"write_sequence": write_s, **{k: v["s"] for k, v in stages.items()},
                        "png_decode_ms_per_frame": decode_ms, **metrics["phase_s"]},
            "stage_launches_by_views": {k: v["launches_by_views"] for k, v in stages.items()},
            "launches_by_views": by_views, "refinement_by_views": refine,
            "centre_err_mm": centre_errors_mm(slam),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for d in run_dirs:
            shutil.rmtree(d, ignore_errors=True)
            with contextlib.suppress(OSError):
                os.rmdir(os.path.dirname(d))   # the results directory, if now empty
    log("cli: " + json.dumps(out))
    lpips_finite = all(out[k] is not None and np.isfinite(out[k])
                       for k in ("lpips_before", "lpips_after"))
    ok = (out["ate_rmse_m"] < 0.08 and out["psnr_after"] > 14
          and out["psnr_after"] >= out["psnr_before"] and not missing and resumed_equal
          and lpips_finite and out["flow_weight"] == 0.0
          and max(dynamic_px[1:], default=0) > 0
          and all(refine[k] == {10: iters} for k in wrappers)
          and all(np.isfinite(slam.poses_est[i]).all() for i in slam.poses_est))
    if not ok:
        raise SystemExit(f"cli phase out of bounds: {out}")
    return out


def flow_flops(model, iters: int, h: int, w: int) -> float:
    """Float operations of one flow of `model` at h x w: its convolutions,
    counted from their output shapes on the meta device, the correlation
    volume, and for GMA the attention and each iteration's aggregation
    (two per multiply-add)."""
    import torch

    total = [0.0]

    def hook(m, inp, out):
        total[0] += 2.0 * out.numel() * m.weight[0].numel()

    model = type(model)().to("meta")
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    x = torch.zeros(1, 3, h, w, device="meta")
    with torch.no_grad():
        model(x, x, iters=iters)
    hw = (h // 8) * (w // 8)
    total[0] += 2.0 * hw * hw * 256
    if hasattr(model, "att"):
        total[0] += 2.0 * hw * hw * 128 * (1 + iters)
    return total[0]


def perception_phase() -> dict:
    """RAFT and GMA (phase 8) through their providers on the card and on the
    CPU, with the same seeded weights, on two frames of the dynamic
    synthetic sequence at 640x480; and LPIPS on the same pair."""
    import numpy as np
    import torch

    from fourdgs_torch import convert
    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.data.synthetic import SyntheticDataset
    from fourdgs_torch.eval import lpips as L
    from fourdgs_torch.perception import gma as G
    from fourdgs_torch.perception import raft as R
    from fourdgs_torch.perception.flow import compute_fwdbwd_mask
    from fourdgs_torch.perception.weights_io import save_pytree_npz

    ds = SyntheticDataset(None, "", KC.bench_dynamic_config(FLOW_FRAMES), device="cuda")
    uids = (13, 8)   # a keyframe and its closest earlier one in the flow phase
    img1, img2 = (torch.as_tensor(ds[i][0]) for i in uids)
    del ds
    torch.cuda.empty_cache()
    gma = R.init_weights(G.GMA(), torch.Generator().manual_seed(2))
    with torch.no_grad():
        gma.update_block.aggregator.gamma.fill_(0.7)
    nets = {"raft": (R.RaftFlowProvider, R.init_weights(R.RAFT(), torch.Generator().manual_seed(1))),
            "gma": (G.GmaFlowProvider, gma)}
    out = {"frames": list(uids)}
    tmp = tempfile.mkdtemp(prefix="fourdgs_perception_")
    try:
        for name, (provider_cls, model) in nets.items():
            path = os.path.join(tmp, f"{name}-things.npz")
            save_pytree_npz(path, convert.flow_params(model))
            card, cpu = (provider_cls(path, device=d) for d in ("cuda", "cpu"))
            flows_card = card(*uids, img1, img2)
            t = time.time()
            flows_cpu = cpu(*uids, img1, img2)
            cpu_s = (time.time() - t) / 2
            masks_card = compute_fwdbwd_mask(*flows_card)
            masks_cpu = compute_fwdbwd_mask(*flows_cpu)
            err = max(float(np.abs(a - b).max()) for a, b in zip(flows_card, flows_cpu))
            ms = KC.cuda_ms(lambda: card.flow(img2, img1), 5)
            out[name] = {
                "iters": card.iters, "max_abs_err_px": err,
                "flow_abs_max_px": float(max(np.abs(f).max() for f in flows_cpu)),
                "flow_abs_median_px": float(np.median(np.abs(flows_cpu[0]))),
                "masks_agree": min(float((a == b).mean()) for a, b in zip(masks_card, masks_cpu)),
                "mask_share": [float(m.mean()) for m in masks_card],
                "ms_per_flow": ms,
                "profile": _device_profile(lambda: card.flow(img2, img1), 1, ms),
                "gflop_per_flow": flow_flops(model, card.iters, *img1.shape[1:]) / 1e9,
                "cpu_s_per_flow": cpu_s,
                "finite": bool(all(np.isfinite(f).all() for f in flows_card)),
            }
            out[name]["bound_ms"] = out[name]["gflop_per_flow"] * 1e9 / PEAK_FP32_OPS_S * 1e3
            log(f"perception {name}: " + json.dumps(out[name]))
            del card, cpu
        w = L.random_weights(torch.Generator().manual_seed(3), "cpu")
        w_card = L.LpipsWeights(*(tuple(t.cuda() for t in ts) for ts in w))
        a_card, b_card = img1.cuda(), img2.cuda()
        v_card = float(L.lpips_pair(w_card, a_card, b_card))
        v_cpu = float(L.lpips_pair(w, img1, img2))
        out["lpips"] = {"card": v_card, "cpu": v_cpu, "rel_err": abs(v_card - v_cpu) / abs(v_cpu),
                        "ms_per_pair": KC.cuda_ms(lambda: L.lpips_pair(w_card, a_card, b_card),
                                                  20)}
        log("perception lpips: " + json.dumps(out["lpips"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = (all(out[n]["finite"] and out[n]["max_abs_err_px"] <= FLOW_TOL
              and out[n]["masks_agree"] >= MASK_AGREE and out[n]["flow_abs_max_px"] > 0
              for n in nets)
          and out["lpips"]["rel_err"] <= 1e-4 and np.isfinite(out["lpips"]["card"]))
    if not ok:
        raise SystemExit(f"perception phase out of bounds: {out}")
    return out


@contextlib.contextmanager
def wrapped(cls, name, make):
    """While open, `cls.name` is `make(original)`."""
    original = getattr(cls, name)
    setattr(cls, name, make(original))
    try:
        yield
    finally:
        setattr(cls, name, original)


def flow_phase(wrappers) -> dict:
    """The command line with the network flow loss on a CoFusion-layout
    sequence (phase 9); returns its record, with the launches by number of
    views in `launches_by_views`."""
    import numpy as np
    import torch

    from fourdgs_torch import cli, convert
    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.data.synthetic import SyntheticDataset, write_cofusion_format
    from fourdgs_torch.perception import raft as R
    from fourdgs_torch.perception import yolov9 as Y
    from fourdgs_torch.perception.segmentation import Yolov9SegSegmenter
    from fourdgs_torch.perception.weights_io import save_pytree_npz
    from fourdgs_torch.slam.runner import SLAM

    tmp = tempfile.mkdtemp(prefix="fourdgs_flow_")
    cwd = os.getcwd()
    calls, chunks, views_without_flow = {}, [], []
    flow_s, last_pairs = [0.0], [0]
    seg_calls, seg_devices, seg_s = [0], set(), [0.0]

    def count_segments(call):
        def counted(self, img_u8, depth=None):
            seg_calls[0] += 1
            t = time.time()
            res = call(self, img_u8, depth)
            seg_s[0] += time.time() - t
            return res
        return counted

    def record_device(forward):
        def recorded(self, x):
            seg_devices.add(x.device.type)
            return forward(self, x)
        return recorded

    def count_calls(call):
        def counted(self, uid1, uid2, img1, img2):
            calls[(uid1, uid2)] = calls.get((uid1, uid2), 0) + 1
            torch.cuda.synchronize()
            t = time.time()
            res = call(self, uid1, uid2, img1, img2)
            flow_s[0] += time.time() - t
            return res
        return counted

    def check_views(flow_arrays):
        def checked(self, key_opt):
            pair_slots, fwd, bwd = flow_arrays(self, key_opt)
            for i, kf in enumerate(key_opt[:len(pair_slots)]):
                earlier = any(k < kf for k in self.kf_indices)
                if earlier != (pair_slots[i] >= 0) or (earlier and not bool(fwd[i].abs().any())):
                    views_without_flow.append(kf)
            last_pairs[0] = int((pair_slots >= 0).sum())
            return pair_slots, fwd, bwd
        return checked

    def per_chunk(map_dynamic):
        def chunk(self, total_iters, step_after):
            before = {w: dict(k.launches_by_views) for w, k in wrappers.items()}
            key_opt = map_dynamic(self, total_iters, step_after)
            chunks.append({"keyframe": key_opt[0], "window": list(key_opt),
                           "flow_pairs": last_pairs[0], "iters": total_iters,
                           "launches_by_views": {w: {v: n - before[w].get(v, 0)
                                                     for v, n in k.launches_by_views.items()
                                                     if n - before[w].get(v, 0)}
                                                 for w, k in wrappers.items()}})
            return key_opt
        return chunk

    try:
        t = time.time()
        seq = os.path.join(tmp, "seq")
        synthetic = SyntheticDataset(None, "", KC.bench_dynamic_config(FLOW_FRAMES), device="cuda")
        write_cofusion_format(synthetic, seq)
        c = synthetic.config["Dataset"]["Calibration"]
        del synthetic
        torch.cuda.empty_cache()
        cfg = os.path.join(tmp, "synthetic_cofusion_dynamic.yaml")
        with open(cfg, "w") as f:
            f.write(f"inherit_from: {os.path.join(HERE, 'configs/rgbd/cofusion/base_config.yaml')}\n"
                    "Results:\n  save_results: false\n"
                    f"Dataset:\n  dataset_path: {seq}\n  Calibration:\n"
                    + "".join(f"    {k}: {c[k]}\n" for k in ("fx", "fy", "cx", "cy", "width",
                                                            "height"))
                    + "    depth_scale: 5000.0\n    distorted: false\n"
                    "Training:\n  dystart: 8\n")
        os.makedirs(os.path.join(tmp, "pretrained"))
        raft = R.init_weights(R.RAFT(), torch.Generator().manual_seed(4))
        save_pytree_npz(os.path.join(tmp, "pretrained", "raft-things.npz"),
                        convert.flow_params(raft))
        yolo = Y.init_weights(Y.Yolov9SegNet(Y.YOLOV9E_SEG), torch.Generator().manual_seed(7))
        save_pytree_npz(os.path.join(tmp, "pretrained", "yolov9e-seg.npz"),
                        convert.yolo_params(yolo), meta={"cfg": Y.YOLOV9E_SEG})
        del yolo
        write_s = time.time() - t
        os.chdir(tmp)   # where the runner finds pretrained/
        for k in wrappers.values():
            k.launches_by_views.clear()
        with observe_stages(SLAM, wrappers) as seen, \
                wrapped(R.RaftFlowProvider, "__call__", count_calls), \
                wrapped(Yolov9SegSegmenter, "__call__", count_segments), \
                wrapped(Y.Yolov9Seg, "forward", record_device), \
                wrapped(SLAM, "_flow_arrays", check_views), \
                wrapped(SLAM, "_map_dynamic", per_chunk):
            metrics = cli.main(["--config", cfg, "--dynamic", "--interval", "5",
                                "--capacity", str(KC.CAPACITY)])
        by_views = {name: dict(k.launches_by_views) for name, k in wrappers.items()}
        slam = seen["slams"][0]
        t = time.time()
        ate = slam.eval_ate()["rmse"]
        rend = slam.eval_rendering()
        eval_s = time.time() - t
        masks = [m for *_, fm, bm in slam.flow_cache._cache.values() for m in (fm, bm)]
        flow_launches = {w: sum(n for ch in chunks if ch["flow_pairs"]
                                for n in ch["launches_by_views"][w].values()) for w in wrappers}
        out = {
            "frames": metrics["n_frames"], "keyframes": list(slam.kf_indices),
            "deform_init": slam.deform_init, "flow_weight": slam.flow_weight,
            "provider": type(slam.flow_cache.provider).__name__ if slam.flow_cache else None,
            "flow_pairs": sorted(slam.flow_cache._cache) if slam.flow_cache else [],
            "provider_calls": {f"{a},{b}": n for (a, b), n in calls.items()},
            "views_without_flow": views_without_flow, "chunks": chunks,
            "flow_view_launches": flow_launches,
            "ate_rmse_m": ate, "psnr": rend["mean_psnr"], "ssim": rend["mean_ssim"],
            "consistent_mask_share": float(np.mean([m.mean() for m in masks])) if masks else None,
            "gaussians": slam.gmap.num_alive,
            "dynamic_gaussians": int((slam.gmap.dygs & slam.gmap.alive).sum()),
            "seconds": {"write_sequence": write_s, **{k: v["s"] for k, v in seen["stages"].items()},
                        "flows": flow_s[0], "eval_after": eval_s, **metrics["phase_s"]},
            "launches_by_views": by_views, "centre_err_mm": centre_errors_mm(slam),
            "segmenter": type(slam.dataset.mask_fn).__name__, "segmenter_calls": seg_calls[0],
            "segmenter_forward_devices": sorted(seg_devices),
            "segmenter_s_per_frame": seg_s[0] / max(seg_calls[0], 1),
            "yolo_dynamic_px_per_frame": [int(slam.dataset.dynamic_masks[i].sum())
                                          for i in sorted(slam.dataset.dynamic_masks)],
        }
        out["seconds"]["segmentation"] = seg_s[0]
        finite = all(np.isfinite(slam.poses_est[i]).all() for i in slam.poses_est)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log("flow: " + json.dumps(out))
    ok = (out["flow_weight"] == 3.0 and out["provider"] == "RaftFlowProvider"
          and out["deform_init"] and out["flow_pairs"] and not views_without_flow
          and set(calls) == set(out["flow_pairs"]) and all(n == 1 for n in calls.values())
          and out["keyframes"] == [0, 5, 8, 13]
          and all(n == FLOW_VIEW_LAUNCHES for n in flow_launches.values()) and finite
          and out["segmenter"] == "Yolov9SegSegmenter" and seg_calls[0] == out["frames"]
          and len(out["yolo_dynamic_px_per_frame"]) == out["frames"]
          and out["segmenter_forward_devices"] == ["cuda"])
    if not ok:
        raise SystemExit(f"flow phase out of bounds: {out}")
    return out


def yolo_flops(h: int, w: int) -> float:
    """Float operations of one YOLOv9e-seg forward at h x w: its
    convolutions and the prototypes' transposed convolution, counted from
    their shapes on the meta device (two per multiply-add)."""
    import torch

    from fourdgs_torch.perception import yolov9 as Y

    total = [0.0]

    def conv(m, inp, out):
        total[0] += 2.0 * out.numel() * m.weight[0].numel()

    def transposed(m, inp, out):
        total[0] += 2.0 * inp[0].numel() * m.weight[0].numel()

    with torch.device("meta"):
        net = Y.Yolov9SegNet(Y.YOLOV9E_SEG)
    for m in net.modules():
        if isinstance(m, torch.nn.ConvTranspose2d):
            m.register_forward_hook(transposed)
        elif isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(conv)
    with torch.no_grad():
        net(torch.zeros(1, 3, h, w, device="meta"))
    return total[0]


def segmentation_phase() -> dict:
    """YOLOv9e-seg (phase 10) through the segmenter on the card and on the
    CPU, with the same seeded weights, on a 640x480 frame of the dynamic
    synthetic sequence."""
    import numpy as np
    import torch

    from fourdgs_torch import convert
    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.data.synthetic import SyntheticDataset
    from fourdgs_torch.perception import yolov9 as Y
    from fourdgs_torch.perception.segmentation import make_segmenter
    from fourdgs_torch.perception.weights_io import save_pytree_npz

    uid = 8   # dystart of the flow phase's sequence, the blob in view
    ds = SyntheticDataset(None, "", KC.bench_dynamic_config(FLOW_FRAMES), device="cuda")
    img_u8 = np.ascontiguousarray(
        (np.clip(np.asarray(ds[uid][0]), 0, 1) * 255).round().astype(np.uint8).transpose(1, 2, 0))
    del ds
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="fourdgs_segmentation_")
    try:
        path = os.path.join(tmp, "yolov9e-seg.npz")
        net = Y.init_weights(Y.Yolov9SegNet(Y.YOLOV9E_SEG), torch.Generator().manual_seed(6))
        with torch.no_grad():   # seeded scores peak on a few classes; person made likelier
            for branch in net.model[-1].cv3:
                branch[-1].bias[0] += SEG_PERSON_RAISE
        save_pytree_npz(path, convert.yolo_params(net), meta={"cfg": Y.YOLOV9E_SEG})
        n_params = sum(p.numel() for p in net.parameters())
        del net
        cfg = {"Dataset": {"yolo_weights": path, "seg_chair": True}}
        card, cpu = (make_segmenter(cfg, None, d) for d in ("cuda", "cpu"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    chw = img_u8.astype(np.float32).transpose(2, 0, 1) / 255.0
    lb, _, _ = Y.letterbox(chw, card.model.imgsz)
    outs_card = card.model.outputs(lb)
    t = time.time()
    outs_cpu = cpu.model.outputs(lb)
    cpu_s = time.time() - t
    names = ("boxes", "scores", "mask_coefs", "protos")
    errs = {n: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
            for n, a, b in zip(names, outs_card, outs_cpu)}
    # conf between the SEG_CANDIDATES-th and the next score of the
    # configured classes: that many detections go into NMS
    scores = outs_cpu[1]
    ours = np.isin(scores.argmax(1), card.classes)
    ranked = np.sort(scores.max(1)[ours])[::-1]
    conf = float((ranked[SEG_CANDIDATES - 1] + ranked[SEG_CANDIDATES]) / 2)
    sel = ours & (scores.max(1) >= conf)
    off = (scores.argmax(1)[sel, None] * 4096.0).astype(np.float32)
    kept = len(Y.nms_numpy(outs_cpu[0][sel] + off, scores.max(1)[sel]))
    masks = {}
    for name, seg in (("card", card), ("cpu", cpu)):
        seg.conf = conf
        masks[name] = seg(img_u8)

    def per_frame_ms(seg, frames=10):
        seg(img_u8)
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(frames):
            seg(img_u8)
        torch.cuda.synchronize()
        return (time.time() - t) * 1e3 / frames

    ms_low = per_frame_ms(card)
    card.conf = 0.25
    ms_default = per_frame_ms(card)
    x = torch.as_tensor(lb, device="cuda")[None]
    fwd_ms = KC.cuda_ms(lambda: card.model.forward(x), 10)
    gflop = yolo_flops(*lb.shape[1:]) / 1e9
    out = {
        "frame": uid, "parameters": n_params, "letterbox": list(lb.shape[1:]),
        "anchors": int(scores.shape[0]), "classes": card.classes,
        "rel_err": errs, "conf": conf, "candidates": int(sel.sum()), "kept_after_nms": kept,
        "detections_at_0.25": int((ours & (scores.max(1) >= 0.25)).sum()),
        "mask_share": float(masks["card"].mean()),
        "masks_agree": float((masks["card"] == masks["cpu"]).mean()),
        "ms_per_frame": ms_low, "ms_per_frame_conf_0.25": ms_default,
        "ms_per_forward": fwd_ms,
        "profile": _device_profile(lambda: card.model.forward(x), 1, fwd_ms),
        "gflop_per_frame": gflop, "bound_ms": gflop * 1e9 / PEAK_FP32_OPS_S * 1e3,
        "cpu_s_per_forward": cpu_s,
        "finite": bool(all(np.isfinite(o).all() for o in outs_card)),
    }
    log("segmentation: " + json.dumps(out))
    ok = (out["finite"] and max(errs.values()) <= SEG_TOL and out["masks_agree"] >= SEG_MASK_AGREE
          and out["candidates"] == SEG_CANDIDATES and out["mask_share"] > 0)
    if not ok:
        raise SystemExit(f"segmentation phase out of bounds: {out}")
    return out


MONO_FRAMES = 40   # the window of 8 fills at keyframe 35 (every fifth frame a keyframe)
RM_FRAMES = 10     # phase 5's run
RM_MASK_AGREE = 0.999   # reprojection masks, card against CPU


def monocular_config(seq: str):
    """The configuration of `bench.py` (KC.bench_config) on the TUM-layout
    sequence at `seq`, read without depth (`sensor_type: monocular`), with
    `Training.monocular`; no segmenter."""
    from fourdgs_torch import kernel_check as KC

    cfg = KC.bench_config(MONO_FRAMES)
    ds = cfg["Dataset"]
    ds.update(type="tum", dataset_path=seq, sensor_type="monocular")
    ds["Calibration"].update(depth_scale=5000.0, distorted=False)
    cfg["Training"]["monocular"] = True
    cfg["model_params"] = {"dynamic_model": False}
    return cfg


def trace_mapping_phases(slam, wrappers) -> list:
    """Record, for each keyframe mapping phase of `slam`, its iterations,
    the window's size, whether the map was initialised before and after,
    and each kernel's launches by number of views during it."""
    phases = []
    run_phase = slam._run_mapping

    def traced(total_iters, step_after):
        before = {w: dict(k.launches_by_views) for w, k in wrappers.items()}
        init_before = slam.initialized
        run_phase(total_iters, step_after)
        phases.append({"keyframe": slam.window[0], "iters": total_iters,
                       "window": len(slam.window), "initialized_before": init_before,
                       "initialized_after": slam.initialized,
                       "launches_by_views": {w: {v: n - before[w].get(v, 0)
                                                 for v, n in k.launches_by_views.items()
                                                 if n - before[w].get(v, 0)}
                                             for w, k in wrappers.items()}})

    slam._run_mapping = traced
    return phases


def sim3_ate(slam) -> float:
    """The APE RMSE after Sim(3) alignment (`evaluate_evo(monocular=True)`),
    its statistics written to a temporary directory."""
    import numpy as np

    from fourdgs_torch.eval.ate import evaluate_evo

    ids = sorted(slam.poses_est)
    tmp = tempfile.mkdtemp(prefix="fourdgs_sim3_")
    try:
        return evaluate_evo([np.linalg.inv(slam.dataset.poses[i]) for i in ids],
                            [np.linalg.inv(slam.poses_est[i]) for i in ids], tmp,
                            monocular=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def monocular_run(wrappers) -> dict:
    """`SLAM(cfg).run()` of the monocular configuration on bench.py's
    synthetic sequence, written in TUM layout to a temporary directory and
    read back without depth; returns its record."""
    import numpy as np
    import torch

    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.data.synthetic import SyntheticDataset, write_tum_format
    from fourdgs_torch.slam.runner import SLAM

    tmp = tempfile.mkdtemp(prefix="fourdgs_mono_")
    try:
        t = time.time()
        write_tum_format(SyntheticDataset(None, "", KC.bench_config(MONO_FRAMES), device="cuda"),
                         os.path.join(tmp, "seq"))
        write_s = time.time() - t
        slam = SLAM(monocular_config(os.path.join(tmp, "seq")), capacity=KC.CAPACITY,
                    max_capacity=KC.CAPACITY, max_keyframes=64)
        phases = trace_mapping_phases(slam, wrappers)
        for k in wrappers.values():
            k.launches_by_views.clear()
        metrics = slam.run()
        by_views = {name: dict(k.launches_by_views) for name, k in wrappers.items()}
        rend = slam.eval_rendering()
        out = {
            "frames": slam.n_frames, "has_depth": slam.dataset.has_depth,
            "depth_read": bool(slam.store.depths.any()),
            "ate_rmse_m": slam.eval_ate()["rmse"], "sim3_ate_rmse_m": sim3_ate(slam),
            "psnr": rend["mean_psnr"], "l1_depth": rend["mean_l1_depth"],
            "keyframes": list(slam.kf_indices), "window": list(slam.window),
            "initialized": slam.initialized, "initial_ba_at": metrics.get("initial_ba_at"),
            "resets": metrics.get("resets", 0), "gaussians": slam.gmap.num_alive,
            "phase_s": metrics["phase_s"], "write_sequence_s": write_s,
            "ms_per_track_iter": metrics["phase_s"]["track"] * 1e3
            / max(metrics["phase_s"]["track_iters"], 1),
            "mapping_phases": phases, "centre_err_mm": centre_errors_mm(slam),
            "finite": all(np.isfinite(slam.poses_est[i]).all() for i in slam.poses_est),
            "launches": {name: sum(n.values()) for name, n in by_views.items()},
            "launches_by_views": by_views,
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del slam
    torch.cuda.empty_cache()
    return out


def check_monocular(out: dict) -> list:
    """What phase 12 holds of the monocular run; the failures."""
    bad = []
    if out["has_depth"] or out["depth_read"]:
        bad.append("depth was read")
    if not out["finite"]:
        bad.append("non-finite pose")
    ba = [p for p in out["mapping_phases"] if p["iters"] == 300]
    if out["initialized"]:
        # the initial bundle adjustment: one 300-iteration phase at the full
        # window, each of its iterations one launch of each kernel at the
        # mapping's number of views
        ok = (len(ba) == 1 and not ba[0]["initialized_before"] and ba[0]["initialized_after"]
              and ba[0]["window"] == 8
              and len(ba[0]["launches_by_views"]["composite_bwd"]) == 1
              and sum(ba[0]["launches_by_views"]["composite_bwd"].values()) == 300)
        if not ok:
            bad.append(f"no initial bundle adjustment at the full window: {ba}")
    elif out["resets"] < 1:
        bad.append("neither initialised nor reset")
    if not (out["sim3_ate_rmse_m"] < 0.08 and out["psnr"] > 14):
        bad.append("Sim(3) ATE or PSNR out of bounds")
    if min(out["launches"].values()) <= 0:
        bad.append("a kernel never launched")
    return bad


def rm_initdy_run(wrappers) -> dict:
    """Phase 5's run with `Training.rm_initdy`; each phase's reprojection
    masks, made on the card, held against the port's CPU `reproject_mask`
    on the same inputs."""
    import numpy as np
    import torch

    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.slam import keyframes as kfs
    from fourdgs_torch.slam.runner import SLAM

    cfg = KC.bench_config(40)
    cfg["Training"]["rm_initdy"] = True
    slam = SLAM(cfg, max_frames=RM_FRAMES, capacity=KC.CAPACITY, max_capacity=KC.CAPACITY,
                max_keyframes=64)
    made = []
    reproject = slam._reproject_masks

    def traced(key_opt):
        anchor = slam.kf_slot[slam.kf_indices[0]]
        inputs = [(slam.store.depths[anchor].cpu(), slam.store.motion[anchor].cpu(),
                   slam.store.T_cw[anchor].cpu(), slam.store.T_cw[slam.kf_slot[kf]].cpu())
                  for kf in key_opt]
        torch.cuda.synchronize()
        t = time.time()
        masks = reproject(key_opt)
        torch.cuda.synchronize()
        made.append({"keyframes": list(key_opt), "ms": (time.time() - t) * 1e3,
                     "device": masks.device.type, "inputs": inputs,
                     "masks": masks[:len(key_opt)].cpu()})
        return masks

    slam._reproject_masks = traced
    for k in wrappers.values():
        k.launches_by_views.clear()
    metrics = slam.run()
    by_views = {name: dict(k.launches_by_views) for name, k in wrappers.items()}
    # the masks again, warm: the first call above pays for the operators'
    # first use on the card
    key_opt = made[-1]["keyframes"]
    reproject(key_opt)
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(10):
        reproject(key_opt)
    torch.cuda.synchronize()
    warm_ms = (time.time() - t) * 1e3 / (10 * len(key_opt))
    rend = slam.eval_rendering()
    intr = slam.intr
    mask_phases = []
    for m in made:
        agree = []
        for (depth, static, T_a, T_c), got in zip(m["inputs"], m["masks"]):
            want = kfs.reproject_mask(depth, static, T_a, T_c, fx=intr.fx, fy=intr.fy,
                                      cx=intr.cx, cy=intr.cy)
            agree.append(float((want == got).to(torch.float32).mean()))
        mask_phases.append({"keyframes": m["keyframes"], "ms": m["ms"], "device": m["device"],
                            "ms_per_mask": m["ms"] / max(len(m["keyframes"]), 1),
                            "removed_share": [float((~g).to(torch.float32).mean())
                                              for g in m["masks"]],
                            "agree_with_cpu": agree})
    out = {"ate_rmse_m": slam.eval_ate()["rmse"], "psnr": rend["mean_psnr"],
           "l1_depth": rend["mean_l1_depth"], "keyframes": list(slam.kf_indices),
           "gaussians": slam.gmap.num_alive, "phase_s": metrics["phase_s"],
           "mask_phases": mask_phases, "ms_per_mask_warm": warm_ms,
           "centre_err_mm": centre_errors_mm(slam),
           "finite": all(np.isfinite(slam.poses_est[i]).all() for i in slam.poses_est),
           "launches": {name: sum(n.values()) for name, n in by_views.items()},
           "launches_by_views": by_views}
    del slam
    torch.cuda.empty_cache()
    return out


def monocular_phase(wrappers) -> dict:
    """Phase 12: the monocular run on the card, then the rm_initdy run."""
    t = time.time()
    log(f"monocular: {MONO_FRAMES} frames of bench.py's sequence at its widths, in TUM "
        "layout, read without depth; capacity 2^15, iteration counts, window 8 + 2 replay "
        "unchanged")
    mono = monocular_run(wrappers)
    mono["seconds"] = time.time() - t
    log("monocular: " + json.dumps(mono))
    if not mono["initialized"]:
        log(f"monocular: the window never filled; {mono['resets']} recoveries (_reset)")
    bad = check_monocular(mono)
    if bad:
        raise SystemExit(f"monocular phase out of bounds: {bad}")

    t = time.time()
    rm = rm_initdy_run(wrappers)
    rm["seconds"] = time.time() - t
    log("rm_initdy: " + json.dumps(rm))
    ok = (rm["ate_rmse_m"] < 0.05 and rm["psnr"] > 15 and rm["l1_depth"] < 1.2 and rm["finite"]
          and rm["mask_phases"] and min(rm["launches"].values()) > 0
          and all(m["device"] == "cuda" and min(m["agree_with_cpu"]) >= RM_MASK_AGREE
                  for m in rm["mask_phases"]))
    if not ok:
        raise SystemExit(f"rm_initdy phase out of bounds: {rm}")
    return {"monocular": mono, "rm_initdy": rm}


MESH_RANKS = 2
MESH_ITERS = 20   # the bounded static chunk of phase 13
MESH_DYN_ITERS = 5   # the timed 4D chunk of phase 13 (against one of 1 iteration)
MAIN_VIEWS = 10   # of the 4D window's 26 views, the main ones (flow views after them)
MESH_FRAMES = 10  # phase 5's run, on the mesh


def mesh_state(dynamic: bool):
    """A runner at the benchmark's widths and capacity (the dynamic one's
    with `dynamic`) whose map had 100 initialisation iterations on frame 0,
    with frames 1-9 stored as keyframes in slots 1-9 at their ground-truth
    poses moved by a seeded perturbation; with `dynamic`, the deformation
    field made at frame 8 (dystart) as the runner makes it. Returns (slam,
    frames)."""
    import numpy as np
    import torch

    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.data.prefetch import iter_frames
    from fourdgs_torch.geometry.se3 import se3_exp
    from fourdgs_torch.slam import keyframes as kfs
    from fourdgs_torch.slam.runner import SLAM

    cfg = KC.bench_dynamic_config(40) if dynamic else KC.bench_config(40)
    cfg["Training"]["init_itr_num"] = 100
    slam = SLAM(cfg, dynamic=dynamic, max_frames=10, capacity=KC.CAPACITY,
                max_capacity=KC.CAPACITY, max_keyframes=64)
    frames = dict(iter_frames(slam.dataset, slam.edge_threshold, 10, device=slam.device))
    slam._initialize(frames[0])
    rng = np.random.default_rng(13)
    for k in range(1, 10):
        tau = torch.tensor(rng.normal(0, [0.01, 0.01, 0.01, 0.003, 0.003, 0.003]),
                           dtype=torch.float32, device=slam.device)
        T = se3_exp(tau) @ slam._pose_tensor(slam.dataset.poses[k])
        kfs.store_keyframe(slam.store, k, frames[k], T, np.zeros(2))
        slam.kf_slot[k], slam.poses_est[k], slam.exposures[k] = k, T.cpu().numpy(), np.zeros(2)
        slam.kf_indices.append(k)
    if dynamic and not slam._init_deform(8, frames[8]):
        raise SystemExit("mesh phase: no dynamic pixel at frame 8")
    return slam, frames


WINDOW_SLOTS = list(range(1, 9))   # phase 13's window: 8 keyframes; replay from slots 0, 9


def mesh_static_chunk(slam, iters: int, mesh):
    """`iters` static mapping iterations over the full window (8 views and
    2 replay views, poses of the first 3 optimized) from the state of
    `mesh_state`, on one device (mesh None) or the mesh; binned every
    iteration on both. Returns (result, seconds)."""
    import numpy as np
    import torch

    from fourdgs_torch.slam.keyframes import KeyframeStore
    from fourdgs_torch.slam.mapping import init_pose_adam, map_chunk

    store = KeyframeStore(*(x.clone() for x in slam.store))
    picks = np.stack([np.arange(iters) % 2, np.zeros(iters, np.int64)], 1)
    torch.cuda.synchronize()
    t = time.time()
    res = map_chunk(slam.gmap, slam.adam, store, np.asarray(WINDOW_SLOTS), np.ones(8, bool),
                    np.arange(8) < 3, np.asarray([0, 9]), 2, init_pose_adam(8, slam.device),
                    picks, iters, -1, 0, slam.intr, slam.map_cfg._replace(rebin_every=1),
                    mesh=mesh)
    torch.cuda.synchronize()
    return res, time.time() - t


def mesh_dynamic_chunk(slam, flows, mesh, iters: int):
    """`iters` 4D mapping iterations over the full 4D window (8 window
    views, each with its flow pair: the keyframe before it, 2 replay views:
    26 views) from the state of `mesh_state(dynamic=True)`, binned every
    iteration, with the draws of a runner seeded alike on every call.
    Returns (result, seconds)."""
    import numpy as np
    import torch

    from fourdgs_torch.slam import mapping_dynamic as mdyn
    from fourdgs_torch.slam.keyframes import KeyframeStore
    from fourdgs_torch.slam.mapping import init_pose_adam
    from fourdgs_torch.utils.draws import TorchDraws

    store = KeyframeStore(*(x.clone() for x in slam.store))
    draws = TorchDraws(7, slam.device).dynamic_chunk(iters, 2, slam.map_cfg.num_views)
    torch.cuda.synchronize()
    t = time.time()
    res = mdyn.map_chunk_dynamic(
        slam.gmap, slam.adam, store, slam.deform, slam.deform_adam, np.asarray(WINDOW_SLOTS),
        np.ones(8, bool), np.arange(8) < 3, np.asarray(WINDOW_SLOTS) - 1, *flows,
        np.asarray([0, 9]), 2, init_pose_adam(8, slam.device), draws, iters, -1, 0, slam.intr,
        slam.map_cfg._replace(rebin_every=1), flow_weight=slam.flow_weight,
        flow_weight_fine=slam.flow_weight_fine, time_interval=slam.time_interval, mesh=mesh)
    torch.cuda.synchronize()
    return res, time.time() - t


def mesh_blocks() -> list:
    """(views, of which carry flow payloads) of each rank's block of the
    4D window in phase 13: [MAIN_VIEWS main | 16 flow] views over
    MESH_RANKS ranks, as `map_chunk_dynamic` splits them."""
    import numpy as np

    from fourdgs_torch.slam.mapping import rank_block

    ids = np.arange(26)
    return [(int(b.size), int((b >= MAIN_VIEWS).sum()))
            for b in (rank_block(ids, r, MESH_RANKS) for r in range(MESH_RANKS))]


def rank_launches(mesh, wrappers, call):
    """`call()` with rank 0's kernel counts set to 0 just before it.
    Returns (its result, each rank's launches during it: rank -> kernel ->
    number of views -> count)."""
    import copy

    for k in wrappers.values():
        k.launches_by_views.clear()
    before = copy.deepcopy(mesh.launches)
    out = call()
    by_rank = {0: {name: dict(k.launches_by_views) for name, k in wrappers.items()}}
    for r, kernels in mesh.launches.items():
        was = before.get(r, {})
        by_rank[r] = {name: {v: n - was.get(name, {}).get(v, 0) for v, n in by_v.items()
                             if n > was.get(name, {}).get(v, 0)}
                      for name, by_v in kernels.items()}
    return out, by_rank


def launches_held(by_rank, wrappers, held_views) -> bool:
    """Every rank launched every kernel, at numbers of views held in
    phase 3 only."""
    return all(by_rank.get(r, {}).get(name) and set(by_rank[r][name]) <= held_views
               for r in range(MESH_RANKS) for name in wrappers)


def comm_since(mesh, before) -> dict:
    """Rank 0's collectives since the `before` copy of its stats."""
    return {k: {f: v[f] - before[k][f] for f in ("calls", "bytes", "seconds")}
            for k, v in mesh.comm.stats.items()}


def _max_diff(a, b) -> float:
    return float((a - b).abs().max())


def _map_diffs(a, b) -> dict:
    """Largest differences of two chunk results: loss (relative), each
    map field, the store's poses, denom and grad_accum."""
    d = {name: _max_diff(getattr(a.gmap.params, name), getattr(b.gmap.params, name))
         for name in ("xyz", "f_dc", "scaling", "rotation", "opacity")}
    d.update(loss_rel=abs(a.final_loss - b.final_loss) / max(abs(b.final_loss), 1e-30),
             T_cw=_max_diff(a.store.T_cw, b.store.T_cw),
             denom=_max_diff(a.gmap.denom, b.gmap.denom),
             grad_accum=_max_diff(a.gmap.grad_accum, b.gmap.grad_accum))
    return d


def mesh_chunks(mesh, wrappers, held_views) -> dict:
    """Phase 13 (a) and (b) on `mesh`: the static window after 1 and after
    MESH_ITERS iterations, and the 4D window after 1, each against one
    device, every rank's launches at numbers of views in `held_views`;
    with ms per iteration and the collectives' cost, and the 4D window
    timed at 1 and MESH_DYN_ITERS iterations."""
    import numpy as np
    import torch

    from fourdgs_torch.models.deform import cn_floats, leaves

    out = {"ranks": mesh.size, "backend": mesh.backend,
           "devices": [str(d) for d in mesh.devices]}
    bad = []
    slam, _ = mesh_state(dynamic=False)
    one, _ = mesh_static_chunk(slam, 1, None)
    sh, _ = mesh_static_chunk(slam, 1, mesh)
    d1 = _map_diffs(sh, one)
    out["static_1"] = d1
    # tests/test_parallel.py:88-101
    if not (d1["loss_rel"] <= 1e-5 and max(d1[k] for k in ("xyz", "f_dc", "scaling",
                                                            "rotation", "opacity")) <= 2e-5
            and d1["T_cw"] <= 1e-5 and d1["denom"] == 0 and d1["grad_accum"] <= 1e-5):
        bad.append("static_1")
    one, t_one = mesh_static_chunk(slam, MESH_ITERS, None)
    before = {k: dict(v) for k, v in mesh.comm.stats.items()}
    (sh, t_sh), out["static_launches_by_rank"] = rank_launches(
        mesh, wrappers, lambda: mesh_static_chunk(slam, MESH_ITERS, mesh))
    st = comm_since(mesh, before)
    out["static_call_s"] = mesh.seconds
    if not launches_held(out["static_launches_by_rank"], wrappers, held_views):
        bad.append("static_launches")
    dn = _map_diffs(sh, one)
    finite = all(bool(torch.isfinite(x).all()) for x in sh.gmap.params)
    out["static_n"] = dict(dn, iters=MESH_ITERS, finite=finite)
    # tests/test_parallel.py:231-258, the chunk after the densify
    if not (finite and dn["loss_rel"] <= 2e-3 and dn["T_cw"] <= 2e-3
            and max(dn[k] for k in ("xyz", "f_dc", "scaling", "rotation", "opacity")) <= 3e-2):
        bad.append("static_n")
    ar = st["allreduce"]
    out["ms_per_iter_one_device"] = t_one * 1e3 / MESH_ITERS
    out["ms_per_iter_mesh"] = t_sh * 1e3 / MESH_ITERS
    out["collective_ms_per_iter"] = (ar["seconds"] * 1e3) / MESH_ITERS
    out["allreduce_calls_per_iter"] = ar["calls"] / MESH_ITERS
    out["allreduce_bytes_per_iter"] = ar["bytes"] / MESH_ITERS
    out["largest_allreduce_bytes"] = mesh.comm.stats["allreduce"]["largest"]
    out["broadcast_per_chunk"] = st["broadcast"]
    del slam
    torch.cuda.empty_cache()

    slam, frames = mesh_state(dynamic=True)
    flows = [[], []]
    for uid in WINDOW_SLOTS:
        from fourdgs_torch.slam import keyframes as kfs

        imgs = kfs.fetch_images(slam.store, [uid, uid - 1])
        fwd, bwd, _, _ = slam.flow_cache.get(uid, uid - 1, imgs[0], imgs[1])
        flows[0].append(fwd)
        flows[1].append(bwd)
    flows = [torch.as_tensor(np.stack(f), device=slam.device) for f in flows]
    one, t_one = mesh_dynamic_chunk(slam, flows, None, 1)
    # the workers' first 4D call, held; then the same call again, timed
    sh, t_first = mesh_dynamic_chunk(slam, flows, mesh, 1)
    first_s = mesh.seconds
    before = {k: dict(v) for k, v in mesh.comm.stats.items()}
    (_, t_sh), launches = rank_launches(mesh, wrappers,
                                        lambda: mesh_dynamic_chunk(slam, flows, mesh, 1))
    comm_1, call_1 = comm_since(mesh, before), mesh.seconds
    n = MESH_DYN_ITERS
    one_n, t_one_n = mesh_dynamic_chunk(slam, flows, None, n)
    before = {k: dict(v) for k, v in mesh.comm.stats.items()}
    sh_n, t_sh_n = mesh_dynamic_chunk(slam, flows, mesh, n)
    comm_n, call_n = comm_since(mesh, before), mesh.seconds
    dd = _map_diffs(sh, one)
    dd["deform"] = max(_max_diff(a, b) for a, b in zip(leaves(cn_floats(sh.deform)),
                                                       leaves(cn_floats(one.deform))))
    per_one, per_mesh = (t_one_n - t_one) / (n - 1), (t_sh_n - t_sh) / (n - 1)
    dd.update(ms_one_device=t_one * 1e3, ms_mesh_first_call=t_first * 1e3, ms_mesh=t_sh * 1e3,
              iters_n=n, ms_one_device_n=t_one_n * 1e3, ms_mesh_n=t_sh_n * 1e3,
              ms_per_iter_one_device=per_one * 1e3, ms_per_iter_mesh=per_mesh * 1e3,
              ms_per_chunk_one_device=(t_one - per_one) * 1e3,
              ms_per_chunk_mesh=(t_sh - per_mesh) * 1e3,
              call_s_first=first_s, call_s_1=call_1, call_s_n=call_n,
              comm_1=comm_1, comm_n=comm_n, launches_by_rank=launches,
              finite_n=all(bool(torch.isfinite(x).all()) for x in sh_n.gmap.params)
              and all(bool(torch.isfinite(x).all()) for x in one_n.gmap.params),
              dynamic_gaussians=int((slam.gmap.dygs & slam.gmap.alive).sum()))
    out["dynamic_1"] = dd
    if not launches_held(launches, wrappers, held_views):
        bad.append("dynamic_launches")
    if not dd["finite_n"]:
        bad.append("dynamic_n")
    # tests/test_parallel.py:150-168
    if not (dd["loss_rel"] <= 1e-5 and max(dd[k] for k in ("xyz", "f_dc", "scaling",
                                                            "rotation", "opacity")) <= 2e-5
            and dd["deform"] <= 2e-4 and dd["T_cw"] <= 1e-5 and dd["grad_accum"] <= 1e-5):
        bad.append("dynamic_1")
    out["bad"] = bad
    del slam
    torch.cuda.empty_cache()
    return out


def mesh_phase(wrappers, held_views) -> dict:
    """Phase 13: multi-device mapping. 2 ranks sharing cuda:0 over gloo
    (and, with two cards or more, 2 ranks on cuda:0 and cuda:1 over NCCL):
    (a) and (b) `mesh_chunks`; (c) phase 5's run with the runner's mesh
    (`slam.mesh`) the 2 ranks on cuda:0, held to phase 5's limits, every
    rank launching both kernels. `held_views`: the numbers of views
    phase 3 held the kernels at."""
    import numpy as np
    import torch

    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.parallel import make_mesh
    from fourdgs_torch.parallel.comm import exercise
    from fourdgs_torch.slam.runner import SLAM

    placements = [["cuda:0"] * MESH_RANKS]
    if torch.cuda.device_count() >= MESH_RANKS:
        placements.append([f"cuda:{i}" for i in range(MESH_RANKS)])
    out = {"runs": []}
    for devices in placements:
        with make_mesh(MESH_RANKS, devices) as mesh:
            x = torch.randn((MESH_RANKS, 4 * MESH_RANKS, 3), device=mesh.devices[0])
            got = mesh.run(exercise, x)
            ok = (torch.allclose(got["psum"], x.sum(0), rtol=1e-6, atol=1e-6)
                  and torch.equal(got["all_gather"], x.reshape(-1, 3))
                  and torch.equal(got["pmax"], x.max(0).values))
            r = mesh_chunks(mesh, wrappers, held_views)
            r["collectives_ok"] = ok
            out["runs"].append(r)
            log("mesh chunks: " + json.dumps(r))
            if r["bad"] or not ok:
                raise SystemExit(f"mesh phase: sharded chunks disagree with one device: {r}")
    out["backends"] = [r["backend"] for r in out["runs"]]

    slam = SLAM(KC.bench_config(40), max_frames=MESH_FRAMES, capacity=KC.CAPACITY,
                max_capacity=KC.CAPACITY, max_keyframes=64)
    mesh = make_mesh(MESH_RANKS, ["cuda:0"] * MESH_RANKS)
    slam.mesh = mesh
    for k in wrappers.values():
        k.launches_by_views.clear()
    metrics = slam.run()
    by_rank = {0: {name: dict(k.launches_by_views) for name, k in wrappers.items()}}
    by_rank.update({r: {name: dict(v) for name, v in ks.items()}
                    for r, ks in mesh.launches.items()})
    rend = slam.eval_rendering()
    ate = slam.eval_ate()["rmse"]
    run = {"ate_rmse_m": ate, "psnr": rend["mean_psnr"], "l1_depth": rend["mean_l1_depth"],
           "keyframes": list(slam.kf_indices), "gaussians": slam.gmap.num_alive,
           "phase_s": metrics["phase_s"], "mesh_calls": mesh.calls,
           "launches_by_rank": by_rank, "centre_err_mm": centre_errors_mm(slam),
           "workers_imported": mesh.imported}
    out["slam"] = run
    log("mesh slam: " + json.dumps(run))
    if not (ate < 0.05 and rend["mean_psnr"] > 15 and rend["mean_l1_depth"] < 1.2):
        raise SystemExit(f"mesh SLAM result out of bounds: {run}")
    if not all(np.isfinite(slam.poses_est[i]).all() for i in slam.poses_est):
        raise SystemExit("non-finite pose in the mesh phase")
    if not launches_held(by_rank, wrappers, held_views):
        raise SystemExit("a rank of the mesh SLAM run launched a kernel no time, or at a number "
                         f"of views phase 3 did not hold: {by_rank}")
    if any(run["workers_imported"]):
        raise SystemExit(f"a mesh worker imported jax or fourdgs: {run['workers_imported']}")
    del slam
    torch.cuda.empty_cache()
    return out


# ---- phase 14: the last modules (the live viewer, view_ply, the fields,
# batch_eval, RealSense) on the card, on phase 5's finished map

RENDER_TOL = {"color": 2e-5, "depth": 2e-4}   # tests/test_rasterizer.py's
# The viewer's renders, card against a CPU copy of the map: the two
# devices' float32 projections round differently (entries of the
# compositor's inputs part by 1e-3 and more, viewer_agreement.py). A
# pixel's sum then drifts past RENDER_TOL here and there, and a Gaussian
# whose alpha lies at the 1/255 cut is applied at a pixel on one device and
# not on the other, which moves that pixel by less than 1/255. So the
# renders are held within RENDER_TOL on RENDER_AGREE of pixels (at most 30
# of 640x480, under one 16x16 tile), the colour PNGs within one level on
# every value, and the kernel on the viewer's own inputs equal to its plain
# version on the card.
RENDER_AGREE = 0.9999
VIEWER_UPDATES = 3       # maybe_update calls on the card (2 forward launches each)
VIEW_PLY_FRAMES = 4
FIELD_POINTS = 1 << 15   # bench.py's capacity
FIELD_TOL = 1e-5         # field values, of each output's largest magnitude, card against CPU
FIELD_GRAD_TOL = 1e-4    # field gradients, of each field's largest magnitude
# acc_loss's gradients: its second difference cancels (node positions
# against differences a thousand times smaller), so float32 rounding reaches
# about 1e-5 of the largest gradient between two CPUs already
# (tests/test_torch_deform.py)
ACC_GRAD_TOL = 1e-3
NODES = 512              # bench.py --dynamic's control nodes
BATCH_FRAMES = 15        # scripts/batch_eval.py's default synthetic length


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ctl(port: int, query: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/ctl?{query}", timeout=5) as r:
        return json.loads(r.read())


def _agree(a, b, tol: float) -> dict:
    """Share of pixels within tol (over every channel), and the largest
    difference."""
    d = (a.detach().float().cpu() - b.detach().float().cpu()).abs()
    if d.dim() == 3:
        d = d.amax(0)
    return {"within": float((d <= tol).float().mean()), "max_abs": float(d.max())}


def _png_levels(a, b) -> int:
    """Largest difference of two colour renders as the viewer's PNGs hold
    them (gui/viewer.py _save_png), in 8-bit levels."""
    import numpy as np

    u8 = lambda x: (np.clip(x.detach().cpu().numpy(), 0, 1) * 255).astype(np.uint8)  # noqa: E731
    return int(np.abs(u8(a).astype(int) - u8(b).astype(int)).max())


def _same_inputs(calls) -> dict:
    """The card's compositor calls held against the plain version on the
    same inputs on the card: equal, as phase 3 holds the kernels
    (kernel_check.hold)."""
    import torch

    from fourdgs_torch.ops.rasterize import compositor as C

    err = {"max_abs": 0.0, "unequal_calls": 0}
    for fields, bins, grid, got in calls:
        ref = C.composite_forward_plain(fields, bins, grid)
        err["max_abs"] = max(err["max_abs"], float((got[0] - ref[0]).abs().max()))
        err["unequal_calls"] += not all(torch.equal(a, b) for a, b in zip(got, ref))
    return {"calls": len(calls), "err": err, "ok": err["unequal_calls"] == 0}


def _launches(wrappers) -> dict:
    return {name: dict(k.launches_by_views) for name, k in wrappers.items()}


def viewer_check(slam, wrappers) -> dict:
    """The live viewer on phase 5's map: pause, resume and orbit over HTTP,
    VIEWER_UPDATES updates at the last frame on the card (launches
    counted), one on a CPU copy of the map, the renders compared; the
    first update's compositor calls held on their own inputs."""
    import types

    import numpy as np
    import torch

    from fourdgs_torch import convert
    from fourdgs_torch.gui import viewer as V
    from fourdgs_torch.ops.rasterize import compositor as C

    tmp = tempfile.mkdtemp(prefix="fourdgs_gui_")
    renders = {}
    render_views = V.render_views
    composite_forward = C.composite_forward
    calls = []   # the card's first two compositor calls: inputs and outputs

    def holding(fields, bins, grid):
        out = composite_forward(fields, bins, grid)
        if fields.is_cuda and len(calls) < 2:
            calls.append((fields, bins, grid, out))
        return out

    render_ms = []

    def recording(s, T, orbit):
        dev = torch.device(s.device).type
        if dev == "cuda":
            torch.cuda.synchronize()
        t = time.time()
        out = render_views(s, T, orbit)
        if dev == "cuda":
            torch.cuda.synchronize()
            render_ms.append((time.time() - t) * 1e3)
        renders[dev] = out
        return out

    V.render_views = recording
    C.composite_forward = holding
    port = _free_port()
    frame = max(slam.poses_est)
    try:
        view = V.LiveViewer(os.path.join(tmp, "cuda"), interval=1, serve_port=port)
        try:
            paused = _ctl(port, "cmd=pause")["paused"]
            view.wait_if_paused(timeout=0.2)   # returns after its timeout: still paused
            held = view.paused
            resumed = _ctl(port, "cmd=resume")["paused"] is False
            _ctl(port, "cmd=orbit&yaw=30&x=-20")
            orbit = view.orbit.copy()
            for k in wrappers.values():
                k.launches_by_views.clear()
            ms = []
            for _ in range(VIEWER_UPDATES):
                torch.cuda.synchronize()
                t = time.time()
                snap = view.maybe_update(slam, frame)
                torch.cuda.synchronize()
                ms.append((time.time() - t) * 1e3)
            launches = _launches(wrappers)
            with open(os.path.join(view.dir, "status.json")) as f:
                status = json.load(f)
            rows = np.fromfile(os.path.join(view.dir, "points.bin"), np.float32).reshape(-1, 7)
        finally:
            view.close()
        try:
            _ctl(port, "cmd=resume")
            port_freed = False
        except OSError:
            port_freed = True
        cpu = types.SimpleNamespace(
            gmap=convert.gaussian_map_from_arrays(convert.gaussian_map_to_arrays(slam.gmap),
                                                  "cpu"),
            poses_est=slam.poses_est, intr=slam.intr, map_cfg=slam.map_cfg,
            kf_indices=slam.kf_indices, device=torch.device("cpu"))
        cpu_view = V.LiveViewer(os.path.join(tmp, "cpu"), interval=1)
        cpu_view.orbit = orbit
        t = time.time()
        cpu_view.maybe_update(cpu, frame)
        cpu_ms = (time.time() - t) * 1e3
    finally:
        V.render_views = render_views
        C.composite_forward = composite_forward
        shutil.rmtree(tmp, ignore_errors=True)
    (cur, novel), (ccur, cnovel) = renders["cuda"], renders["cpu"]
    n_alive = slam.gmap.num_alive
    step = -(-n_alive // (1 << 15)) if n_alive > (1 << 15) else 1
    out = {"frame": frame, "orbit": orbit.tolist(), "paused": paused, "held_while_paused": held,
           "resumed": resumed, "port_freed": port_freed, "status": status,
           "snapshot": {"n_gaussians": snap.n_gaussians, "n_dynamic": snap.n_dynamic},
           "points_rows": int(rows.shape[0]), "points_expected": len(range(0, n_alive, step)),
           "ms_per_update": ms, "render_ms_per_update": render_ms,
           "cpu_ms_per_update": cpu_ms, "launches_by_views": launches,
           "same_inputs": _same_inputs(calls),
           "current": _agree(cur.color, ccur.color, RENDER_TOL["color"]),
           "novel": _agree(novel.color, cnovel.color, RENDER_TOL["color"]),
           "depth": _agree(cur.depth, ccur.depth, RENDER_TOL["depth"]),
           "png_levels": max(_png_levels(cur.color, ccur.color),
                             _png_levels(novel.color, cnovel.color)),
           # Gaussians applied at a different number of pixels on the two devices
           "n_touched_differs": int((cur.n_touched.cpu() != ccur.n_touched).sum()
                                    + (novel.n_touched.cpu() != cnovel.n_touched).sum()),
           "novel_differs": float((cur.color - novel.color).abs().max())}
    fwd, bwd = launches["composite_fwd"], launches["composite_bwd"]
    ok = (paused and held and resumed and port_freed and status["frame"] == frame
          and not status["paused"] and out["points_rows"] == out["points_expected"]
          and fwd == {1: 2 * VIEWER_UPDATES} and not bwd and out["novel_differs"] > 0.05
          and out["same_inputs"]["calls"] == 2 and out["same_inputs"]["ok"]
          and out["png_levels"] <= 1
          and all(out[k]["within"] >= RENDER_AGREE for k in ("current", "novel", "depth")))
    out["ok"] = ok
    return out


def view_ply_check(slam, wrappers) -> dict:
    """fourdgs_torch.view_ply.main on phase 5's map saved as PLY:
    VIEW_PLY_FRAMES orbit frames at 640x480 on the card (launches counted)
    and on the CPU, the PNGs compared."""
    import numpy as np
    import torch
    from PIL import Image

    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch import view_ply as VP
    from fourdgs_torch.io.ply import save_gaussians_ply

    tmp = tempfile.mkdtemp(prefix="fourdgs_ply_")
    try:
        ply = os.path.join(tmp, "point_cloud.ply")
        n = save_gaussians_ply(slam.gmap, ply)
        common = [ply, "--frames", str(VIEW_PLY_FRAMES)]
        for k in wrappers.values():
            k.launches_by_views.clear()
        torch.cuda.synchronize()
        t = time.time()
        cuda_paths = VP.main(common + ["--out", os.path.join(tmp, "cuda")])
        torch.cuda.synchronize()
        ms = (time.time() - t) * 1e3 / VIEW_PLY_FRAMES
        launches = _launches(wrappers)
        t = time.time()
        cpu_paths = VP.main(common + ["--out", os.path.join(tmp, "cpu"), "--device", "cpu"])
        cpu_ms = (time.time() - t) * 1e3 / VIEW_PLY_FRAMES
        diffs = [np.abs(np.asarray(Image.open(a)).astype(int) - np.asarray(Image.open(b))
                        .astype(int)) for a, b in zip(cuda_paths, cpu_paths)]
        shape = np.asarray(Image.open(cuda_paths[0])).shape
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"gaussians": n, "frames": len(cuda_paths), "shape": list(shape),
           "ms_per_frame": ms, "cpu_ms_per_frame": cpu_ms, "launches_by_views": launches,
           "within_one_level": min(float((d <= 1).mean()) for d in diffs),
           "max_level_diff": int(max(d.max() for d in diffs))}
    out["ok"] = (out["frames"] == VIEW_PLY_FRAMES and shape == (KC.HEIGHT, KC.WIDTH, 3)
                 and launches["composite_fwd"] == {1: VIEW_PLY_FRAMES}
                 and not launches["composite_bwd"] and out["max_level_diff"] <= 1)
    return out


def _field_grads(fn, params, x, cots):
    """Outputs of fn(params, x) and the gradients of sum(out * cot) with
    respect to params and x, on the device of x, with the ms of the forward
    and backward."""
    import torch

    params = [p.detach().clone().requires_grad_(True) for p in params]
    x = x.detach().clone().requires_grad_(True)
    if x.is_cuda:
        torch.cuda.synchronize()
    t = time.time()
    outs = fn(params, x)
    grads = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(outs, cots)), params + [x])
    if x.is_cuda:
        torch.cuda.synchronize()
    return [o.detach() for o in outs], grads, (time.time() - t) * 1e3


def _hold(cuda, cpu, tol: float) -> dict:
    """Largest difference of each tensor pair over the CPU tensor's largest
    magnitude; ok when all are within tol."""
    errs = [float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(cuda, cpu)]
    return {"max_rel_err": max(errs), "ok": max(errs) <= tol}


def fields_check() -> dict:
    """HexPlane at 4DGaussians' defaults and the hash grid at its defaults
    on FIELD_POINTS points (some outside the box), forward and backward,
    card against CPU; extend_nodes and acc_loss at NODES control nodes."""
    import torch

    from fourdgs_torch import convert
    from fourdgs_torch.models import deform as D
    from fourdgs_torch.models import hashgrid as HG
    from fourdgs_torch.models import hexplane as HX
    from fourdgs_torch.utils.draws import TorchDraws

    gen = torch.Generator().manual_seed(11)
    x = torch.rand((FIELD_POINTS, 3), generator=gen) * 4.4 - 2.2
    out = {}
    for name, params, fn, dims in (
            ("hexplane", HX.init_hexplane(gen), HX.hexplane_deform, (3, 3, 4)),
            ("hashgrid", HG.init_hashgrid(gen), HG.hash_deform, (3, 4, 3))):
        cls = type(params)
        seq = cls._fields[0]
        flat = list(getattr(params, seq)) + [getattr(params, f) for f in cls._fields[1:-2]]
        nseq = len(getattr(params, seq))

        def call(ps, xx, cls=cls, fn=fn, nseq=nseq, box=(params.aabb_min, params.aabb_max)):
            f = cls(tuple(ps[:nseq]), *ps[nseq:], *(b.to(xx.device) for b in box))
            return fn(f, xx, 0.4)

        cots = [torch.randn((FIELD_POINTS, d), generator=gen) for d in dims]
        cpu_o, cpu_g, cpu_ms = _field_grads(call, flat, x, cots)
        dev = [p.cuda() for p in flat]
        _field_grads(call, dev, x.cuda(), [c.cuda() for c in cots])   # warm-up
        cuda_o, cuda_g, ms = _field_grads(call, dev, x.cuda(), [c.cuda() for c in cots])
        out[name] = {"params": sum(p.numel() for p in flat), "ms_fwd_bwd": ms,
                     "cpu_ms_fwd_bwd": cpu_ms, "values": _hold(cuda_o, cpu_o, FIELD_TOL),
                     "grads": _hold(cuda_g, cpu_g, FIELD_GRAD_TOL)}

    # extend_nodes and acc_loss at bench.py --dynamic's 512 nodes, 384 alive
    draws = TorchDraws(3, "cpu")
    ws, heads = draws.mlp_init(D.mlp_dims(), [d for _, d, _ in D.HEADS])
    pts = torch.randn((FIELD_POINTS, 3), generator=gen)
    cn = D.init_nodes(NODES, pts, torch.ones(FIELD_POINTS, dtype=torch.bool), 384, 0,
                      D.init_mlp(ws, heads))
    new_pts = torch.rand((FIELD_POINTS, 3), generator=gen) + 1.5
    pv = torch.rand(FIELD_POINTS, generator=gen) > 0.3
    ext = {}
    for dev in ("cpu", "cuda"):
        c = convert.control_nodes_from_arrays(convert.control_nodes_to_arrays(cn), dev)
        ext[dev] = convert.control_nodes_to_arrays(D.extend_nodes(c, new_pts.to(dev),
                                                                  pv.to(dev), 5))
    equal = all((ext["cpu"][f] == ext["cuda"][f]).all()
                for f in ("nodes", "radius_raw", "weight_raw", "valid"))
    acc = {}
    for dev in ("cpu", "cuda"):
        c = convert.control_nodes_from_arrays(convert.control_nodes_to_arrays(cn), dev)
        like = D.cn_floats(c)
        flat = D.flatten(like).requires_grad_(True)
        val = torch.sum(D.acc_loss(D.cn_merge(D.unflatten(flat, like), c.valid),
                                   torch.tensor([0.3, 0.7], device=dev),
                                   torch.tensor([0.2, 0.6], device=dev), 0.05))
        (g,) = torch.autograd.grad(val, flat)
        acc[dev] = (val.detach(), g)
    out["extend_nodes"] = {"nodes": NODES, "valid_after": int(ext["cuda"]["valid"].sum()),
                           "equal": bool(equal), "ok": bool(equal)}
    val_err = abs(float(acc["cuda"][0]) - float(acc["cpu"][0])) / abs(float(acc["cpu"][0]))
    grad_err = _hold([acc["cuda"][1]], [acc["cpu"][1]], ACC_GRAD_TOL)
    out["acc_loss"] = {"value": float(acc["cuda"][0]), "rel_err": val_err,
                       "grads": grad_err, "ok": val_err <= FIELD_TOL and grad_err["ok"]}
    out["ok"] = (all(out[k]["values"]["ok"] and out[k]["grads"]["ok"]
                     for k in ("hexplane", "hashgrid"))
                 and out["extend_nodes"]["ok"] and out["acc_loss"]["ok"])
    return out


def batch_eval_check(wrappers, held_views) -> dict:
    """python -m fourdgs_torch.batch_eval --synthetic 1 --frames BATCH_FRAMES
    on the card, held to PERF.md §2's static limits; both kernels launched,
    only at numbers of views in held_views (those phase 3 held at 80x60)."""
    from fourdgs_torch import batch_eval as BE

    tmp = tempfile.mkdtemp(prefix="fourdgs_batch_")
    for k in wrappers.values():
        k.launches_by_views.clear()
    t = time.time()
    try:
        (row,) = BE.main(["--synthetic", "1", "--frames", str(BATCH_FRAMES), "--out", tmp])
        with open(os.path.join(tmp, "summary.json")) as f:
            summary = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = _launches(wrappers)
    out = {"row": row, "seconds": time.time() - t, "launches_by_views": launches}
    out["views_held"] = all(set(v) <= set(held_views) for v in launches.values())
    out["ok"] = (summary == [row] and row["ate_rmse"] < 0.05 and row["psnr"] > 15
                 and min(sum(v.values()) for v in launches.values()) > 0 and out["views_held"])
    return out


def realsense_check() -> dict:
    """load_dataset(type: realsense) without pyrealsense2 (or without a
    camera) raises RuntimeError."""
    from fourdgs_torch.data.base import load_dataset

    cfg = {"Dataset": {"type": "realsense", "Calibration": {
        "fx": 600.0, "fy": 600.0, "cx": 639.5, "cy": 359.5, "width": 1280, "height": 720}}}
    try:
        load_dataset(None, "", cfg, device="cuda")
        raised = None
    except RuntimeError as e:
        raised = str(e)
    return {"raised": raised, "ok": raised is not None}


def last_modules_phase(slam, wrappers, batch_views) -> dict:
    """Phase 14 on phase 5's finished SLAM object; every check must hold.
    batch_views: the numbers of views phase 3 held at batch_eval's 80x60."""
    out = {}
    for name, fn in (("viewer", lambda: viewer_check(slam, wrappers)),
                     ("view_ply", lambda: view_ply_check(slam, wrappers)),
                     ("fields", fields_check),
                     ("batch_eval", lambda: batch_eval_check(wrappers, batch_views)),
                     ("realsense", realsense_check)):
        t = time.time()
        out[name] = fn()
        out[name]["seconds"] = time.time() - t
        log(f"last modules, {name}: " + json.dumps(out[name]))
    bad = [name for name, r in out.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"last-modules phase out of bounds: {bad}")
    return out


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
    shapes = [(v, FLOW_VIEWS.get(v, 0)) for v in VIEWS] + list(FLOW_SHAPES)
    shapes += [b for b in mesh_blocks() if b not in shapes]
    for views, n_flow in shapes:
        key = views if n_flow == FLOW_VIEWS.get(views, 0) else f"{views}_{n_flow}flow"
        compare[key] = r = compare_kernels(slam, views, seed=views + n_flow, n_flow=n_flow)
        log(f"compare {KC.WIDTH}x{KC.HEIGHT}x{views} ({n_flow} flow): " + json.dumps(r))
        if not r["ok"]:
            raise SystemExit(f"kernel disagrees with its plain version at {views} views "
                             f"({n_flow} flow): {r['err']}")
    small, _ = KC.small_map()   # batch_eval's 80x60, partial tiles at the lower edge
    for views in BATCH_VIEWS:
        key = f"{views}_{small.intr.width}x{small.intr.height}"
        compare[key] = r = compare_kernels(small, views, seed=views, n_flow=0)
        log(f"compare {small.intr.width}x{small.intr.height}x{views}: " + json.dumps(r))
        if not r["ok"]:
            raise SystemExit(f"kernel disagrees with its plain version at {views} views, "
                             f"{small.intr.width}x{small.intr.height}: {r['err']}")
    del small
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
    metrics = slam.run(warmup_frames=1)
    by_views = {name: dict(k.launches_by_views) for name, k in wrappers.items()}
    launches = {name: sum(n.values()) for name, n in by_views.items()}
    ate = slam.eval_ate()["rmse"]
    rend = slam.eval_rendering()
    result = {"ate_rmse_m": ate, "psnr": rend["mean_psnr"], "l1_depth": rend["mean_l1_depth"],
              "ssim": rend["mean_ssim"], "fps": metrics["fps"],
              "fps_steady": metrics.get("fps_steady"), "keyframes": len(slam.kf_indices),
              "gaussians": slam.gmap.num_alive, "max_pairs_per_view": slam.max_pairs_seen,
              "phase_s": metrics["phase_s"], "launches": launches,
              "launches_by_views": by_views, "centre_err_mm": centre_errors_mm(slam)}
    record["slam"] = result
    log("slam: " + json.dumps(result))
    log(f"phase slam: {time.time() - t:.1f}s")
    if not (ate < 0.05 and rend["mean_psnr"] > 15 and rend["mean_l1_depth"] < 1.2
            and result["fps_steady"] is not None):
        raise SystemExit(f"SLAM result out of bounds: {result}")
    if min(launches.values()) <= 0 or len(slam.kf_indices) < 2:
        raise SystemExit(f"the SLAM phase did not run both kernels and a keyframe: {result}")
    if not all(np.isfinite(slam.poses_est[i]).all() for i in slam.poses_est):
        raise SystemExit("non-finite pose")

    slam5 = slam   # phase 14 views its finished map
    del slam
    torch.cuda.empty_cache()

    # ---- phase 6: SLAM(dynamic=True).run, the 4D path; launches counted
    # here are the dynamic path's
    t = time.time()
    n_dyn = 15
    log(f"dynamic cuts against bench.py --dynamic: {n_dyn} frames of its 40-frame sequence; "
        "widths, capacity 2^15, 512 control nodes, iteration counts, window 8 + 2 replay, "
        "flow weights 3 and 2, dystart 8 unchanged")
    slam = SLAM(KC.bench_dynamic_config(40), dynamic=True, max_frames=n_dyn,
                capacity=KC.CAPACITY, max_capacity=KC.CAPACITY, max_keyframes=64)
    phases_4d = trace_dynamic_phases(slam)
    for k in wrappers.values():
        k.launches_by_views.clear()
    metrics = slam.run()
    dyn_by_views = {name: dict(k.launches_by_views) for name, k in wrappers.items()}
    dyn_launches = {name: sum(n.values()) for name, n in dyn_by_views.items()}
    ate = slam.eval_ate()["rmse"]
    rend = slam.eval_rendering()
    dy = slam.gmap.dygs & slam.gmap.alive
    # the learned motion of the dynamic Gaussians between 30% and 90% of
    # the run's time span (tests/test_end_to_end_dynamic.py holds t = 0.3
    # and 0.9 on a sequence that spans [0, 1]; this run spans [0, 14/39])
    span = (n_dyn - 1) / (len(slam.dataset) - 1)
    from fourdgs_torch.models.deform import warp

    with torch.no_grad():
        d0, d1 = (warp(slam.deform, slam.gmap.params.xyz,
                       torch.tensor(f * span, device=slam.device),
                       motion_mask=slam.gmap.dygs)[0] for f in (0.3, 0.9))
        motion = float(torch.linalg.norm(d1 - d0, dim=-1)[dy].median()) if dy.any() else 0.0
    phase = metrics["phase_s"]
    dyn = {"ate_rmse_m": ate, "psnr": rend["mean_psnr"], "l1_depth": rend["mean_l1_depth"],
           "ssim": rend["mean_ssim"], "keyframes": list(slam.kf_indices),
           "gaussians": slam.gmap.num_alive, "dynamic_gaussians": int(dy.sum()),
           "dynamic_spawned": metrics.get("dygs_spawned", 0),
           "control_nodes": int(slam.deform.valid.sum()) if slam.deform_init else 0,
           "median_motion": motion, "centre_err_mm": centre_errors_mm(slam),
           "phases_4d": phases_4d, "phase_s": phase,
           "ms_per_dyn_iter": phase["dyn_mapping"] * 1e3 / max(phase["dyn_iters"], 1),
           "launches": dyn_launches, "launches_by_views": dyn_by_views}
    record["dynamic"] = dyn
    log("dynamic: " + json.dumps(dyn))
    # more than 20 dynamic Gaussians spawned at dystart, and some alive at
    # the end: the benchmark's densify, after each dynamic keyframe phase,
    # prunes those whose opacity has not passed gaussian_th (0.7) from the
    # 0.5 they spawn at, as the reference's does
    # (tests/test_torch_dynamic_densify.py); the motion is theirs
    if not (slam.deform_init and ate < 0.08 and rend["mean_psnr"] > 14
            and dyn["dynamic_spawned"] > 20 and dyn["dynamic_gaussians"] > 0
            and 8 in slam.kf_indices and motion > 0.02):
        raise SystemExit(f"dynamic SLAM result out of bounds: {dyn}")
    if min(dyn_launches.values()) <= 0 or phase["dyn_iters"] <= 0:
        raise SystemExit(f"the dynamic phase did not run both kernels in 4D mapping: {dyn}")
    if not all(np.isfinite(slam.poses_est[i]).all() for i in slam.poses_est):
        raise SystemExit("non-finite pose in the dynamic phase")
    prof = profile_dynamic(slam, 10)
    record["dynamic"]["iteration"] = prof
    log("dynamic iteration: " + json.dumps(prof))
    log(f"phase dynamic: {time.time() - t:.1f}s")

    del slam
    torch.cuda.empty_cache()

    # ---- phase 7: the command line on a recorded-layout sequence, through
    # the TUM loader, the segmenter, refinement and the artifacts
    t = time.time()
    os.chdir(HERE)   # the config's inherit_from and save_dir are relative to it
    from fourdgs_torch.eval import lpips as L

    lpips_dir = tempfile.mkdtemp(prefix="fourdgs_lpips_")
    os.environ["FOURDGS_LPIPS_WEIGHTS"] = os.path.join(lpips_dir, "lpips_alex.npz")
    L.save_weights(os.environ["FOURDGS_LPIPS_WEIGHTS"],
                   L.random_weights(torch.Generator().manual_seed(5), "cpu"))
    try:
        cli = cli_phase(wrappers)
    finally:
        del os.environ["FOURDGS_LPIPS_WEIGHTS"]
        shutil.rmtree(lpips_dir, ignore_errors=True)
    record["cli"] = cli
    log(f"phase cli: {time.time() - t:.1f}s")

    # ---- phase 8: the flow networks and LPIPS, card against CPU
    t = time.time()
    record["perception"] = perception_phase()
    log(f"phase perception: {time.time() - t:.1f}s")

    # ---- phase 9: the command line with the network flow loss
    t = time.time()
    flow = flow_phase(wrappers)
    record["flow"] = flow
    log(f"phase flow: {time.time() - t:.1f}s")

    # ---- phase 10: YOLOv9e-seg, card against CPU
    t = time.time()
    record["segmentation"] = segmentation_phase()
    log(f"phase segmentation: {time.time() - t:.1f}s")

    # ---- phase 12: monocular SLAM and rm_initdy, each with its launches
    t = time.time()
    record.update(monocular_phase(wrappers))
    mono, rm = record["monocular"], record["rm_initdy"]
    log(f"phase monocular: {time.time() - t:.1f}s")

    # ---- phase 13: multi-device mapping, 2 ranks on the card
    t = time.time()
    mesh = mesh_phase(wrappers, {v for v, _ in shapes})
    record["mesh"] = mesh
    log(f"phase mesh: {time.time() - t:.1f}s")

    # ---- phase 14: the last modules, on phase 5's finished map
    t = time.time()
    last = last_modules_phase(slam5, wrappers, BATCH_VIEWS)
    record["last_modules"] = last
    del slam5
    torch.cuda.empty_cache()
    log(f"phase last modules: {time.time() - t:.1f}s")

    # ---- phase 11: the kernels line; ms, plain_ms and bound_ms are at 10
    # views (the full static window), the *_1view, *_2view and *_26view
    # keys at tracking's shape, the static phase's mapping and the full 4D
    # window; max_abs_err over every number of views held
    def entry(name, short, replaces, err_keys):
        timed = {"ms": f"{short}_ms", "plain_ms": f"plain_{short}_ms",
                 "bound_ms": f"{short}_bound_ms", "bound_by": f"{short}_bound_by"}
        e = {"name": name, "route": "cuda",
             "source": f"fourdgs_torch/ops/rasterize/csrc/{name}.cu",
             "replaces": replaces, "launches": launches[name],
             "launches_by_views": by_views[name],
             "launches_dynamic": dyn_launches[name],
             "launches_by_views_dynamic": dyn_by_views[name],
             "launches_cli": sum(cli["launches_by_views"][name].values()),
             "launches_by_views_cli": cli["launches_by_views"][name],
             "launches_by_views_cli_refinement": cli["refinement_by_views"][name],
             "launches_flow": sum(flow["launches_by_views"][name].values()),
             "launches_by_views_flow": flow["launches_by_views"][name],
             "launches_flow_views_flow": flow["flow_view_launches"][name],
             "launches_monocular": mono["launches"][name],
             "launches_by_views_monocular": mono["launches_by_views"][name],
             "launches_rm_initdy": rm["launches"][name],
             "launches_by_views_rm_initdy": rm["launches_by_views"][name],
             "launches_mesh": sum(sum(r[name].values())
                                  for r in mesh["slam"]["launches_by_rank"].values()),
             "launches_by_views_mesh": {rank: r[name] for rank, r in
                                        mesh["slam"]["launches_by_rank"].items()},
             "launches_by_views_mesh_static": {
                 rank: r[name] for rank, r in mesh["runs"][0]["static_launches_by_rank"].items()},
             "launches_by_views_mesh_4d": {
                 rank: r[name] for rank, r in
                 mesh["runs"][0]["dynamic_1"]["launches_by_rank"].items()},
             "launches_viewer": sum(last["viewer"]["launches_by_views"][name].values()),
             "launches_by_views_viewer": last["viewer"]["launches_by_views"][name],
             "launches_view_ply": sum(last["view_ply"]["launches_by_views"][name].values()),
             "launches_by_views_view_ply": last["view_ply"]["launches_by_views"][name],
             "launches_batch_eval": sum(
                 last["batch_eval"]["launches_by_views"][name].values()),
             "launches_by_views_batch_eval": last["batch_eval"]["launches_by_views"][name],
             "max_abs_err": max(r["err"][k] for r in compare.values() for k in err_keys),
             **{key: compare[10][src] for key, src in timed.items()}, "library_ms": None}
        for v in (1, 2, 26):
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
