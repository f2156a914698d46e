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
              carry signed flow payloads), and the numbers the dynamic
              and cli phases launch (fourdgs_torch/kernel_check.py: forward
              outputs, n_contrib and n_touched exactly equal, gradients
              within 1e-5 of each field's largest magnitude); with times
              and bounds
  4. tracking 100 track_frame iterations at 640x480, capacity 2^15, with a
              device profile of the loop
  5. slam     SLAM.run at the benchmark's width and capacity on 10 frames,
              held to ATE < 0.05 m, PSNR > 15 and L1 depth < 1.2
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
              and a seeded pretrained/raft-things.npz in its (temporary)
              working directory: RAFT on the card supervises 4D mapping.
              Held: flow weight 3, every window view with an earlier
              keyframe given its flow, each pair computed once, compositor
              launches in 4D chunks with flow views, finite poses; printed,
              not held (seeded weights give no real supervision): ATE,
              PSNR, seconds per stage, the share of consistent mask pixels
 10. kernels  one JSON line: per kernel its launches in the SLAM phase, in
              the dynamic phase, in the cli phase and in the flow phase (in
              all, by number of views, and the cli phase's refinement by
              number of views), largest error against its plain version,
              times and bound at 10 views (the full static window), and
              (*_1view, *_2view, *_26view) at 1, 2 and 26 views
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
CLI_FRAMES = 44   # keyframes 0, 5, 8 (dystart), 13, ..., 43: ten, for refinement at 10 views
# keyframes 0, 5, 8 (dystart) and 13, the last frame: two 4D phases, three
# flow pairs (with 18 frames the script took 659 s on an H100 80GB HBM3 at 700 W)
FLOW_FRAMES = 14
FLOW_TOL = 5e-2   # px, card against CPU, RAFT and GMA flows at 640x480
MASK_AGREE = 0.999
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
        "views": n_views, "flow_views": n_flow, "gaussians": slam.gmap.num_alive,
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


def write_cli_sequence(tmp: str, extra_yaml: str = "", blob: bool = True) -> str:
    """Write the cli phase's sequence (CLI_FRAMES frames of the dynamic
    synthetic sequence at 640x480, or with `blob` False of the static one,
    in TUM layout) and its config under `tmp`; returns the config's path.
    The config inherits configs/rgbd/tum/base_config.yaml and sets the
    sequence, its calibration, dystart 8 and `extra_yaml`."""
    import torch

    from fourdgs_torch import kernel_check as KC
    from fourdgs_torch.data.synthetic import SyntheticDataset, write_tum_format

    seq = os.path.join(tmp, "seq")
    seq_cfg = (KC.bench_dynamic_config if blob else KC.bench_config)(CLI_FRAMES)
    synthetic = SyntheticDataset(None, "", seq_cfg, device="cuda")
    write_tum_format(synthetic, seq)
    c = synthetic.config["Dataset"]["Calibration"]
    cfg = os.path.join(tmp, "synthetic_tum_dynamic.yaml")
    with open(cfg, "w") as f:
        f.write("inherit_from: configs/rgbd/tum/base_config.yaml\n"
                f"Dataset:\n  dataset_path: {seq}\n  Calibration:\n"
                + "".join(f"    {k}: {c[k]}\n" for k in ("fx", "fy", "cx", "cy", "width",
                                                        "height"))
                + "    depth_scale: 5000.0\n    distorted: false\n"
                "Training:\n  dystart: 8\n" + extra_yaml)
    del synthetic
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
    from fourdgs_torch.perception.weights_io import save_pytree_npz
    from fourdgs_torch.slam.runner import SLAM

    tmp = tempfile.mkdtemp(prefix="fourdgs_flow_")
    cwd = os.getcwd()
    calls, chunks, views_without_flow = {}, [], []
    flow_s, last_pairs = [0.0], [0]

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
        write_s = time.time() - t
        os.chdir(tmp)   # where the runner finds pretrained/
        for k in wrappers.values():
            k.launches_by_views.clear()
        with observe_stages(SLAM, wrappers) as seen, \
                wrapped(R.RaftFlowProvider, "__call__", count_calls), \
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
        }
        finite = all(np.isfinite(slam.poses_est[i]).all() for i in slam.poses_est)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log("flow: " + json.dumps(out))
    ok = (out["flow_weight"] == 3.0 and out["provider"] == "RaftFlowProvider"
          and out["deform_init"] and out["flow_pairs"] and not views_without_flow
          and set(calls) == set(out["flow_pairs"]) and all(n == 1 for n in calls.values())
          and min(flow_launches.values()) > 0 and finite)
    if not ok:
        raise SystemExit(f"flow phase out of bounds: {out}")
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
    for views, n_flow in shapes:
        key = views if n_flow == FLOW_VIEWS.get(views, 0) else f"{views}_{n_flow}flow"
        compare[key] = r = compare_kernels(slam, views, seed=views + n_flow, n_flow=n_flow)
        log(f"compare {KC.WIDTH}x{KC.HEIGHT}x{views} ({n_flow} flow): " + json.dumps(r))
        if not r["ok"]:
            raise SystemExit(f"kernel disagrees with its plain version at {views} views "
                             f"({n_flow} flow): {r['err']}")
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
              "launches_by_views": by_views, "centre_err_mm": centre_errors_mm(slam)}
    record["slam"] = result
    log("slam: " + json.dumps(result))
    log(f"phase slam: {time.time() - t:.1f}s")
    if not (ate < 0.05 and rend["mean_psnr"] > 15 and rend["mean_l1_depth"] < 1.2):
        raise SystemExit(f"SLAM result out of bounds: {result}")
    if min(launches.values()) <= 0 or len(slam.kf_indices) < 2:
        raise SystemExit(f"the SLAM phase did not run both kernels and a keyframe: {result}")
    if not all(np.isfinite(slam.poses_est[i]).all() for i in slam.poses_est):
        raise SystemExit("non-finite pose")

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

    # ---- phase 10: the kernels line; ms, plain_ms and bound_ms are at 10
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
