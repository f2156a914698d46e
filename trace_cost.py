"""What the port's tracer (`fourdgs_torch/utils/trace.py`) costs, on the
card's host:

    python3 trace_cost.py [--json PATH] [--rounds N] [--iters N] [--init-iters N]

  sites     the host time of one span site and one sync site, with
            recording off and on, over 200,000 calls each against an
            empty loop (microseconds);
  tracking  `track_frame` at 640x480 (the benchmark's static cell's
            calibration and tracking settings, the synthetic room of
            6,000 Gaussians a wall, a map initialised from frame 0 by
            `--init-iters` mapping iterations) tracking frame 1 for up to
            `--iters` iterations, `--rounds` pairs of calls with recording
            off and on in turns: the milliseconds per iteration of each,
            the median of the pairs' differences as a share of the median
            call off (with their interquartile range), the span and sync
            sites an iteration passes, and the shares the site costs
            above predict, recording on and off.

Recording on here is `trace.enable()` with no profiler: the overhead of
the spans themselves in an unprofiled run. Prints one JSON line."""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
import time
from pathlib import Path


def _loop(n, body):
    t = time.perf_counter_ns()
    body(n)
    return (time.perf_counter_ns() - t) / n / 1e3


def site_costs(n: int = 200_000) -> dict:
    """Microseconds a span site and a sync site add to a loop, recording
    off and on."""
    from fourdgs_torch.utils import trace

    def empty(k):
        for _ in range(k):
            pass

    def spans(k):
        for _ in range(k):
            with trace.span("x"):
                pass

    def syncs(k):
        for _ in range(k):
            with trace.sync("x"):
                pass

    out = {}
    for on, mode in ((False, "off"), (True, "on")):
        with trace.enable(on):
            base = min(_loop(n, empty) for _ in range(3))
            out[f"span_{mode}_us"] = min(_loop(n, spans) for _ in range(3)) - base
            trace.clear()
            out[f"sync_{mode}_us"] = min(_loop(n, syncs) for _ in range(3)) - base
            trace.clear()
    return out


def tracking_state(init_iters: int):
    import torch

    from fourdgs_torch.data.prefetch import iter_frames
    from fourdgs_torch.slam.runner import SLAM
    from fourdgs_torch.utils.config import ConfigDict

    spec = json.loads((Path(__file__).resolve().parent / "benchmark" / "configs"
                       / "tum-fr3-static.json").read_text())
    cfg = copy.deepcopy(spec["config"])
    cfg["Dataset"].update(type="synthetic", num_frames=40, points_per_wall=6000)
    cfg["Training"]["init_itr_num"] = init_iters
    slam = SLAM(ConfigDict.wrap(cfg), device="cuda", **{k: v for k, v in spec["slam"].items()
                                                         if k != "dynamic"})
    frames = iter_frames(slam.dataset, slam.edge_threshold, 2, device=slam.device)
    _, f0 = next(frames)
    slam._initialize(f0)
    _, f1 = next(frames)
    T0 = slam._pose_tensor(slam.poses_est[0])
    e0 = torch.zeros(2, device=slam.device)
    return slam, f1, T0, e0


def tracking_overhead(rounds: int, init_iters: int, iters: int) -> dict:
    """`rounds` pairs of `track_frame` calls of `iters` iterations, one
    with recording off and one on, in turns: each call's milliseconds per
    iteration, and the pairs' differences."""
    import torch

    from fourdgs_torch.slam.tracking import track_frame
    from fourdgs_torch.utils import trace

    slam, frame, T0, e0 = tracking_state(init_iters)
    cfg = slam.track_cfg._replace(max_iters=iters)

    def once():
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = track_frame(slam.gmap, frame, T0, e0, slam.intr, cfg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / res.n_iters, res.n_iters

    once()   # builds the kernels
    ms = {False: [], True: []}
    spans = syncs = sync_spans = n_on = 0
    for r in range(rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            trace.clear()
            s0 = trace.sync_count()
            with trace.enable(on):
                t, n = once()
            ms[on].append(t)
            if on:
                sp = trace.spans()
                sync_spans += sum(1 for x in sp if x.name == "sync")
                spans += len(sp)
                syncs += trace.sync_count() - s0
                n_on += n
    trace.clear()
    off = statistics.median(ms[False])
    diff = [b - a for a, b in zip(ms[False], ms[True])]
    q1, q2, q3 = statistics.quantiles(diff, n=4)
    return {"iters_per_call": n_on / rounds, "ms_per_iter_off": ms[False],
            "ms_per_iter_on": ms[True], "median_off": off,
            "median_on": statistics.median(ms[True]),
            "overhead_share": q2 / off, "overhead_share_iqr": (q3 - q1) / off,
            "span_sites_per_iter": (spans - sync_spans) / n_on,
            "sync_sites_per_iter": sync_spans / n_on, "syncs_per_iter": syncs / n_on}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--init-iters", type=int, default=300)
    args = ap.parse_args(argv)
    out = {"sites": site_costs()}
    out["tracking"] = tracking_overhead(args.rounds, args.init_iters, args.iters)
    t, s = out["tracking"], out["sites"]
    # the shares the site costs predict: an iteration's span and sync sites
    # at their cost, against the iteration's time
    for mode in ("on", "off"):
        us = (t["span_sites_per_iter"] * s[f"span_{mode}_us"]
              + t["sync_sites_per_iter"] * s[f"sync_{mode}_us"])
        t[f"predicted_{mode}_share"] = us / 1e3 / t["median_off"]
    line = json.dumps(out)
    print(line)
    if args.json:
        Path(args.json).write_text(line)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(main(sys.argv[1:]))
