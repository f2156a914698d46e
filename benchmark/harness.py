"""Runs one cell of the benchmark once and prints its result line.

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs the cell's configuration (`configs/<config>.json`)
under its traffic mix (`traffic/<traffic>.json`) through the program's
entry, `fourdgs_torch.slam.runner.SLAM(config).run(warmup_frames=6)`:

  set-up   process start to the fetch of frame 6: imports, the
           sequence, the runner, frame 0's initialisation, frames 1-5
           with keyframe 5 (in the 4D cell the deformation field's
           initialisation and first 4D phase);
  window   whole keyframe cycles from frame 6 on (window.WholeCycles),
           closed at a frame fetch by an exception the benchmark raises
           from its proxy of the runner's dataset;
  check    the reference follows a sample of the window's calls, drawn
           from the seed (checks.py), once the program's state is freed.

With `--trace 0` the metrics are the cell's end-to-end metrics, `fps`
(frames of the window over its seconds) and `setup_s`. With `--trace 1`
the first cycle of the window runs under `torch.profiler` (CUDA
activity) and every call into a layer is a synchronised span; the
per-layer metrics are read by the readers in `metrics/<name>.py` from
the spans of the unprofiled cycles and from the profiled one.

The last line of standard output is the result; the line before it names
the card, its power limit and the device count; the last lines of
standard error list each compared number beside its limit.
"""

from __future__ import annotations

import argparse
import copy
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from benchmark import checks, devtrace, hooks, roofline, traffic
from benchmark.window import WholeCycles, WindowClosed

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fourdgs")
WARMUP_FRAMES = 6
MISSING = 1e300


class Cell(NamedTuple):
    name: str
    config_name: str
    traffic: str
    chips: int
    spec: dict          # BENCHMARK.json
    config: dict        # configs/<config>.json
    limits: dict        # limits/<cell>.json


def load_cell(name: str) -> Cell:
    """A cell of BENCHMARK.json."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), spec, config, limits)


def metrics_of(cell: Cell, kind: str) -> list[dict]:
    """The cell's metrics of `kind` (end_to_end or per_layer)."""
    return [m for m in cell.spec[kind]
            if "workloads" not in m or cell.name in m["workloads"]]


class WindowedDataset:
    """The runner's dataset behind the window's rule: every fetch passes
    `window.fetch` first (which may end the run), and is a `fetch` span."""

    def __init__(self, inner, window: WholeCycles, rec: hooks.Recorder):
        self._inner, self._window, self._rec = inner, window, rec

    def __len__(self):
        return len(self._inner)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __getitem__(self, idx):
        self._window.fetch(idx)
        with self._rec.span("fetch") as box:
            out = self._inner[idx]
            if box is not None:
                box["out"] = out
        return out


class Readings(NamedTuple):
    """What a per-layer reader reads."""

    spans: list            # hooks.Span of the window
    trace: devtrace.Trace | None
    roofline: dict         # kernel -> (mean bound seconds, mean device seconds) of a call
    ops: float | None      # float32 operations of the unprofiled cycles
    ops_s: float           # their seconds

    def per_work(self, name: str, scale: float = 1.0):
        """Seconds per unit of work of the spans `name` (scaled), from the
        window's unprofiled cycles."""
        sp = [s for s in self.spans if s.name == name and not s.profiled]
        work = sum(s.work for s in sp)
        return scale * sum(s.t1_ns - s.t0_ns for s in sp) / 1e9 / work if work else None


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_line(device) -> dict:
    if device.type != "cuda":
        return {"card": "cpu", "power_limit": None, "device_count": 0}
    limit = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=30)
        limit = out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"card": torch.cuda.get_device_name(device), "power_limit": limit,
            "device_count": torch.cuda.device_count()}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str | None = None, overrides=None, control: bool = False) -> dict:
    """One run of cell `name`: the result line's keys, the compared
    numbers under `checks` (`attempted` is the window's frames, `failed`
    the numbers over their limits). `device` "cpu" and
    `overrides(config, mix, slam_kw)`, which may cut the sizes in place,
    are for the benchmark's own tests; `control` adds the control's, the
    faults' and the reference's own readings (control.py)."""
    from fourdgs_torch.slam.runner import SLAM
    from fourdgs_torch.utils.config import ConfigDict
    from fourdgs_torch.utils.draws import TorchDraws

    cell = load_cell(name)
    dev = torch.device(device or "cuda")
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    mix = traffic.load(cell.traffic)
    cfg = copy.deepcopy(cell.config["config"])
    slam_kw = dict(cell.config["slam"])
    if overrides is not None:
        overrides(cfg, mix, slam_kw)
    t_prep = time.perf_counter()
    poses_gt = traffic.prepare(cell.name, mix, cfg, seed, dev)
    # writing the sequence stands in for a recording already on disk: it
    # is the benchmark's own work, done in the first run of a seed only
    prep_s = time.perf_counter() - t_prep
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    rec = hooks.Recorder(trace, sync, seed).install()
    try:
        slam = SLAM(ConfigDict.wrap(cfg), device=dev, draws=TorchDraws(seed, dev), **slam_kw)
        window = WholeCycles(seconds, slam.n_frames, WARMUP_FRAMES, int(slam.kf_interval),
                             sync=sync)
        prof = _profiler_hooks(rec, window, dev) if trace else None
        window.on_open.insert(0, lambda: setattr(rec, "in_window", True))
        inner = slam.dataset
        slam.dataset = WindowedDataset(inner, window, rec)
        try:
            slam.run(warmup_frames=WARMUP_FRAMES)
        except WindowClosed:
            pass
        rec.in_window = False
        if window.t_close is None:
            raise RuntimeError("the run ended before the window closed")
        setup_s = window.t_open - t_start - prep_s
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        poses_est = dict(slam.poses_est)
        program_seq = _program_sequence(cfg, inner)
        del slam, inner
    finally:
        rec.uninstall()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": window.frames, "failed": 0}
    if trace:
        reads = _readings(rec, prof, window)
        result["metrics"] = {}
        for m in metrics_of(cell, "per_layer"):
            reader = load_reader(m["name"])
            if reader.UNIT != m["unit"]:
                raise ValueError(f"metrics/{m['name']}.py gives {reader.UNIT}, "
                                 f"BENCHMARK.json {m['unit']}")
            value = reader.read(reads)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        host = {"fps": window.fps, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": host[m["name"]], "unit": m["unit"]}
                             for m in metrics_of(cell, "end_to_end")}

    nums, ctrl = _check(cell, rec, seed, poses_est, poses_gt, program_seq, cfg, mix, dev,
                        control)
    # a comparison that could not be made (a side missing, shapes that
    # differ) reads MISSING, which no limit passes
    checked = {}
    for k, lim in cell.limits.items():
        v = nums.get(k, math.inf)
        checked[k] = {"value": v if math.isfinite(v) else MISSING, "limit": lim["limit"]}
    bad = [k for k, c in checked.items() if not c["value"] <= c["limit"]]
    result["correct"] = not bad and window.frames > 0
    result["failed"] = len(bad)
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                        "count": 1, "memory_peak_bytes": int(peak)}
    if trace and reads.trace is not None:
        result["device"]["busy_s"] = devtrace.busy_s(reads.trace)
        result["device"]["window_s"] = devtrace.window_s(reads.trace)
        result["breakdown"] = {"device_ops": devtrace.top_ops(reads.trace),
                               "idle_gaps": devtrace.idle_gaps(reads.trace, rec.spans)}
    if window.short:
        print(f"the sequence ended before {seconds} s: the window holds "
              f"{window.frames} frames in {window.window_s:.1f} s", file=sys.stderr)
    if ctrl is not None:
        result["control"] = {name: {k: v if math.isfinite(v) else MISSING for k, v in c.items()}
                             for name, c in ctrl.items()}
    result["checks"] = checked
    result["numbers"] = nums   # every number worked out, compared or not
    return result


def _program_sequence(cfg: dict, dataset):
    """Where the program renders the sequence: its poses, and its frames
    0-5 (read back from its dataset, which rendered them in set-up)."""
    if cfg["Dataset"]["type"] != "synthetic":
        return None
    return ([np.asarray(T, np.float64) for T in dataset.poses],
            [dataset[i][:2] for i in range(WARMUP_FRAMES)])


def _profiler_hooks(rec: hooks.Recorder, window: WholeCycles, dev) -> dict:
    """Starts `torch.profiler` (CUDA activity) when the window opens and
    stops it at the first cycle boundary."""
    from torch.profiler import ProfilerActivity, profile

    box = {"prof": None, "t0": None, "t1": None, "resumed": None}

    def start():
        box["prof"] = profile(activities=[ProfilerActivity.CUDA])
        box["prof"].start()
        torch.cuda.synchronize(dev)
        box["t0"] = time.time_ns()
        rec.profiled = True

    def stop(idx):
        if box["t1"] is None:
            torch.cuda.synchronize(dev)
            box["t1"] = time.time_ns()
            rec.profiled = False
            box["prof"].stop()
            box["resumed"] = time.perf_counter()

    if dev.type == "cuda":
        window.on_open.append(start)
        window.on_boundary.append(stop)
    return box


def _readings(rec: hooks.Recorder, prof: dict, window: WholeCycles) -> Readings:
    tr = None
    if prof.get("prof") is not None:
        if prof["t1"] is None:   # a window of one cycle: stopped at its close
            torch.cuda.synchronize()
            prof["t1"] = time.time_ns()
            prof["prof"].stop()
        tr = devtrace.collect(prof["prof"], prof["t0"], prof["t1"])
    roof, ops = {}, {}
    for kind, frag in (("fwd", "composite_fwd"), ("bwd", "composite_bwd")):
        calls = rec.calls[kind]
        works = {}
        for i, s in rec.samples[kind]:
            fields, pair_gid, tile_start, tile_count, n_contrib, (_, _, g) = s
            w = roofline.call_work(fields, pair_gid, tile_start, tile_count, n_contrib,
                                   tiles_per_view=g["tx_n"] * g["ty_n"], tx_n=g["tx_n"],
                                   width=g["width"], height=g["height"])
            works[i] = (w.fwd_ops, w.fwd_bytes) if kind == "fwd" else (w.bwd_ops, w.bwd_bytes)
        rec.samples[kind].clear()
        by_v: dict[int, list] = {}   # view count -> (operations, bound seconds) of samples
        for i, (o, b) in works.items():
            by_v.setdefault(calls[i][0], []).append((o, roofline.bound_s(o, b)))

        def per_call(views: int, j: int) -> float:
            """A call's operations (j=0) or bound (j=1): the mean of the
            sampled calls of its view count, or of all where none was."""
            got = by_v.get(views) or [x for xs in by_v.values() for x in xs]
            return float(np.mean([g[j] for g in got])) if got else math.nan

        # roofline: the profiled cycle's calls' mean bound over the mean
        # device time of the kernel of that name in its trace
        prof_views = [v for v, p in calls if p]
        kern = devtrace.named(tr, f"{frag}_kernel") if tr is not None else []
        if prof_views and kern and by_v:
            roof[kind] = (float(np.mean([per_call(v, 1) for v in prof_views])),
                          float(np.mean([(k.t1 - k.t0) / 1e9 for k in kern])))
        # operations of the unprofiled cycles, by view count
        ops[kind] = sum(per_call(v, 0) for v, p in calls if not p)
    unprof = [s for s in rec.spans if not s.profiled]
    # the unprofiled cycles: from the profiler's stop to the window's close
    ops_s = window.t_close - prof["resumed"] if prof.get("resumed") else 0.0
    total_ops = ops.get("fwd", 0.0) + ops.get("bwd", 0.0) + rec.mlp_ops[False]
    return Readings(rec.spans, tr, roof, total_ops if unprof and ops_s > 0 else None, ops_s)


def _check(cell: Cell, rec: hooks.Recorder, seed: int, poses_est, poses_gt, program_seq, cfg,
           mix, dev, control: bool):
    """The compared numbers, each the worst over the checked calls; with
    `control`, also the readings of the control, of the faults and of the
    reference run again (checks.py); the field's faults
    (checks.FIELD_FAULTS) are read at the 4D mapping call's first
    iteration only."""
    nums: dict[str, float] = {}
    names = ((checks.CONTROL, "unchanged", "half", "again") + checks.FIELD_FAULTS
             if control else ())
    ctrl = {name: {} for name in names} if control else None

    def worst(into: dict, new: dict):
        for k, v in new.items():
            into[k] = max(into.get(k, 0.0), v)

    for snap in rec.kept["track"].picks():
        ref, ref1 = checks.follow_track(snap), checks.first_iteration("track", snap)
        worst(nums, checks.judge_track(snap, snap["out"], ref))
        worst(nums, checks.judge_first("track", snap["first"], ref1))
        for name in names:
            if name == "half" or name in checks.FIELD_FAULTS:
                continue
            c1 = ref1 if name == "unchanged" else checks.first_iteration(
                "track", snap, None if name == "again" else name)
            worst(ctrl[name], checks.judge_track(
                snap, checks.follow_track(snap, None if name == "again" else name), ref))
            worst(ctrl[name], checks.judge_first("track", c1, ref1))
    kind = "dyn" if rec.kept["dyn"].picks() else "map"
    end = control or any(f"{kind}_{k}" in cell.limits
                         for k in ("loss", "pose", "render", "change", "field_change"))
    for snap in rec.kept[kind].picks():
        ref1 = checks.first_iteration(kind, snap)
        worst(nums, checks.judge_first(kind, snap["first"], ref1))
        ref = checks.follow_map(kind, snap) if end else None
        if end:
            worst(nums, checks.judge_map(kind, snap, checks.program_map_out(kind, snap), ref))
        for name in names:
            field_fault = name in checks.FIELD_FAULTS
            if field_fault and kind != "dyn":
                continue
            c1 = ref1 if name == "unchanged" else checks.first_iteration(
                kind, snap, None if name == "again" else name)
            if not field_fault:
                c = checks.follow_map(kind, snap, None if name == "again" else name, first=ref1)
                worst(ctrl[name], checks.judge_map(kind, snap, c, ref))
            worst(ctrl[name], checks.judge_first(kind, c1, ref1))
    rec.kept.clear()
    nums["ate"] = checks.ate_mm(poses_est, poses_gt)
    if program_seq is not None:
        from benchmark.reference import generator as G

        ds = cfg["Dataset"]
        n = int(mix["frames"])
        port_poses, frames = program_seq
        expect = traffic.synthetic_poses(n)
        nums["poses"] = float(max(np.max(np.abs(a - b)) for a, b in zip(port_poses, expect)))
        room = G.make_room_scene(seed, int(mix["points_per_wall"]))
        blob = G.make_dynamic_blob(seed + 1) if mix["blob"] else None

        def render(i, name):
            with checks.variant(name):
                return G.render_frame(G.scene_at(room, blob, i / max(n - 1, 1)), expect[i],
                                      ds["Calibration"], dev)

        def gap(a, b):
            return float(np.mean(np.abs(a[0] - b[0])) + np.mean(np.abs(a[1] - b[1])))

        ref_frames = [render(i, None) for i in range(len(frames))]
        nums["frames"] = max(gap(f, r) for f, r in zip(frames, ref_frames))
        if control:
            ctrl[checks.CONTROL]["frames"] = max(
                gap(render(i, checks.CONTROL), r) for i, r in enumerate(ref_frames))
    if control:
        ctrl["program"] = dict(nums)
    return nums, ctrl


def main(argv, t_start: float, control: bool = False) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start, control=control)
    result.pop("numbers")
    found = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    print(json.dumps(card_line(torch.device("cuda"))))
    print(json.dumps(result))
    return 0
