"""The program's own spans in one traced run of a cell: where the device
waited, by the innermost span of the program the host was in, and the
host's waits for the device, by sync site. Runs on the card:

    python3 benchmark/progreport.py --workload <cell> --seed <n> --seconds <s> [--json PATH]

It makes the run `run.py --trace 1` makes (harness.run_cell) and prints,
as one JSON line after the run's result line: the profiled cycle's idle
seconds by innermost program span (`idle_by_span`, and by the span's
path from its root, `idle_by_path`), the share of the idle time inside a
span below a `frame` span (`idle_below_frame`), the syncs and their
seconds by site in the cycle (`syncs_by_site`), the spans' count and
self seconds by name (`self_s`), and of `track_frame`, `map_chunk` and
`map_chunk_dynamic` the milliseconds, host milliseconds outside the syncs
and syncs per iteration (`per_iter`). A program without the tracer leaves
these empty."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])


def report(reads, spans) -> dict:
    from benchmark import devtrace, progspans

    tr = reads.trace
    if tr is None or not spans:
        return {}
    idx = progspans.in_stretch(spans, tr)
    own = progspans.self_ns(spans)
    self_s: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for i in idx:
        self_s[spans[i].name][0] += 1
        self_s[spans[i].name][1] += own[i] / 1e9
    per_iter = {}
    for name in ("track_frame", "map_chunk", "map_chunk_dynamic"):
        sel = [i for i in idx if spans[i].name == name]
        work = sum(spans[i].work for i in sel)
        if work:
            ms = sum(spans[i].t1_ns - spans[i].t0_ns for i in sel) / 1e6 / work
            host = progspans.per_work(spans, name, tr, "host_ms")
            per_iter[name] = {"calls": len(sel), "iters": work, "ms": ms, "host_ms": host,
                              "host_share": host / ms,
                              "syncs": progspans.per_work(spans, name, tr, "syncs")}
    by_path = progspans.idle_by_span(tr, spans, full_path=True)
    idle = sum(v for _, v in by_path)
    # inside a span below a frame: a path of two names or more from a frame,
    # or a span whose frame began before the profiler (its root not recorded)
    below = sum(v for k, v in by_path
                if k != progspans.OUTSIDE and (k.startswith("frame/") or not
                                               k.startswith("frame")))
    return {"idle_s": idle, "window_s": devtrace.window_s(tr), "busy_s": devtrace.busy_s(tr),
            "idle_below_frame": below / idle if idle else None, "per_iter": per_iter,
            "idle_by_span": progspans.idle_by_span(tr, spans),
            "idle_by_path": by_path[:40],
            "syncs_by_site": progspans.syncs_by_site(spans, idx),
            "self_s": sorted(([k, n, s] for k, (n, s) in self_s.items()), key=lambda x: -x[2])}


def main(argv) -> int:
    import benchmark.run  # noqa: F401  (the cache directories)
    from benchmark import harness, progspans

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--json", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    seen = {}
    readings = harness._readings

    def keep(*a, **kw):
        seen["reads"] = readings(*a, **kw)
        return seen["reads"]

    harness._readings = keep
    result = harness.run_cell(args.workload, args.seed, args.seconds, True, t_start=T_START)
    result.pop("numbers")
    out = report(seen["reads"], progspans.recorded())
    print(json.dumps(result))
    print(json.dumps(out))
    if args.json:
        Path(args.json).write_text(json.dumps({"result": result, "report": out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
