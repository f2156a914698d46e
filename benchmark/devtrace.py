"""Reduction of a `torch.profiler` trace of the window's profiled cycle.

The profiler records CUDA activity only: the device's kernels, copies and
fills, and the host's CUDA runtime calls. Its timestamps are the host's
`time.time_ns()`, so the benchmark's own spans (hooks.Span) place every
device operation in the layer whose call launched it: a span is closed
by a device synchronisation, so its kernels run inside it.

Busy time is the union of the device operations' intervals inside the
profiled stretch, and idle the rest (the method of chip_smoke.py's
`_device_profile`, lines 332-352 at commit c19f610, which set the
profiler's device time against the wall time of the same stretch). The
profiler's own host overhead lengthens the stretch, so the idle share it
gives is an upper estimate of the unprofiled run's.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple


class DeviceOp(NamedTuple):
    t0: int
    t1: int
    name: str


class Trace(NamedTuple):
    t0: int                         # the profiled stretch, time.time_ns()
    t1: int
    ops: list                       # DeviceOp, by start
    runtime: list                   # host CUDA runtime calls (t0, t1, name), by start


def collect(prof, t0: int, t1: int) -> Trace:
    """The device operations and host runtime calls of a stopped
    `torch.profiler.profile`, clipped to [t0, t1]."""
    from torch.autograd import DeviceType

    ops, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if s + d < t0 or s > t1:
            continue
        if e.device_type() == DeviceType.CUDA:
            ops.append(DeviceOp(s, s + d, e.name()))
        elif e.name().startswith("cuda"):
            runtime.append((s, s + d, e.name()))
    ops.sort()
    runtime.sort()
    return Trace(t0, t1, ops, runtime)


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def busy_intervals(tr: Trace) -> list[tuple[int, int]]:
    """The union of the device operations' intervals inside the stretch."""
    merged: list[list[int]] = []
    for op in tr.ops:
        a, b = max(op.t0, tr.t0), min(op.t1, tr.t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) / 1e9


def window_s(tr: Trace) -> float:
    return (tr.t1 - tr.t0) / 1e9


def top_ops(tr: Trace, n: int = 10) -> list[list]:
    """The device operations that took most time, summed by name."""
    tot: dict[str, float] = defaultdict(float)
    for op in tr.ops:
        tot[op.name[:120]] += (op.t1 - op.t0) / 1e9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _span_at(spans, t: int) -> str:
    for sp in spans:
        if sp.t0_ns <= t <= sp.t1_ns:
            return sp.name
    return "runner"


def idle_gaps(tr: Trace, spans, n: int = 10) -> list[list]:
    """The device's idle time inside the stretch, summed by what the host
    was doing: the benchmark's span around it (`runner` outside every
    span) and the CUDA runtime call in progress at the gap's middle
    (`host` where none was: Python, or the program's host work)."""
    busy = busy_intervals(tr)
    edges = [tr.t0] + [x for ab in busy for x in ab] + [tr.t1]
    starts = [r[0] for r in tr.runtime]
    inside = [sp for sp in spans if sp.t1_ns >= tr.t0 and sp.t0_ns <= tr.t1]
    tot: dict[str, float] = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        call = tr.runtime[i][2] if i >= 0 and tr.runtime[i][1] >= mid else "host"
        tot[f"{_span_at(inside, mid)}: {call}"] += (b - a) / 1e9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def kernels_in(tr: Trace, t0: int, t1: int) -> int:
    """Kernels that started inside [t0, t1]."""
    starts = [op.t0 for op in tr.ops]
    lo, hi = bisect.bisect_left(starts, t0), bisect.bisect_right(starts, t1)
    return sum(1 for op in tr.ops[lo:hi] if is_kernel(op.name))


def named(tr: Trace, fragment: str) -> list[DeviceOp]:
    """The device operations whose name holds `fragment`, by start."""
    return [op for op in tr.ops if fragment in op.name]
