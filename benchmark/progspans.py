"""Reduction of the program's own spans (`fourdgs_torch/utils/trace.py`),
as devtrace.py reduces the device trace.

The program records its spans while a `torch.profiler` session records,
so a `--trace 1` run holds those of the window's profiled cycle, with no
call from the benchmark; a test may turn recording on by hand
(`trace.enable()`). A span is (name, t0_ns, t1_ns, parent, work,
syncs_at_start, syncs_at_end, site) on the `time.time_ns()` clock, which
is the profiler's, so a program span and a device operation set against
each other directly. `parent` indexes the span list (-1: none); spans
named `sync` are the host's waits for the device, `site` naming the read.

Where the program has no tracer (an older checkout) or recorded no span,
`recorded()` is empty and every reader built on it reads None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

OUTSIDE = "(no program span)"


def recorded() -> list:
    """The program's recorded spans, or [] where it has no tracer."""
    try:
        from fourdgs_torch.utils import trace
    except ImportError:
        return []
    return trace.spans()


def in_stretch(spans: list, tr) -> list[int]:
    """Indices of the spans that lie inside the profiled stretch of the
    device trace `tr` (devtrace.Trace), or of every span where there is
    no trace (a CPU run that recorded by hand)."""
    if tr is None:
        return list(range(len(spans)))
    return [i for i, s in enumerate(spans) if s.t0_ns >= tr.t0 and s.t1_ns <= tr.t1]


def children(spans: list) -> dict[int, list[int]]:
    kids: dict[int, list[int]] = defaultdict(list)
    for i, s in enumerate(spans):
        kids[s.parent].append(i)
    return kids


def self_ns(spans: list) -> list[int]:
    """Each span's own time: its duration less its children's."""
    own = [s.t1_ns - s.t0_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            own[s.parent] -= s.t1_ns - s.t0_ns
    return own


def descendants(spans: list, i: int) -> list[int]:
    """The spans below span i, at any depth."""
    kids, out, todo = children(spans), [], [i]
    while todo:
        for k in kids.get(todo.pop(), ()):
            out.append(k)
            todo.append(k)
    return out


def per_work(spans: list, name: str, tr, what: str) -> float | None:
    """Over the spans `name` inside the profiled stretch: their syncs
    (`what` "syncs"), or their milliseconds less those of the `sync`
    spans below them (`what` "host_ms"), over their summed work. None
    where no such span (or no work) was recorded."""
    sel = [i for i in in_stretch(spans, tr) if spans[i].name == name]
    work = sum(spans[i].work for i in sel)
    if not work:
        return None
    if what == "syncs":
        return sum(spans[i].syncs_at_end - spans[i].syncs_at_start for i in sel) / work
    host = 0
    for i in sel:
        waits = sum(spans[k].t1_ns - spans[k].t0_ns for k in descendants(spans, i)
                    if spans[k].name == "sync")
        host += spans[i].t1_ns - spans[i].t0_ns - waits
    return host / 1e6 / work


def innermost(spans: list) -> tuple[list[int], list[int]]:
    """The innermost span as a step function of time: (times, span index
    from each time on, -1 outside every span). The spans nest (one host
    thread), so at each start the span opens, at each end its parent
    resumes."""
    edges = []
    for i, s in enumerate(spans):
        edges.append((s.t0_ns, 1, i))
        edges.append((s.t1_ns, 0, i))
    # at a shared instant, ends before starts; among starts, outer first
    edges.sort(key=lambda e: (e[0], e[1], -(spans[e[2]].t1_ns - spans[e[2]].t0_ns)))
    times, who = [], []
    for t, start, i in edges:
        cur = i if start else spans[i].parent
        if times and times[-1] == t:
            who[-1] = cur
        else:
            times.append(t)
            who.append(cur)
    return times, who


def at(spans: list, t: int, steps=None) -> str:
    """The name of the innermost program span at instant t."""
    times, who = steps or innermost(spans)
    k = bisect.bisect_right(times, t) - 1
    return spans[who[k]].name if k >= 0 and who[k] >= 0 else OUTSIDE


def path(spans: list, i: int) -> str:
    """The span's name with those of its ancestors: `frame/track/...`."""
    names = []
    while i >= 0:
        names.append(spans[i].name)
        i = spans[i].parent
    return "/".join(reversed(names))


def idle_by_span(tr, spans: list, full_path: bool = False) -> list[list]:
    """The device's idle time inside the profiled stretch, split exactly
    among the innermost program spans the host was in (OUTSIDE where in
    none), largest first: [[name, seconds], ...]. With `full_path`, a
    span is named with its ancestors."""
    from benchmark.devtrace import busy_intervals

    busy = busy_intervals(tr)
    edges = [tr.t0] + [x for ab in busy for x in ab] + [tr.t1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    times, who = innermost(spans)
    tot: dict[str, float] = defaultdict(float)

    def name(i):
        if i < 0:
            return OUTSIDE
        return path(spans, i) if full_path else spans[i].name

    for a, b in idle:
        k = bisect.bisect_right(times, a) - 1
        t = a
        while t < b:
            nxt = times[k + 1] if k + 1 < len(times) else b
            end = min(b, nxt)
            if end > t:
                tot[name(who[k] if k >= 0 else -1)] += (end - t) / 1e9
            t = end
            k += 1
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])]


def syncs_by_site(spans: list, idx: list[int]) -> list[list]:
    """The `sync` spans among `idx` by site: [[site, syncs, seconds], ...],
    most seconds first."""
    n: dict[str, int] = defaultdict(int)
    sec: dict[str, float] = defaultdict(float)
    for i in idx:
        s = spans[i]
        if s.name == "sync":
            n[s.site] += s.work
            sec[s.site] += (s.t1_ns - s.t0_ns) / 1e9
    return [[k, n[k], sec[k]] for k in sorted(n, key=lambda k: -sec[k])]
