"""Kernels launched per tracking iteration: the device trace's kernels
(copies and fills left out) that ran inside the `track_frame` spans of
the profiled cycle, over those spans' iterations. Moves `fps`."""

SOURCE, UNIT, MOVES = "device_trace", "launches", "fps"


def read(r):
    from benchmark.devtrace import kernels_in

    if r.trace is None:
        return None
    sp = [s for s in r.spans if s.name == "track_frame" and s.profiled]
    iters = sum(s.work for s in sp)
    if not iters:
        return None
    n = sum(kernels_in(r.trace, s.t0_ns, s.t1_ns) for s in sp)
    return n / iters if n else None
