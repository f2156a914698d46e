"""Share of the profiled cycle in which no operation ran on the device:
1 minus the union of the device operations' intervals over the cycle's
wall time (chip_smoke.py's `_device_profile` method). The profiler's own
host overhead lengthens the cycle, so this reads above an unprofiled
run's idle share. Moves `fps`."""

SOURCE, UNIT, MOVES = "device_trace", "%", "fps"


def read(r):
    from benchmark.devtrace import busy_s, window_s

    if r.trace is None or window_s(r.trace) <= 0:
        return None
    return 100.0 * (1.0 - busy_s(r.trace) / window_s(r.trace))
