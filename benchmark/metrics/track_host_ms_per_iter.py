"""Host milliseconds per tracking iteration outside the waits for the
device: the program's own `track_frame` spans of the profiled cycle, less
the `sync` spans below them, over those spans' iterations (Python,
kernel launches and host work; the profiler's own overhead included).
None where the program recorded no such span. Moves `fps`."""

SOURCE, UNIT, MOVES = "program_span", "ms", "fps"


def read(r):
    from benchmark.progspans import per_work, recorded

    return per_work(recorded(), "track_frame", r.trace, "host_ms")
