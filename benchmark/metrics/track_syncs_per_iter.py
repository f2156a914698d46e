"""Host synchronisations per tracking iteration: the syncs the program
counts (`fourdgs_torch/utils/trace.py` sync sites: its reads of device
values and its copies from host memory, each a wait for the device)
inside its own `track_frame` spans of the profiled cycle, over those
spans' iterations. None where the program recorded no such span (a
program without the tracer). Moves `fps`."""

SOURCE, UNIT, MOVES = "program_counter", "syncs", "fps"


def read(r):
    from benchmark.progspans import per_work, recorded

    return per_work(recorded(), "track_frame", r.trace, "syncs")
