"""Milliseconds per tracking iteration: the benchmark's synchronised span
around each of the runner's calls of `slam/tracking.py` `track_frame`,
over the iterations the call reports (`n_iters`), in the window's
unprofiled cycles. Moves `fps`."""

SOURCE, UNIT, MOVES = "program_span", "ms", "fps"


def read(r):
    return r.per_work("track_frame", 1e3)
