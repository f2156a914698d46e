"""Milliseconds per frame fetch of the recorded sequence: the span around
each `__getitem__` of the runner's dataset (`data/tum.py`, two PNG
decodes), in the window's unprofiled cycles. Moves `fps`."""

SOURCE, UNIT, MOVES = "program_span", "ms", "fps"


def read(r):
    return r.per_work("fetch", 1e3)
