"""Milliseconds per 4D mapping iteration: the synchronised span around
each of the runner's calls of `slam/mapping_dynamic.py`
`map_chunk_dynamic`, over the call's `num_iters`, in the window's
unprofiled cycles. Moves `fps`."""

SOURCE, UNIT, MOVES = "program_span", "ms", "fps"


def read(r):
    return r.per_work("map_chunk_dynamic", 1e3)
