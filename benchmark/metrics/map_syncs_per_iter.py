"""Host synchronisations per keyframe mapping iteration: as
track_syncs_per_iter, inside the program's own `map_chunk` spans of the
profiled cycle, over their iterations. None where the program recorded
no such span. Moves `fps`."""

SOURCE, UNIT, MOVES = "program_counter", "syncs", "fps"


def read(r):
    from benchmark.progspans import per_work, recorded

    return per_work(recorded(), "map_chunk", r.trace, "syncs")
