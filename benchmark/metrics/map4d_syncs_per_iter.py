"""Host synchronisations per 4D mapping iteration: as
map_syncs_per_iter, inside the program's own `map_chunk_dynamic` spans of
the profiled cycle (its `dyn.*` sync sites and those below), over their
iterations. None where the program recorded no such span. Moves `fps`."""

SOURCE, UNIT, MOVES = "program_counter", "syncs", "fps"


def read(r):
    from benchmark.progspans import per_work, recorded

    return per_work(recorded(), "map_chunk_dynamic", r.trace, "syncs")
