"""Host milliseconds per 4D mapping iteration outside the waits for the
device: as map_host_ms_per_iter, for the program's own
`map_chunk_dynamic` spans of the profiled cycle. None where the program
recorded no such span. Moves `fps`."""

SOURCE, UNIT, MOVES = "program_span", "ms", "fps"


def read(r):
    from benchmark.progspans import per_work, recorded

    return per_work(recorded(), "map_chunk_dynamic", r.trace, "host_ms")
