"""Share of its roofline the forward compositor kernel reaches
(`ops/rasterize/kernels.py` + `csrc/composite_fwd.cu`): the least time
the card could take for a call of the profiled cycle (benchmark/
roofline.py, counted from the inputs of every eighth call, by number of
views, each call given the mean of its view count's) over the mean
device time of a `composite_fwd_kernel` in the cycle's trace. A ratio of
means, so a few activity records the profiler drops do not move it.
Silent where the trace holds no kernel of that name. Moves `fps`."""

SOURCE, UNIT, MOVES = "device_trace", "%", "fps"


def read(r):
    bound, device = r.roofline.get("fwd", (0.0, 0.0))
    return 100.0 * bound / device if device > 0 and bound > 0 else None
