"""Share of its roofline the backward compositor kernel reaches
(`csrc/composite_bwd.cu`): as composite_fwd_roofline, for the backward
calls and `composite_bwd_kernel`. Moves `fps`."""

SOURCE, UNIT, MOVES = "device_trace", "%", "fps"


def read(r):
    bound, device = r.roofline.get("bwd", (0.0, 0.0))
    return 100.0 * bound / device if device > 0 and bound > 0 else None
