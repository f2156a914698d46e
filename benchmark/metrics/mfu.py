"""The whole step's share of the card's float32 peak (67 TFLOP/s, H100
SXM at 700 W): the float32 operations the window's unprofiled cycles
require, the compositor's forward and backward counted from their
inputs (estimated from every eighth call, by number of views) plus, in
the 4D cell, the deformation MLP's products on the points it is
evaluated on, over those cycles' seconds. Moves `fps`."""

SOURCE, UNIT, MOVES = "program_counter", "%", "fps"


def read(r):
    from benchmark.roofline import PEAK_FP32_OPS_S

    if r.ops is None or not r.ops > 0 or r.ops_s <= 0:
        return None
    return 100.0 * r.ops / (r.ops_s * PEAK_FP32_OPS_S)
