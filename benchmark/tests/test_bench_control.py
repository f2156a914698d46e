"""The control on the card: the reference computed one precision lower
(TF32 matmuls, the compositor's field table in bfloat16) in the
program's place fails at least one compared number of each cell, and in
the 4D cell one of the deformation field's, at a size a test run holds
(small.py). On the card:
`python -m pytest -m cuda benchmark/tests/test_bench_control.py`."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.small import shrink


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tum-fr3-static.walk", "bonn-balloon-4d.blob"])
@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_control_fails_a_number(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = harness.run_cell(cell, seed, 0.0, False, t_start=time.perf_counter(),
                           overrides=shrink, control=True)
    # the ATE's limit is the configuration's at full size (see
    # test_bench_faults.py); every other number passes
    limits = {k: c["limit"] for k, c in res["checks"].items() if k != "ate"}
    assert all(res["checks"][k]["value"] <= lim for k, lim in limits.items()), res["checks"]
    control = res["control"]["control"]
    over = [k for k, v in control.items() if k in limits and not v <= limits[k]]
    assert over, (control, limits)
    if cell.startswith("bonn"):
        assert {"dyn_warp", "dyn_field_bwd", "dyn_field_step"} & set(over), (control, limits)
