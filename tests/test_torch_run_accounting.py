"""`fourdgs_torch.slam.runner.SLAM.run(warmup_frames)` against the JAX
runner's accounting (fourdgs/slam/runner.py `run`) on the 4-frame 64x48
parity run of tests/test_torch_slam.py, both runners fed the same draws
and rendering through their tile compositors: `fps_steady` is set exactly
when the reference sets it (warmup_frames > 0 and fewer than the frames
run), the steady-state phase counts (tracking iterations, from frame
`warmup_frames` on) are equal, and `fps` covers the whole run. A clock
that jumps 1000 s in frame 0's initialisation tells the whole run from the
steady state on either side."""

import time
import types

import numpy as np
import pytest

from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.slam import runner as jrunner
from fourdgs.utils.config import ConfigDict as JConfigDict
from fourdgs_torch.slam import runner as trunner
from fourdgs_torch.utils.config import ConfigDict
from tests.test_torch_slam import JaxDraws, _config, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 4
INIT_S = 1000.0   # what the clock jumps in frame 0's initialisation
# tests/test_torch_slam.py::test_slam_run_matches_jax's run: initialisation,
# frames 1-3 tracked (6 iterations each), a keyframe at frame 2
CFG = _config(N, 64, 48, 60.0, init_itr_num=5, init_gaussian_update=3, tracking_itr_num=6,
              keyframe_mapping_iters=4, mapping_itr_num=4, kf_interval=2, kf_overlap=1.01)


def _jumping_clock(monkeypatch, module):
    """Give `module` a clock that runs with the wall clock but jumps INIT_S
    seconds when its runner initialises the map on frame 0."""
    jump = [0.0]
    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        time=lambda: time.time() + jump[0]))
    initialize = module.SLAM._initialize

    def slow_initialize(self, frame):
        initialize(self, frame)
        jump[0] += INIT_S

    monkeypatch.setattr(module.SLAM, "_initialize", slow_initialize)


@pytest.mark.parametrize("warmup", [0, 2, N])
def test_run_accounting_matches_jax(warmup, monkeypatch):
    _jumping_clock(monkeypatch, jrunner)
    _jumping_clock(monkeypatch, trunner)
    t = time.time()
    jslam = jrunner.SLAM(JConfigDict.wrap(CFG), capacity=4096, max_keyframes=8,
                         raster=JRasterConfig(use_oracle=False, tile_cap=256,
                                              max_pairs=1 << 13))
    jm = dict(jslam.run(warmup_frames=warmup))
    tslam = trunner.SLAM(ConfigDict.wrap(CFG), capacity=4096, max_keyframes=8, device="cpu",
                         draws=JaxDraws(0))
    tm = tslam.run(warmup_frames=warmup)
    wall = time.time() - t

    assert tslam.kf_indices == jslam.kf_indices == [0, 2]
    # fps_steady exactly where the reference sets it
    assert ("fps_steady" in tm) == ("fps_steady" in jm) == (0 < warmup < N)
    for m in (jm, tm):
        # fps over the whole run, initialisation included
        assert N / (INIT_S + wall) < m["fps"] < N / INIT_S, m
        if "fps_steady" in m:
            # from frame `warmup` on: the initialisation left out
            assert m["fps_steady"] > (N - warmup) / wall, m
    # steady-state attribution: the phase clocks start again at frame
    # `warmup` (never, past the run), on either side
    ph, jph = tm["phase_s"], jslam._phase
    steady = range(max(warmup, 1), N) if warmup < N else range(1, N)
    assert ph["track_iters"] == int(jph["track_iters"]) == len(steady) * 6
    assert ph["dyn_iters"] == 0 and ph["dyn_mapping"] == 0.0
    for k in ("track", "kf_check", "keyframe"):
        assert 0 <= ph[k] < wall and 0 <= jph[k] < wall, (k, ph, jph)
    np.testing.assert_allclose(tslam.poses_est[N - 1], jslam.poses_est[N - 1], atol=1e-3)
