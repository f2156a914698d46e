"""The port's tracer (`fourdgs_torch/utils/trace.py`): spans nest with
their parents and self times, record only while recording is on (by
`enable()` or under `torch.profiler`), and sync sites count whether
recording or not; a 64x48 `track_frame` and `map_chunk` count exactly the
syncs their loops' structure makes, site by site, and give the same
results bit for bit with tracing on and off; `SLAM.run` nests its phases
under a `frame` span per frame, and sets `phase_s` when it stops early;
the command line's `--trace` writes a Chrome trace.

The `cuda` cases run on the card (they skip without one):

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py

(`--noconftest`: tests/conftest.py configures JAX, which these tests do
not use): the tracer's sync count equals the warnings of
`torch.cuda.set_sync_debug_mode("warn")` over a `track_frame` and a
`map_chunk`; a span around a kernel and its synchronisation holds the
kernel's device interval in a profile; and tracing on adds no
synchronising runtime call."""

import json
import math
import time
import types
import warnings
from collections import Counter

import numpy as np
import pytest
import torch
import yaml

from fourdgs_torch import cli
from fourdgs_torch.geometry.se3 import se3_exp
from fourdgs_torch.models import gaussian_map as gm
from fourdgs_torch.ops.rasterize.api import RasterConfig
from fourdgs_torch.slam import keyframes as kfs
from fourdgs_torch.slam.camera import Intrinsics, make_frame
from fourdgs_torch.slam.mapping import MappingConfig, init_pose_adam, map_chunk
from fourdgs_torch.slam.runner import SLAM
from fourdgs_torch.slam.tracking import TrackingConfig, track_frame
from fourdgs_torch.utils import trace
from fourdgs_torch.utils.config import ConfigDict

W, H = 64, 48
INTR = Intrinsics(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=W, height=H)
RASTER = RasterConfig(max_pairs=1 << 13)
TRACK_CFG = TrackingConfig(max_iters=20, rebin_delta_threshold=0.003, alpha=0.9,
                           raster=RASTER)
MAP_CFG = MappingConfig(num_window_views=3, num_random_views=2, alpha=0.9, raster=RASTER)
MAP_ITERS = 5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_tracer():
    """Recording off and no spans, before and after each test."""
    trace.clear()
    with trace.enable(False):
        yield
    trace.clear()


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def _self_ns(spans, i):
    return (spans[i].t1_ns - spans[i].t0_ns) - sum(c.t1_ns - c.t0_ns
                                                   for c in _children(spans, i))


def test_spans_nest_with_parents_and_self_time():
    with trace.enable():
        with trace.span("outer", 3) as outer:
            time.sleep(0.02)
            with trace.span("inner"):
                time.sleep(0.03)
            with trace.span("second") as second:
                second.work = 7
                with trace.sync("site.a", 2):
                    pass
        with trace.span("after"):
            pass
    sp = trace.spans()
    assert [s.name for s in sp] == ["outer", "inner", "second", "sync", "after"]
    assert [s.parent for s in sp] == [-1, 0, 0, 2, -1]
    assert [s.work for s in sp] == [3, 0, 7, 2, 0]
    assert sp[3].site == "site.a" and sp[3].syncs_at_end - sp[3].syncs_at_start == 2
    assert sp[0].syncs_at_end - sp[0].syncs_at_start == 2
    assert all(s.t0_ns <= s.t1_ns for s in sp)
    for c in _children(sp, 0):   # children lie inside their parent
        assert sp[0].t0_ns <= c.t0_ns and c.t1_ns <= sp[0].t1_ns
    assert 0.018e9 <= _self_ns(sp, 0) <= 0.028e9
    assert _self_ns(sp, 1) >= 0.028e9
    assert outer.seconds >= 0.05
    # an exception closes every span on its way out
    with trace.enable(), pytest.raises(ValueError):
        with trace.span("raises"):
            with trace.span("deeper"):
                raise ValueError
    assert [(s.name, s.parent) for s in trace.spans()[-2:]] == [("raises", -1), ("deeper", 5)]


def test_off_records_nothing_but_counts_syncs():
    assert not trace.recording()
    before, sites = trace.sync_count(), trace.counts()["sync"]
    with trace.span("a") as a, trace.sync("site.b"), trace.sync("site.c", 2):
        a.work = 3   # ignored
    with trace.span("clocked", clock=True) as c:
        time.sleep(0.01)
    assert trace.spans() == []
    assert trace.sync_count() - before == 3
    after = trace.counts()["sync"]
    assert after["site.b"] - sites.get("site.b", 0) == 1
    assert after["site.c"] - sites.get("site.c", 0) == 2
    assert c.seconds >= 0.009
    # the kernels' launch counters sit in the same registry
    assert {"composite_fwd.launches_by_views", "composite_bwd.launches_by_views"} <= set(
        trace.counts())


def test_spans_recorded_under_the_profiler_and_bounded(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.recording()
        with trace.span("profiled"):
            torch.ones(4).sum()
    with trace.span("not"):
        pass
    assert [s.name for s in trace.spans()] == ["profiled"]
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with trace.enable():
        for _ in range(4):
            with trace.span("x"):
                pass
    assert len(trace.spans()) == 3 and trace.dropped() == 2


def _state(dev):
    """A map spawned from a textured 64x48 RGB-D view (anisotropic scales),
    and 4 keyframes of that view at perturbed poses (uid 0 in slot 0)."""
    v, u = np.mgrid[0:H, 0:W]
    img = np.stack([0.5 + 0.4 * np.sin(u / 4.0), 0.5 + 0.4 * np.cos(v / 6.0),
                    0.5 + 0.3 * np.sin((u + v) / 7.0)]).astype(np.float32)
    depth = np.full((H, W), 3.0, np.float32)
    depth[15:35, 20:45] = 2.0
    motion = np.ones((H, W), bool)
    motion[5:12, 40:50] = False
    cap = 1024
    keep = torch.as_tensor(np.random.default_rng(1).uniform(size=H * W).astype(np.float32),
                           device=dev)
    cands = gm.candidates_from_rgbd(keep, torch.as_tensor(img, device=dev),
                                    torch.as_tensor(depth, device=dev), torch.eye(4, device=dev),
                                    INTR.fx, INTR.fy, INTR.cx, INTR.cy, downsample=6,
                                    max_new=cap)
    gmap, adam, _ = gm.insert(gm.empty_map(cap, dev), gm.init_adam(cap, dev), cands, kf_id=0)
    rng = np.random.default_rng(2)
    aniso = np.array([-0.4, 0.0, 0.4], np.float32)[rng.permuted(np.tile([0, 1, 2], (cap, 1)),
                                                                axis=1)]
    # opaque enough that the final render has a median depth (opacity > 0.95)
    gmap = gmap._replace(params=gmap.params._replace(
        scaling=gmap.params.scaling + torch.as_tensor(aniso, device=dev) * gmap.alive[:, None],
        opacity=torch.full_like(gmap.params.opacity, 4.0)))
    store = kfs.empty_store(6, H, W, dev)
    taus = [np.zeros(6), [0.03, 0, 0, 0, 0.01, 0], [-0.02, 0.01, 0, 0, -0.01, 0.005],
            [0, -0.02, 0.01, 0.005, 0, 0]]
    for slot, tau in enumerate(taus):
        T = se3_exp(torch.tensor(tau, dtype=torch.float32, device=dev))
        kfs.store_keyframe(store, slot, make_frame(slot, img, depth, np.eye(4), slot / 4, motion,
                                                   device=dev), T, [0.01 * slot, 0.0])
    frame = make_frame(1, img, depth, np.eye(4), 0.5, motion, device=dev)
    T0 = se3_exp(torch.tensor([0.02, -0.015, 0.01, 0.006, -0.008, 0.004], device=dev))
    return gmap, adam, store, frame, T0, torch.tensor([0.01, -0.02], device=dev)


def _track(state, dev):
    gmap, _, _, frame, T0, exposure = state
    return track_frame(gmap, frame, T0, exposure, INTR, TRACK_CFG)


def _map(state, dev):
    gmap, adam, store = state[:3]
    picks = np.random.default_rng(3).integers(0, [2, 1], (MAP_ITERS, 2))
    return map_chunk(gmap, adam, store._replace(T_cw=store.T_cw.clone(),
                                                exposure=store.exposure.clone()),
                     np.array([1, 2, 3]), np.array([True, True, True]),
                     np.array([True, True, False]), np.array([0, 3, 0, 0, 0, 0, 0, 0]), 2,
                     init_pose_adam(3, dev), picks, MAP_ITERS, 2, 40, INTR, MAP_CFG)


def _site_delta(before: dict) -> dict:
    after = trace.counts()["sync"]
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _bins(n: int) -> dict:
    """The syncs of n binnings: the nonzero and two bincounts of two reads."""
    return {"bin.nonzero": n, "bin.tile_count": 2 * n, "bin.view_pairs": 2 * n}


class _Runs:
    """A `track_frame` and a `map_chunk` run with tracing off, then on: the
    results, and of the run with tracing on, each call's syncs by site
    and its spans."""

    def __init__(self):
        state = _state("cpu")
        self.off = (_track(state, "cpu"), _map(state, "cpu"))
        trace.clear()
        with trace.enable():
            before, iters = trace.counts()["sync"], trace.counts()["track"]
            track = _track(state, "cpu")
            self.track_syncs = _site_delta(before)
            self.track_iters = {k: v - iters[k] for k, v in trace.counts()["track"].items()}
            before = trace.counts()["sync"]
            self.on = (track, _map(state, "cpu"))
            self.map_syncs = _site_delta(before)
        self.spans = trace.spans()


@pytest.fixture(scope="module")
def runs():
    return _Runs()


def test_track_frame_syncs_by_site(runs):
    res, sp = runs.on[0], runs.spans
    top = next(i for i, s in enumerate(sp) if s.name == "track_frame")
    assert sp[top].work == res.n_iters
    kids = [s.name for s in _children(sp, top)]
    # the rounds: a bin, then up to rebin_every iterations
    rounds = kids.count("bin")
    runs_ = "".join("b" if k == "bin" else "i" if k == "track_iter" else "" for k in kids)
    assert runs_.startswith("b") and all(0 < len(r) <= 8 for r in runs_.split("b")[1:])
    assert kids.count("track_iter") == res.n_iters < TRACK_CFG.max_iters
    assert rounds > math.ceil(res.n_iters / 8)   # steps past the threshold cut rounds short
    assert kids[-1] == "track_render"
    n = res.n_iters
    want = {"track.lr_h2d": 1, "proj.h2d": 1, "bin.overflow": rounds,
            "bin.num_pairs": rounds, "track.step": n, "median.nonzero": 1,
            "track.render_overflow": 1, "track.render_pairs": 1, **_bins(rounds + 1)}
    assert not math.isnan(float(res.median_depth))   # else median.nan_h2d too
    assert runs.track_syncs == want
    syncs = sp[top].syncs_at_end - sp[top].syncs_at_start
    inside = [s for s in sp if s.name == "sync" and sp[top].t0_ns <= s.t0_ns <= sp[top].t1_ns]
    assert syncs == sum(want.values()) == sum(s.work for s in inside)


def test_track_frame_runs_eagerly_on_the_cpu(runs):
    """CPU tensors take the eager loop: no CUDA graph is captured or replayed."""
    assert runs.track_iters == {"graph_captures": 0, "graph_replays": 0,
                                "eager_iters": runs.on[0].n_iters}


def test_map_chunk_syncs_by_site(runs):
    sp = runs.spans
    top = next(i for i, s in enumerate(sp) if s.name == "map_chunk")
    assert sp[top].work == MAP_ITERS
    assert [s.name for s in _children(sp, top)].count("map_iter") == MAP_ITERS
    # window views re-binned every rebin_every iterations, replay views every one
    n_bins = math.ceil(MAP_ITERS / MAP_CFG.rebin_every) + MAP_ITERS
    want = {"map.pose_mask": 3, "map.lr_h2d": 1, "map.window_h2d": 2, "proj.h2d": 1,
            "map.slots_h2d": MAP_ITERS, "map.ids_h2d": MAP_ITERS, "map.loss": 1,
            "map.seen": 2, **_bins(n_bins)}
    assert runs.map_syncs == want
    assert sp[top].syncs_at_end - sp[top].syncs_at_start == sum(want.values())


def _equal(a, b):
    if isinstance(a, torch.Tensor):   # NaN where NaN
        return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("call", ["track_frame", "map_chunk"])
def test_results_equal_bit_for_bit_with_tracing_on_and_off(runs, call):
    i = ["track_frame", "map_chunk"].index(call)
    assert any(s.name == call for s in runs.spans)
    assert _equal(runs.off[i], runs.on[i])


N_FRAMES = 7


def _slam_config():
    return {
        "Results": {"save_results": False, "use_gui": False, "eval_rendering": False,
                    "use_wandb": False},
        "Dataset": {"type": "synthetic", "sensor_type": "depth", "num_frames": N_FRAMES,
                    "points_per_wall": 200, "pcd_downsample": 32, "pcd_downsample_init": 16,
                    "adaptive_pointsize": True, "point_size": 0.05,
                    "Calibration": {"fx": 80.0, "fy": 80.0, "cx": (W - 1) / 2,
                                    "cy": (H - 1) / 2, "width": W, "height": H,
                                    "depth_scale": 1.0, "distorted": False}},
        "Training": {
            "init_itr_num": 4, "init_gaussian_update": 40, "init_gaussian_reset": 2000,
            "tracking_itr_num": 4, "mapping_itr_num": 4, "keyframe_mapping_iters": 4,
            "gaussian_update_every": 10000, "gaussian_reset": 20001, "kf_interval": 3,
            "window_size": 3, "pose_window": 2, "kf_overlap": 1.01,
            "lr": {"cam_rot_delta": 0.003, "cam_trans_delta": 0.001},
        },
        "model_params": {"sh_degree": 0, "dynamic_model": False},
    }


def test_runner_phases_nest_under_frames():
    slam = SLAM(ConfigDict.wrap(_slam_config()), capacity=2048, max_keyframes=8, device="cpu")
    with trace.enable():
        slam.run()
    sp = trace.spans()
    frames = [i for i, s in enumerate(sp) if s.name == "frame"]
    assert len(frames) == N_FRAMES and all(sp[i].parent == -1 for i in frames)
    kids = [[c.name for c in _children(sp, i)] for i in frames]
    assert kids[0] == ["fetch", "init"]
    for k in kids[1:]:
        assert k[:2] == ["fetch", "track"] and set(k) <= {"fetch", "track", "kf_check",
                                                         "keyframe"}
    keyframes = [i for i, s in enumerate(sp) if s.name == "keyframe"]
    assert len(keyframes) == len(slam.kf_indices) - 1
    for i in keyframes:
        names = [c.name for c in _children(sp, i)]
        assert {"spawn", "window", "map_chunk", "resync"} <= set(names)
        assert set(names) <= {"spawn", "window", "map_chunk", "densify", "resync"}
    for name, parent in (("track_frame", "track"), ("map_chunk", "keyframe"),
                         ("map_chunk", "init"), ("track_iter", "track_frame"),
                         ("map_iter", "map_chunk")):
        assert parent in {sp[s.parent].name for s in sp if s.name == name}, name
    # the phase clocks are the phase spans' times
    track = sum(s.t1_ns - s.t0_ns for s in sp if s.name == "track") / 1e9
    assert slam.metrics["phase_s"]["track"] == pytest.approx(track, rel=1e-6)


class _Stop(Exception):
    pass


class _Stops:
    """The runner's dataset, raising `_Stop` at the fetch of frame `at`."""

    def __init__(self, inner, at):
        self._inner, self._at = inner, at

    def __len__(self):
        return len(self._inner)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __getitem__(self, idx):
        if idx == self._at:
            raise _Stop
        return self._inner[idx]


def test_phase_s_when_the_run_stops_early():
    slam = SLAM(ConfigDict.wrap(_slam_config()), capacity=2048, max_keyframes=8, device="cpu")
    slam.dataset = _Stops(slam.dataset, 6)
    with pytest.raises(_Stop):
        slam.run(warmup_frames=2)
    ph = slam.metrics["phase_s"]
    # steady state: frames 2-5 tracked, 4 iterations each; keyframe 3 mapped
    assert ph["track_iters"] == 4 * 4
    assert ph["track"] > 0 and ph["keyframe"] > 0
    assert "fps" not in slam.metrics


def test_cli_writes_a_chrome_trace(tmp_path):
    cfg = tmp_path / "run.yaml"
    cfg.write_text(yaml.safe_dump(_slam_config()))
    out = tmp_path / "trace.json"
    cli.main(["--config", str(cfg), "--device", "cpu", "--max-frames", "4",
              "--trace", str(out)])
    doc = json.loads(out.read_text())
    events = doc["traceEvents"]
    track = [e for e in events if e["name"] == "track_frame"]
    assert len(track) == 3 and all(e["ph"] == "X" and e["dur"] > 0 for e in track)
    assert all(e["args"]["work"] == 4 for e in track)
    counters = {e["name"]: e["args"] for e in events if e["ph"] == "C"}
    assert counters["sync"]["track.step"] >= 12
    assert not trace.recording()


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_sync_count_equals_the_sync_debug_warnings(cuda):
    state = _state(cuda)
    _track(state, cuda), _map(state, cuda)     # builds the kernels
    torch.cuda.synchronize()
    before = trace.counts()["sync"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _track(state, cuda)
            _map(state, cuda)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the warning of each synchronising operation (setting the mode warns
    # once, that the mode is a prototype)
    syncs = [w for w in caught if "synchronizing" in str(w.message)
             and "prototype" not in str(w.message)]
    where = Counter(f"{w.filename.rsplit('/', 2)[-1]}:{w.lineno}" for w in syncs)
    counted = _site_delta(before)
    assert sum(counted.values()) == len(syncs) > 0, (dict(counted), dict(where))


@pytest.mark.cuda
def test_a_span_holds_its_kernels_on_the_device_clock(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.span("known"):
            y = x @ x
            torch.cuda.synchronize()
    assert y.shape == x.shape
    sp = [s for s in trace.spans() if s.name == "known"]
    assert len(sp) == 1
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    assert ops, "the profile holds no device operation"
    for t0, t1, name in ops:
        assert sp[0].t0_ns <= t0 <= t1 <= sp[0].t1_ns, (name, t0 - sp[0].t0_ns,
                                                        sp[0].t1_ns - t1)


def _sync_calls(fn) -> Counter:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter(e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() != DeviceType.CUDA
                   and ("Synchronize" in e.name() or e.name().startswith("cudaMemcpy")))


@pytest.mark.cuda
def test_tracing_adds_no_synchronising_runtime_call(cuda, monkeypatch):
    state = _state(cuda)

    def run():
        _track(state, cuda)
        _map(state, cuda)

    run()
    on = _sync_calls(run)
    assert any(s.name == "track_frame" for s in trace.spans())
    trace.clear()
    # the profiler's flag hidden from the tracer: the same profile, tracing off
    monkeypatch.setattr(trace, "_autograd_profiler", types.SimpleNamespace())
    off = _sync_calls(run)
    assert trace.spans() == []
    assert on == off and on["cudaStreamSynchronize"] > 0, (dict(on), dict(off))
