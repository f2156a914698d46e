"""The graphed tracking loop (`fourdgs_torch/slam/tracking.py`: CUDA graphs
around the two eager compositor calls) against the eager loop, on the
card. Marked `cuda`; without a CUDA device every test skips. On a machine
with one:

    python -m pytest --noconftest -m cuda tests/test_torch_tracking_cuda.py

(`--noconftest`: tests/conftest.py configures JAX, which these tests do
not use.) The map is `kernel_check.sample_map()`'s: 100 initialisation
iterations on frame 0 of the synthetic sequence at 640x480, capacity
2^15; frame 1 is tracked from frame 0's pose at the benchmark's
configuration. Held: each graphed body gives what the same body gives
eagerly from the same state, bit for bit; the graphed call takes the eager
call's iteration count (within one, where a step lands at a threshold)
and its pose and exposure within the eager calls' spread among
themselves (the backward kernel sums with atomics, so no two calls agree
bit for bit), or 1e-6; one capture per map capacity;
the tracer's sync count equal to `set_sync_debug_mode`'s warnings; and
every compositor call of the loop reaching `compositor.composite_forward`
and `composite_backward` (n_iters + 1 and n_iters of them) with whole
bins."""

import itertools
import warnings

import pytest
import torch

from fourdgs_torch import kernel_check as KC
from fourdgs_torch.models import gaussian_map as gm
from fourdgs_torch.ops.rasterize import compositor
from fourdgs_torch.ops.rasterize.api import compute_bins
from fourdgs_torch.slam import tracking
from fourdgs_torch.utils import trace

pytestmark = pytest.mark.cuda

EAGER_RUNS = 4
FLOOR = 1e-6


@pytest.fixture(scope="module")
def sample():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    slam, frames = KC.sample_map()
    return slam, frames


@pytest.fixture
def fresh_graphs(monkeypatch):
    """No graph captured yet: each test starts with an empty cache."""
    monkeypatch.setattr(tracking, "_LOOPS", {})


def _track(slam, frame, *, eager=False, gmap=None, cfg=None, use_motion_mask=True):
    T_init = slam._pose_tensor(slam.poses_est[0])
    return tracking._track(gmap if gmap is not None else slam.gmap, frame, T_init,
                           torch.zeros(2, device=slam.device), slam.intr,
                           cfg or slam.track_cfg, use_motion_mask, _eager=eager)


def _counts() -> dict:
    return dict(trace.counts()["track"])


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


def _gap(a, b) -> float:
    return max(float((a.T_cw - b.T_cw).abs().max()), float((a.exposure - b.exposure).abs().max()))


def _equal(a, b) -> bool:
    return all(bool((x == y).all()) for x, y in zip(a, b))


@pytest.mark.parametrize("monocular,use_motion_mask", [(False, True), (False, False),
                                                       (True, True)])
def test_graphed_bodies_equal_eager_bodies(sample, fresh_graphs, monocular, use_motion_mask):
    slam, frames = sample
    cfg = slam.track_cfg._replace(monocular=monocular)
    g, f = slam.gmap, frames[1]
    scene = (g.params.xyz, g.get_scaling, g.get_rotation, g.get_opacity, g.get_color,
             g.alive & ~g.dygs)
    targets = (f.image, f.depth, f.grad_mask, f.motion_mask if use_motion_mask else None)
    loop = tracking._loop_for(scene, targets, slam._pose_tensor(slam.poses_est[0]),
                              torch.zeros(2, device=slam.device), slam.intr, cfg)
    bins = compute_bins(*loop.scene[:3], loop.scene[5], loop.st.T_cw, loop.proj, loop.scene[3],
                        config=cfg.raster, **slam.intr.raster_kw())
    loop.iterate(bins, replay=False)   # off the start: nonzero moments
    loop._capture()
    fields = loop._fields()
    loop.graphs[0].replay()
    assert _equal([fields], [loop.fields])
    loop.out.copy_(compositor.composite(fields.detach(), bins, loop.grid)[0])
    eager = [t.clone() for t in loop._loss_grads()]
    loop.graphs[1].replay()
    assert _equal(eager, loop.loss_grads)
    loop.dfields.normal_(0.0, 1e-3)
    state = tracking._State(*(t.clone() for t in loop.st))
    loop._step(loop._fields(), loop.loss_grads[0], loop.loss_grads[2], state)
    loop.graphs[2].replay()
    assert _equal(state, loop.st)


@pytest.mark.parametrize("monocular,use_motion_mask", [(False, True), (False, False),
                                                       (True, True)])
def test_graphed_call_matches_eager_calls(sample, fresh_graphs, monocular, use_motion_mask):
    slam, frames = sample
    cfg = slam.track_cfg._replace(monocular=monocular)
    eager = [_track(slam, frames[1], eager=True, cfg=cfg, use_motion_mask=use_motion_mask)
             for _ in range(EAGER_RUNS)]
    before = _counts()
    first = _track(slam, frames[1], cfg=cfg, use_motion_mask=use_motion_mask)   # captures
    again = _track(slam, frames[1], cfg=cfg, use_motion_mask=use_motion_mask)   # replays only
    assert _delta(before) == {"graph_captures": 1, "eager_iters": 2,
                              "graph_replays": first.n_iters + again.n_iters - 2}
    spread = max(_gap(a, b) for a, b in itertools.combinations(eager, 2))
    for res in (first, again):
        assert abs(res.n_iters - eager[0].n_iters) <= 1, (res.n_iters, eager[0].n_iters)
        gaps = [_gap(res, e) for e in eager]
        assert min(gaps) <= max(spread, FLOOR), (gaps, spread)


def test_one_capture_per_map_capacity(sample, fresh_graphs):
    slam, frames = sample
    before = _counts()
    _track(slam, frames[1])
    _track(slam, frames[0])
    assert _delta(before)["graph_captures"] == 1
    grown, _ = gm.resize_map(slam.gmap, gm.init_adam(slam.gmap.capacity, slam.device),
                             2 * slam.gmap.capacity)
    _track(slam, frames[1], gmap=grown)
    _track(slam, frames[1], gmap=grown)
    _track(slam, frames[1])   # the first capacity's graphs are still kept
    assert _delta(before)["graph_captures"] == 2


@pytest.mark.parametrize("captures", [True, False])
def test_sync_count_equals_the_sync_debug_warnings(sample, fresh_graphs, captures):
    slam, frames = sample
    if not captures:
        _track(slam, frames[1])
    torch.cuda.synchronize()
    before, iters = trace.counts()["sync"], _counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = _track(slam, frames[1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert _delta(iters)["graph_captures"] == int(captures)
    syncs = [w for w in caught if "synchronizing" in str(w.message)
             and "prototype" not in str(w.message)]
    after = trace.counts()["sync"]
    counted = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    assert counted["track.step"] == res.n_iters
    # each capture begins with a whole-device synchronisation, which the
    # tracer counts and the debug mode does not report
    assert counted.pop("track.capture", 0) == 3 * int(captures)
    assert sum(counted.values()) == len(syncs) > 0, (counted, [
        f"{w.filename.rsplit('/', 2)[-1]}:{w.lineno}" for w in syncs])


def test_every_compositor_call_reaches_the_wrappers(sample, fresh_graphs, monkeypatch):
    slam, frames = sample
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = compositor.composite_forward, compositor.composite_backward

    def whole(bins):
        assert bins.pair_gid.numel() == int(bins.tile_count.sum())

    def fwd_wrapper(fields, bins, grid):
        whole(bins)
        calls["fwd"] += 1
        return fwd(fields, bins, grid)

    def bwd_wrapper(fields, bins, grid, out, n_contrib, grad_out):
        whole(bins)
        calls["bwd"] += 1
        return bwd(fields, bins, grid, out, n_contrib, grad_out)

    monkeypatch.setattr(compositor, "composite_forward", fwd_wrapper)
    monkeypatch.setattr(compositor, "composite_backward", bwd_wrapper)
    for _ in range(2):   # the call that captures, then one that only replays
        calls.update(fwd=0, bwd=0)
        res = _track(slam, frames[1])
        assert res.n_iters > 1
        assert calls == {"fwd": res.n_iters + 1, "bwd": res.n_iters}
