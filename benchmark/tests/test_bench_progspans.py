"""The readers of the program's own spans (progspans.py and the six
metrics that read it): numbers from a whole run of the static cell cut to
the CPU (small.py) with the program's tracer turned on by hand, None with
no span recorded or without the tracer (an older program); and the exact
split of the device's idle time among the innermost program spans."""

import sys
import time

import pytest

from benchmark import devtrace, harness, progspans
from benchmark.tests.small import shrink

NEW = ("track_syncs_per_iter", "track_host_ms_per_iter", "map_syncs_per_iter",
       "map_host_ms_per_iter")
DYN = ("map4d_syncs_per_iter", "map4d_host_ms_per_iter")   # the 4D cell's
SEED = 2**31 + 777


@pytest.fixture
def tracer():
    from fourdgs_torch.utils import trace

    trace.clear()
    yield trace
    trace.clear()


def _readings(tr=None):
    return harness.Readings([], tr, {}, None, 0.0)


def test_readers_read_numbers_from_a_cpu_run(tracer):
    with tracer.enable():
        res = harness.run_cell("tum-fr3-static.walk", SEED, 0.0, True,
                               t_start=time.perf_counter(), device="cpu", overrides=shrink)
    got = {k: v["value"] for k, v in res["metrics"].items() if k in NEW}
    assert set(got) == set(NEW), res["metrics"]
    # at least two waits an iteration (the step's norm and the loss)
    assert got["track_syncs_per_iter"] > 2 and got["map_syncs_per_iter"] > 1
    sp = tracer.spans()
    for name, key in (("track_frame", "track_host_ms_per_iter"),
                      ("map_chunk", "map_host_ms_per_iter")):
        calls = [s for s in sp if s.name == name]
        whole = sum(s.t1_ns - s.t0_ns for s in calls) / 1e6 / sum(s.work for s in calls)
        assert 0 < got[key] <= whole


def test_readers_read_none_without_spans_or_tracer(tracer, monkeypatch):
    for name in NEW + DYN:
        assert harness.load_reader(name).read(_readings()) is None
    with tracer.enable(), tracer.span("track_frame", 4), tracer.span("map_chunk", 2):
        pass
    assert harness.load_reader("track_syncs_per_iter").read(_readings()) == 0
    assert harness.load_reader("map4d_syncs_per_iter").read(_readings()) is None
    with tracer.enable(), tracer.span("map_chunk_dynamic", 3):
        pass
    assert harness.load_reader("map4d_syncs_per_iter").read(_readings()) == 0
    assert harness.load_reader("map4d_host_ms_per_iter").read(_readings()) >= 0
    # a program without the tracer, as at the parent of the commit that added it
    import fourdgs_torch.utils

    monkeypatch.setitem(sys.modules, "fourdgs_torch.utils.trace", None)
    monkeypatch.delattr(fourdgs_torch.utils, "trace")
    for name in NEW + DYN:
        assert harness.load_reader(name).read(_readings()) is None


def test_idle_time_splits_exactly_among_innermost_spans(tracer):
    sp = [tracer.Span("frame", 0, 100, -1, 1, 0, 1),
          tracer.Span("track", 10, 60, 0, 0, 0, 0),
          tracer.Span("sync", 40, 50, 1, 1, 0, 1, "track.loss"),
          tracer.Span("keyframe", 70, 95, 0, 0, 1, 1)]
    # busy 20-45 and 80-90 of the stretch -10..110
    tr = devtrace.Trace(-10, 110, [devtrace.DeviceOp(20, 45, "k"),
                                   devtrace.DeviceOp(80, 90, "k")], [])
    got = dict(progspans.idle_by_span(tr, sp))
    assert got == pytest.approx({progspans.OUTSIDE: 20e-9, "frame": 25e-9, "track": 20e-9,
                                 "sync": 5e-9, "keyframe": 15e-9})
    assert sum(got.values()) == pytest.approx(120e-9 - devtrace.busy_s(tr))
    assert progspans.at(sp, 45) == "sync" and progspans.at(sp, 65) == "frame"
    assert progspans.self_ns(sp) == [25, 40, 10, 25]
    assert progspans.path(sp, 2) == "frame/track/sync"
    assert progspans.per_work(sp, "frame", tr, "syncs") == 1
    assert progspans.per_work(sp, "frame", None, "host_ms") == pytest.approx(90e-6)
    assert progspans.syncs_by_site(sp, range(4)) == [["track.loss", 1, 10e-9]]
