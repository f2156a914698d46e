"""The whole-cycle window rule, on a fake clock."""

import pytest

from benchmark.window import WholeCycles, WindowClosed


def drive(seconds, frame_s, n_frames=300, keyframe_s=0.0):
    """Fetch frames in order; frame i takes frame_s, a keyframe (every
    5th) keyframe_s more. Returns the window."""
    now = [0.0]
    w = WholeCycles(seconds, n_frames, open_at=6, cycle=5, clock=lambda: now[0])
    try:
        for idx in range(n_frames):
            w.fetch(idx)
            now[0] += frame_s + (keyframe_s if idx % 5 == 0 and idx else 0.0)
    except WindowClosed:
        pass
    return w


def test_opens_at_frame_6_and_closes_at_a_cycle_boundary():
    w = drive(seconds=12.0, frame_s=1.0)
    assert w.frames % 5 == 0 and w.frames >= 12
    assert w.frames == 15          # frames 6-20: the first boundary past 12 s
    assert w.window_s == pytest.approx(15.0)


@pytest.mark.parametrize("seconds", [20.0, 20.5, 23.0, 24.9])
def test_where_the_time_runs_out_inside_a_cycle_does_not_move_fps(seconds):
    # each cycle: four 1 s frames and a keyframe of 1 s + 6 s of mapping
    w = drive(seconds, frame_s=1.0, keyframe_s=6.0)
    assert w.frames % 5 == 0
    assert w.fps == pytest.approx(5 / 11.0)


def test_a_rate_that_ends_mid_cycle_would_move():
    # the same run read at a frame count instead of at a boundary
    frames, t = 0, 0.0
    for idx in range(6, 40):
        t += 1.0 + (6.0 if idx % 5 == 0 else 0.0)
        frames += 1
        if t >= 13.0:
            break
    assert frames / t != pytest.approx(5 / 11.0)


def test_a_short_sequence_closes_at_its_last_boundary():
    w = drive(seconds=1e9, frame_s=1.0, n_frames=40)
    assert w.short and w.frames == 30       # frames 6-35; 36 + 5 > 39
    with pytest.raises(ValueError):
        WholeCycles(1.0, 11)


def test_callbacks_run_at_open_and_at_each_boundary():
    seen = []
    now = [0.0]
    w = WholeCycles(12.0, 100, clock=lambda: now[0])
    w.on_open.append(lambda: seen.append("open"))
    w.on_boundary.append(seen.append)
    with pytest.raises(WindowClosed):
        for idx in range(100):
            w.fetch(idx)
            now[0] += 1.0
    assert seen == ["open", 11, 16]
