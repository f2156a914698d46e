"""The measured window: whole keyframe cycles, opened and closed at frame
fetches.

The runner makes every `cycle`-th frame a keyframe (frames 5, 10, 15,
... with `kf_interval: 5`), maps it, and synchronises the device before
it fetches the next frame. The window opens when frame `open_at` (the
frame after a keyframe) is fetched and closes when frame `open_at + k *
cycle` is fetched, for the first k >= 1 at which `seconds` have passed
since the opening: it holds frames open_at .. open_at + k * cycle - 1,
that is k whole cycles, each ending with its keyframe's mapping. Where
the window's time runs out inside a cycle therefore does not move the
rate. If the sequence holds no further cycle, the window closes at the
last boundary it has (`short` is then set).
"""

from __future__ import annotations

import time
from typing import Callable


class WindowClosed(Exception):
    """Raised at the fetch that closes the window, to stop the run there."""


class WholeCycles:
    def __init__(self, seconds: float, n_frames: int, open_at: int = 6, cycle: int = 5,
                 clock: Callable[[], float] = time.perf_counter,
                 sync: Callable[[], None] = lambda: None):
        if open_at + cycle > n_frames - 1:
            raise ValueError(f"{n_frames} frames hold no whole cycle from frame {open_at}")
        self.seconds = seconds
        self.n_frames = n_frames
        self.open_at = open_at
        self.cycle = cycle
        self.clock = clock
        self.sync = sync
        self.t_open: float | None = None
        self.t_close: float | None = None
        self.frames = 0
        self.short = False
        self.on_open: list[Callable[[], None]] = []
        self.on_boundary: list[Callable[[int], None]] = []

    @property
    def is_open(self) -> bool:
        return self.t_open is not None and self.t_close is None

    def fetch(self, idx: int) -> None:
        """Called before frame `idx` is read. Opens the window at
        `open_at`; at a cycle boundary past it, closes the window (and
        raises `WindowClosed`) once `seconds` have passed."""
        if idx == self.open_at:
            self.sync()
            self.t_open = self.clock()
            for fn in self.on_open:
                fn()
            return
        if not self.is_open or (idx - self.open_at) % self.cycle:
            return
        self.sync()
        now = self.clock()
        last = idx + self.cycle > self.n_frames - 1
        if now - self.t_open >= self.seconds or last:
            self.t_close = now
            self.frames = idx - self.open_at
            self.short = now - self.t_open < self.seconds
            raise WindowClosed(idx)
        for fn in self.on_boundary:
            fn(idx)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    @property
    def fps(self) -> float:
        return self.frames / self.window_s
