"""The port's tracer: spans and host-sync counters inside the SLAM loops.

    with span("track_frame") as sp:       # a span (recorded while recording)
        ...
        sp.work = n_iters                 # its units of work, for per-unit rates
    with sync("median.nonzero"):          # an operation that waits for the device
        vals = depth[valid]

*Recording* is on while `enable()` holds, or while a `torch.profiler`
session records (PyTorch's own flag, `torch.autograd.profiler.
_is_profiler_enabled`): a profiled stretch gets the program's spans with
no call into this module. Off, a span site costs one check and returns a
shared object that does nothing.

*Spans* are kept in memory as `Span` records, at most `MAX_SPANS` (later
ones are dropped and counted, `dropped()`), read with `spans()` and
cleared with `clear()`. A span's `parent` is the index in `spans()` of the
recorded span around it (-1: none). Times are `time.time_ns()`, the clock
of `torch.profiler`'s timestamps, so a span and the device operations of
a profiler trace set against each other directly. Spans nest on the
thread that records them: the runner's one host thread.

*Sync sites* wrap each operation after which the host waits for the
device: a read of a device value on the host (a Python number of a
tensor, a copy to host memory, `nonzero` and boolean indexing, whose size
the host reads), a copy from host memory (`torch.tensor(..., device=)`,
`torch.as_tensor`, `.to(device)`, which PyTorch makes a synchronised
copy), or a whole-device synchronisation. `n` is
the number of such waits the operation makes on the card: `bincount`
reads its input's minimum and maximum, two. Sites are always counted, per
site and in total (`sync_count()`); while recording, a site is also a
child span named `sync` that carries the site, with `work` = `n`. On the
CPU the same sites count the same, so the counts of a loop do not depend
on the device.

*Counters* live in one registry, `counts()`: the sync sites' under "sync",
and the dicts registered with `register` (the compositor kernels'
`launches_by_views`).

The tracer never synchronises the device and reads no device value. Its
state is process-wide by design: its sites sit deep in the loops, where
no tracer object could be passed without changing every signature on the
way down.
"""

from __future__ import annotations

import json
import os
import time
from typing import NamedTuple

import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1 << 20

_clock = time.time_ns


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    parent: int           # index in spans() of the enclosing span, -1: none
    work: int             # units of work (iterations, views; a sync's waits)
    syncs_at_start: int   # sync_count() at the span's start and end
    syncs_at_end: int
    site: str = ""        # the sync site, for spans named "sync"


_enabled = False
_spans: list = []         # Span, or None while the span is open
_stack: list[int] = []    # indices of the open recorded spans
_generation = 0           # bumped by clear(): spans open across it are not kept
_dropped = 0
_syncs = 0
_sites: dict[str, int] = {}
_registry: dict[str, dict] = {"sync": _sites}


def recording() -> bool:
    """Whether span sites record now."""
    return _enabled or getattr(_autograd_profiler, "_is_profiler_enabled", False)


class enable:
    """Turns recording on (`enable()`) or off (`enable(False)`) for the
    process; as a context manager, until its block ends."""

    def __init__(self, on: bool = True):
        global _enabled
        self._before = _enabled
        _enabled = on

    def __enter__(self) -> "enable":
        return self

    def __exit__(self, *exc) -> bool:
        global _enabled
        _enabled = self._before
        return False


class _Off:
    """The span of a site while recording is off: does nothing."""

    __slots__ = ()
    seconds = 0.0

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setattr__(self, name, value) -> None:
        pass


_OFF = _Off()


class _Clock:
    """An unrecorded span that times itself (`seconds`)."""

    __slots__ = ("work", "seconds", "_t0")

    def __init__(self):
        self.work = 0
        self.seconds = 0.0

    def __enter__(self) -> "_Clock":
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = (_clock() - self._t0) / 1e9
        return False


class _Recorded:
    """A span being recorded: reserves its place in `spans()` at its start
    and fills it at its end."""

    __slots__ = ("name", "work", "site", "seconds", "_n", "_i", "_gen", "_t0", "_s0")

    def __init__(self, name: str, work: int, site: str = "", n: int = 0):
        self.name, self.work, self.site, self._n = name, work, site, n
        self.seconds = 0.0

    def __enter__(self) -> "_Recorded":
        global _dropped
        self._gen = _generation
        if len(_spans) < MAX_SPANS:
            self._i = len(_spans)
            _spans.append(None)
            _stack.append(self._i)
        else:
            self._i = -1
            _dropped += 1
        self._s0 = _syncs
        if self._n:
            _count(self.site, self._n)
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _clock()
        self.seconds = (t1 - self._t0) / 1e9
        if self._i >= 0 and self._gen == _generation:
            _stack.pop()
            _spans[self._i] = Span(self.name, self._t0, t1, _stack[-1] if _stack else -1,
                                   self.work, self._s0, _syncs, self.site)
        return False


def span(name: str, work: int = 0, *, clock: bool = False):
    """A span named `name` around a `with` block; `work` (or `.work`, set
    inside the block) is its units of work. With `clock`, the span times
    itself (`.seconds` after the block) whether recording or not."""
    if _enabled or getattr(_autograd_profiler, "_is_profiler_enabled", False):
        return _Recorded(name, work)
    return _Clock() if clock else _OFF


def _count(site: str, n: int) -> None:
    global _syncs
    _syncs += n
    _sites[site] = _sites.get(site, 0) + n


def sync(site: str, n: int = 1):
    """A sync site around a `with` block that makes `n` host waits for the
    device; counted always, a `sync` span while recording."""
    if _enabled or getattr(_autograd_profiler, "_is_profiler_enabled", False):
        return _Recorded("sync", n, site, n) if n else _OFF
    _count(site, n)
    return _OFF


def sync_count() -> int:
    """The syncs counted since the process started, over all sites."""
    return _syncs


def register(name: str, counter: dict) -> dict:
    """Registers a counter dict under `name` in `counts()`; returns it."""
    _registry[name] = counter
    return counter


def counts() -> dict[str, dict]:
    """A copy of every registered counter, by name; "sync" holds the
    syncs by site."""
    return {name: dict(c) for name, c in _registry.items()}


def spans() -> list[Span]:
    """The recorded spans that have ended, in the order they started (a
    span still open is left out, and a `parent` that is open reads -1)."""
    if not _stack:
        return list(_spans)
    index, out = {}, []
    for i, s in enumerate(_spans):
        if s is not None:
            index[i] = len(out)
            out.append(s)
    return [s._replace(parent=index.get(s.parent, -1)) for s in out]


def dropped() -> int:
    """Spans not recorded because `MAX_SPANS` were held."""
    return _dropped


def clear() -> None:
    """Forgets the recorded spans (the counters stay)."""
    global _generation, _dropped
    _spans.clear()
    _stack.clear()
    _generation += 1
    _dropped = 0


def write_chrome_trace(path: str) -> None:
    """Writes the recorded spans and the counters to `path` as Chrome
    trace-event JSON (what Perfetto and chrome://tracing open): one
    complete event per span, microseconds on the `time.time_ns()` clock,
    with its work, its syncs and its site as arguments; the counters at
    the last span's end."""
    pid = os.getpid()
    events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": "fourdgs_torch"}}]
    end = 0
    for s in spans():
        args = {"work": s.work, "syncs": s.syncs_at_end - s.syncs_at_start}
        if s.site:
            args["site"] = s.site
        events.append({"name": s.name if not s.site else f"sync {s.site}", "cat": s.name,
                       "ph": "X", "ts": s.t0_ns / 1e3, "dur": (s.t1_ns - s.t0_ns) / 1e3,
                       "pid": pid, "tid": 0, "args": args})
        end = max(end, s.t1_ns)
    for name, c in counts().items():
        if c:
            events.append({"name": name, "ph": "C", "ts": end / 1e3, "pid": pid, "tid": 0,
                           "args": {str(k): v for k, v in c.items()}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"dropped_spans": _dropped, "syncs": _syncs}}, f)
