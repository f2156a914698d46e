"""What the benchmark records around the calls into the program's layers,
from its own files: the runner's references to `track_frame`, `map_chunk`
and `map_chunk_dynamic`, the compositor's forward and backward
(`compositor.composite_forward` and `composite_backward`, which on the
card launch `kernels.composite_fwd` and `composite_bwd` once each), the
deformation MLP `deform.mlp_forward`, and the dataset's frame fetch (see
harness.WindowedDataset).

While the window is open the recorder keeps:
  * of the tracked frames, and of each kind of mapping call, the few that
    the correctness check judges (`kept`, see `Kept`): a copy of each
    one's inputs and of the outputs the check reads, with the outputs of
    its first compositor forward and backward (its first iteration's
    render and gradient), and of a 4D call what its first iteration did
    with the deformation field, read around `mlp_forward`
    (checks.FieldTap: the MLP's outputs, the field's gradient and the
    field after its first step). Every call's inputs are copied before it
    runs; a copy that is not kept is dropped when the call returns;
  * with `traced`, spans (name, host start and end in time.time_ns(),
    iterations), each made between two device synchronisations; the
    compositor calls' view counts; every `SAMPLE_EVERY`-th compositor
    call's inputs, for the roofline and `mfu` counts; the MLP's products.
Outside the window a wrapper only calls through.
"""

from __future__ import annotations

import inspect
import time
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

from benchmark.checks import FieldTap
from benchmark.roofline import mlp_ops

SAMPLE_EVERY = 8       # compositor calls between two kept for the work counts
SAMPLES_MAX = 400      # calls kept per kernel at most


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    work: int
    profiled: bool


def plain(x):
    """A detached copy of an argument tree: named tuples as
    ("nt", type name, {field: copy}), tuples and lists as lists, dicts as
    dicts, tensors cloned, numpy arrays copied."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return ("nt", type(x).__name__, {f: plain(getattr(x, f)) for f in x._fields})
    if isinstance(x, (tuple, list)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def compact_store(store, slots: np.ndarray):
    """The store's rows at `slots` (repeats allowed) as a store of their
    own, and a map from a slot of `store` to its row in it."""
    used = np.unique(np.asarray(slots, np.int64))
    local = np.zeros(max(int(store.valid.shape[0]), 1), np.int64)
    local[used] = np.arange(used.size)
    idx = torch.as_tensor(used, device=store.valid.device, dtype=torch.long)
    return type(store)(*(t[idx] for t in store)), local


class Kept:
    """The calls of one kind that the check judges, chosen as they come,
    from the seed: the call of most work (ties drawn; work is a number, or
    a tuple compared in order) and `draws` drawn uniformly from all the
    calls (a reservoir). At most 1 + `draws` copies are alive; `picks()`
    gives the call of most work first, then a drawn one that is not it."""

    def __init__(self, rng: np.random.Generator, draws: int):
        self.rng = rng
        self.draws = draws
        self.seen = 0
        self.longest = None
        self.work = None
        self.ties = 0
        self.drawn: list = []

    def offer(self, snap, work) -> None:
        self.seen += 1
        if self.longest is None or work > self.work:
            self.longest, self.work, self.ties = snap, work, 1
        elif work == self.work:
            self.ties += 1
            if self.rng.integers(self.ties) == 0:
                self.longest = snap
        if len(self.drawn) < self.draws:
            self.drawn.append(snap)
        elif self.draws and self.rng.integers(self.seen) < self.draws:
            self.drawn[int(self.rng.integers(self.draws))] = snap

    def picks(self) -> list:
        if self.longest is None:
            return []
        return [self.longest] + [s for s in self.drawn if s is not self.longest][:1]


class Recorder:
    def __init__(self, traced: bool, sync, seed: int = 0):
        self.traced = traced
        self.sync = sync
        self.in_window = False
        self.profiled = False
        self.spans: list[Span] = []
        rng = np.random.default_rng((seed, 1))
        # tracking: the longest frame and one drawn; mapping: the longest call
        # (4D: of those, the one with the most live dynamic Gaussians)
        self.kept = {"track": Kept(rng, 2), "map": Kept(rng, 0), "dyn": Kept(rng, 0)}
        self.calls = {"fwd": [], "bwd": []}        # per call: (views, profiled)
        self.samples = {"fwd": [], "bwd": []}      # (call index, kept inputs)
        self.mlp_ops = {False: 0.0, True: 0.0}     # by profiled
        self.first: dict | None = None             # the recorded call's first fwd/bwd outputs
        self.tap: FieldTap | None = None           # the recorded 4D call's field
        self._undo = []

    # -- spans --------------------------------------------------------
    @contextmanager
    def span(self, name: str, work=lambda out: 1):
        """A synchronised span around one call, kept while the window is
        open in a traced run; `work(result)` gives its iterations."""
        if not (self.traced and self.in_window):
            yield None
            return
        box = {}
        self.sync()
        t0 = time.time_ns()
        yield box
        self.sync()
        t1 = time.time_ns()
        self.spans.append(Span(name, t0, t1, int(work(box.get("out"))), self.profiled))

    # -- patching -----------------------------------------------------
    def _patch(self, module, name, wrapper):
        self._undo.append((module, name, getattr(module, name)))
        setattr(module, name, wrapper)

    def install(self) -> "Recorder":
        from fourdgs_torch.models import deform
        from fourdgs_torch.ops.rasterize import compositor
        from fourdgs_torch.slam import mapping_dynamic, runner

        track_frame = runner.track_frame
        track_sig = inspect.signature(track_frame)

        def track_wrapper(*args, **kw):
            if not self.in_window:
                return track_frame(*args, **kw)
            bound = track_sig.bind(*args, **kw)
            bound.apply_defaults()
            inp = plain(dict(bound.arguments))
            self.first = {}
            with self.span("track_frame", lambda r: r.n_iters) as box:
                res = track_frame(*args, **kw)
                if box is not None:
                    box["out"] = res
            first, self.first = self.first, None
            self.kept["track"].offer({
                "args": inp, "first": first,
                "out": {"T_cw": res.T_cw.detach().clone(),
                        "exposure": res.exposure.detach().clone(),
                        "n_iters": res.n_iters, "depth": res.depth.detach().clone(),
                        "opacity": res.opacity.detach().clone()},
            }, res.n_iters)
            return res

        def mapping_wrapper(fn, span: str, kind: str):
            """A mapping call (`map_chunk` or `map_chunk_dynamic`), recorded."""
            sig = inspect.signature(fn)

            def wrapper(*args, **kw):
                if not self.in_window:
                    return fn(*args, **kw)
                a = sig.bind(*args, **kw)
                a.apply_defaults()
                inp = self._mapping_inputs(a.arguments)
                self.first = {}
                self.tap = FieldTap(a.arguments["cn"]) if kind == "dyn" else None
                with self.span(span, lambda r: a.arguments["num_iters"]) as box:
                    res = fn(*args, **kw)
                    if box is not None:
                        box["out"] = res
                snap = self._mapping_outputs(inp, a.arguments, res)
                if kind == "dyn":
                    snap["out"]["deform"] = plain(res.deform)
                    self.first.update(self.tap.result(res.deform))
                snap["first"], self.first, self.tap = self.first, None, None
                work = a.arguments["num_iters"]
                if kind == "dyn":
                    # then the live dynamic Gaussians the field warps: a
                    # call with none gives the flow loss no path to the field
                    g = a.arguments["gmap"]
                    work = (work, int((g.dygs & g.alive).sum()))
                self.kept[kind].offer(snap, work)
                return res

            return wrapper

        comp_fwd, comp_bwd = compositor.composite_forward, compositor.composite_backward

        def fwd_wrapper(fields, bins, grid):
            res = comp_fwd(fields, bins, grid)
            if self.first is not None and "fwd" not in self.first:
                self.first["fwd"] = res[0].detach().clone()
            if self.traced and self.in_window and self._keep("fwd", fields.shape[0]):
                self.samples["fwd"].append((len(self.calls["fwd"]) - 1, plain(
                    (fields, bins.pair_gid, bins.tile_start, bins.tile_count, res[1], grid))))
            return res

        def bwd_wrapper(fields, bins, grid, out, n_contrib, grad_out):
            res = comp_bwd(fields, bins, grid, out, n_contrib, grad_out)
            if self.first is not None and "bwd" not in self.first:
                self.first["bwd"] = res.detach().clone()
            if self.traced and self.in_window and self._keep("bwd", fields.shape[0]):
                self.samples["bwd"].append((len(self.calls["bwd"]) - 1, plain(
                    (fields, bins.pair_gid, bins.tile_start, bins.tile_count, n_contrib, grid))))
            return res

        mlp_forward = deform.mlp_forward

        def mlp_wrapper(mlp, x, t):
            if self.traced and self.in_window:
                ws = list(mlp.weights) + [mlp.head_warp[0], mlp.head_scaling[0],
                                          mlp.head_rotation[0]]
                grad = torch.is_grad_enabled() and any(w.requires_grad for w in ws)
                self.mlp_ops[self.profiled] += mlp_ops(ws, x.numel() // x.shape[-1], grad)
            out = mlp_forward(mlp, x, t)
            if self.tap is not None:
                self.tap(mlp, x, t, out)
            return out

        self._patch(runner, "track_frame", track_wrapper)
        self._patch(runner, "map_chunk", mapping_wrapper(runner.map_chunk, "map_chunk", "map"))
        self._patch(mapping_dynamic, "map_chunk_dynamic", mapping_wrapper(
            mapping_dynamic.map_chunk_dynamic, "map_chunk_dynamic", "dyn"))
        self._patch(compositor, "composite_forward", fwd_wrapper)
        self._patch(compositor, "composite_backward", bwd_wrapper)
        self._patch(deform, "mlp_forward", mlp_wrapper)
        return self

    def uninstall(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo.clear()

    # -- helpers ------------------------------------------------------
    def _keep(self, kind: str, views: int) -> bool:
        """Counts a compositor call; True when its inputs are to be kept."""
        calls = self.calls[kind]
        calls.append((views, self.profiled))
        return (len(calls) - 1) % SAMPLE_EVERY == 0 and len(self.samples[kind]) < SAMPLES_MAX

    @staticmethod
    def _mapping_inputs(args: dict) -> dict:
        """A copy of a mapping call's arguments with the keyframe store
        cut to the rows the call reads (window, replay pool and flow
        pairs), and the slot arrays renumbered to match."""
        store = args["store"]
        pool = np.asarray(args["rand_pool"], np.int64)
        size = int(args["rand_pool_size"])
        used = [np.asarray(args["window_slots"], np.int64)[np.asarray(args["window_valid"], bool)],
                pool[:size]]
        if "flow_pair_slots" in args:
            pairs = np.asarray(args["flow_pair_slots"], np.int64)
            used.append(pairs[pairs >= 0])
        small, local = compact_store(store, np.concatenate(used + [np.zeros(1, np.int64)]))
        rest = {k: v for k, v in args.items() if k not in ("store", "mesh")}
        inp = plain(rest)
        inp["store"] = plain(small)
        inp["window_slots"] = local[np.asarray(args["window_slots"], np.int64)]
        pool_local = np.zeros_like(pool)
        pool_local[:size] = local[pool[:size]]
        inp["rand_pool"] = pool_local
        if "flow_pair_slots" in args:
            pairs = np.asarray(args["flow_pair_slots"], np.int64)
            inp["flow_pair_slots"] = np.where(pairs >= 0, local[np.maximum(pairs, 0)], -1)
        return inp

    @staticmethod
    def _mapping_outputs(inp: dict, args: dict, res) -> dict:
        slots = torch.as_tensor(np.asarray(args["window_slots"], np.int64),
                                device=res.store.T_cw.device)
        return {"args": inp, "out": {
            "gmap": plain(res.gmap), "final_loss": float(res.final_loss),
            "T_cw": res.store.T_cw[slots].detach().clone(),
            "exposure": res.store.exposure[slots].detach().clone()}}
