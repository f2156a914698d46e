"""Camera tracking: pose-only optimization by differentiable rendering
(port of fourdgs/slam/tracking.py).

A Python loop of up to `max_iters` render + gradient + Adam steps on an
SE(3) delta (rot/trans) plus exposure a/b, retracted left-multiplicatively
each step with the Adam moments kept across steps, and the reference's
early exit (|tau| < converged_threshold after a step).

The loop keeps the reference's round structure: ceil(max_iters /
rebin_every) rounds, each binning the tiles once at its start and running
up to `rebin_every` iterations on those bins; a step larger than
`rebin_delta_threshold` ends the round early, so the next round re-bins.
A frame with fast motion can therefore take fewer than `max_iters` steps,
exactly as in the reference.

With `monocular` the loss is RGB only (`tracking_loss_rgb`); the median
depth of the result still comes from the final render.

The loop's state (pose, exposure, Adam moments and step count) stays on
the device. Each step writes [|tau|, loss] to a 2-element buffer, the
host's one read per iteration. An iteration is three bodies around the
two compositor calls, which always run eagerly with the round's exact
bins (`_Loop`): the pose -> preprocess -> field table chain, the image ->
exposure -> loss chain with its gradient, and the pose gradient with the
Adam step. On the CPU the bodies run eagerly. On CUDA tensors a call's
first iteration runs them eagerly too, and every later one replays them
as CUDA graphs, captured at the first replay for each key (device, map
capacity, intrinsics, config, whether a motion mask is used: the values
the graphs hold fixed) and replayed on every later frame.

Spans (utils/trace.py): `track_frame` (work: the iterations taken), with
a `bin` per round, a `track_iter` per iteration and the final
`track_render`. Sync sites: the learning rates' and bias corrections'
copy (`track.lr_h2d`, on the graphed path once per capture), each
round's `bin.overflow` and `bin.num_pairs`, each iteration's
`track.step`, a capture's `track.capture`, and the final render's
`track.render_overflow` and `track.render_pairs`. Counters (`counts()
["track"]`): `graph_captures`, `graph_replays` (iterations run from the
graphs) and `eager_iters`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fourdgs_torch.geometry.se3 import se3_exp
from fourdgs_torch.models.gaussian_map import GaussianMap
from fourdgs_torch.ops.rasterize.api import (
    RasterConfig,
    compute_bins,
    image_from_tiles,
    rasterize,
    view_fields,
    view_grid,
)
from fourdgs_torch.ops.rasterize.compositor import NOUT, NPIX, NUM_FIELDS, composite
from fourdgs_torch.slam.camera import Frame, Intrinsics
from fourdgs_torch.slam.losses import (
    apply_exposure,
    median_depth,
    tracking_loss_rgb,
    tracking_loss_rgbd,
)
from fourdgs_torch.utils import trace
from fourdgs_torch.utils.trace import span, sync


class TrackingConfig(NamedTuple):
    max_iters: int = 100
    monocular: bool = False
    lr_rot: float = 0.003
    lr_trans: float = 0.001
    lr_exposure: float = 0.01
    alpha: float = 0.9
    rgb_boundary_threshold: float = 0.01
    converged_threshold: float = 1e-4
    # tile binning is recomputed every `rebin_every` iterations: per-
    # iteration pose deltas move screen means far less than a tile
    rebin_every: int = 8
    # a step above this SE(3) norm ends the round, so the next one re-bins
    rebin_delta_threshold: float = 0.01
    raster: RasterConfig = RasterConfig()


class TrackResult(NamedTuple):
    T_cw: torch.Tensor          # (4, 4) refined pose
    exposure: torch.Tensor      # (2,) [a, b]
    n_iters: int
    final_loss: float
    median_depth: torch.Tensor
    visibility: torch.Tensor    # (C,) bool — n_touched > 0 at the final pose
    opacity: torch.Tensor       # (H, W) final rendered opacity
    depth: torch.Tensor         # (H, W) final rendered depth
    overflow: bool              # any render binned more than max_pairs pairs
    num_pairs: int              # max binned pairs seen this frame


COUNTS = trace.register("track", {"graph_captures": 0, "graph_replays": 0, "eager_iters": 0})

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class _State(NamedTuple):
    """The loop's state on the device, updated in place by `_adam_step`."""

    T_cw: torch.Tensor     # (4, 4)
    exp_ab: torch.Tensor   # (2,) exposure [a, b]
    mu: torch.Tensor       # (8,) Adam moments of delta
    nu: torch.Tensor       # (8,)
    k: torch.Tensor        # (1,) int64: the steps taken
    stat: torch.Tensor     # (2,) [|tau|, loss] of the last step


def _new_state(T_init: torch.Tensor, exposure_init: torch.Tensor) -> _State:
    dev = T_init.device
    return _State(T_init.clone(), exposure_init.clone(), torch.zeros(8, device=dev),
                  torch.zeros(8, device=dev), torch.zeros(1, dtype=torch.int64, device=dev),
                  torch.zeros(2, device=dev))


def _constants(config: TrackingConfig, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The learning rates (8,) and Adam's bias corrections (2, max_iters),
    [1 - b1^k, 1 - b2^k] for k = 1..max_iters, rounded to float32 as the
    scalars of a division are: one copy from the host."""
    m = config.max_iters
    host = ([config.lr_trans] * 3 + [config.lr_rot] * 3 + [config.lr_exposure] * 2
            + [1 - _B1 ** k for k in range(1, m + 1)] + [1 - _B2 ** k for k in range(1, m + 1)])
    with sync("track.lr_h2d"):
        flat = torch.tensor(host, device=dev)
    return flat[:8], flat[8:].view(2, m)


def _adam_step(g: torch.Tensor, loss: torch.Tensor, st: _State, lr: torch.Tensor,
               bc: torch.Tensor) -> None:
    """One Adam step on delta = [trans(3), rot(3), exposure_a, exposure_b]
    with gradient `g`, the pose retraction and the exposure update, in
    place on `st`; writes [|tau|, loss] to `st.stat`. Reads no host value,
    so a CUDA graph can hold it."""
    st.mu.mul_(_B1).add_((1 - _B1) * g)
    st.nu.mul_(_B2).add_((1 - _B2) * g * g)
    c = bc.index_select(1, st.k)   # (2, 1): this step's bias corrections
    step = lr * (st.mu / c[0]) / (torch.sqrt(st.nu / c[1]) + _EPS)
    tau = -step[:6]
    st.T_cw.copy_(se3_exp(tau) @ st.T_cw)
    st.exp_ab.sub_(step[6:8])
    st.k.add_(1)
    st.stat.copy_(torch.stack([torch.linalg.norm(tau), loss]))


def _loss(image, depth, alpha, targets, config: TrackingConfig) -> torch.Tensor:
    gt_image, gt_depth, grad_mask, motion = targets
    if config.monocular:
        return tracking_loss_rgb(image, alpha, gt_image, grad_mask, motion_mask=motion,
                                 rgb_boundary_threshold=config.rgb_boundary_threshold)
    return tracking_loss_rgbd(image, depth, alpha, gt_image, gt_depth, grad_mask,
                              motion_mask=motion, alpha=config.alpha,
                              rgb_boundary_threshold=config.rgb_boundary_threshold)


class _Loop:
    """The tracking loop's device side for one call or, cached by
    `_loop_for`, for every call of one key: the map's activated tensors and
    the frame, the loop's state, the buffers the compositor's output and
    gradient pass through, and the iteration in three bodies around the two
    compositor calls:

    1. `_fields`: tau = 0 -> se3_exp(tau) @ T_cw -> preprocess -> the field
       table (1, N+1, 10), keeping its autograd graph for 3.
    2. `_loss_grads`: the compositor's output -> image -> exposure -> loss,
       and the loss's gradient with respect to the output and the exposure.
    3. `_step`: d tau from d fields through 1's autograd graph, then
       `_adam_step`.

    `iterate` runs the bodies eagerly, or replays them as CUDA graphs
    (captured at the first replay). The compositor's forward and backward
    run eagerly between them either way, through `composite` and autograd,
    with the round's bins."""

    def __init__(self, scene, targets, T_init, exposure_init, intr: Intrinsics,
                 config: TrackingConfig):
        dev = T_init.device
        self.scene, self.targets, self.intr, self.config = scene, targets, intr, config
        self.proj = intr.proj(device=dev)
        self.bg = torch.zeros(3, device=dev)
        self.lr, self.bc = _constants(config, dev)
        self.st = _new_state(T_init, exposure_init)
        self.grid = view_grid(intr.width, intr.height)
        self.tau = torch.zeros(6, device=dev, requires_grad=True)
        self.out = torch.zeros((self.grid.tiles, NOUT, NPIX), device=dev)
        self.dfields = torch.zeros((1, scene[0].shape[0] + 1, NUM_FIELDS), device=dev)
        self.graphs = None   # the three bodies' CUDA graphs, once captured,
        self.fields = self.loss_grads = None   # and the outputs 1 and 2 write

    @torch.no_grad()
    def load(self, scene, targets, T_init, exposure_init) -> None:
        """Copies a call's map, frame and start into the buffers, and zeroes
        the Adam state."""
        for dst, src in zip(self.scene + self.targets, scene + targets):
            if dst is not None:
                dst.copy_(src)
        self.st.T_cw.copy_(T_init)
        self.st.exp_ab.copy_(exposure_init)
        for t in (self.st.mu, self.st.nu, self.st.k):
            t.zero_()

    def _fields(self) -> torch.Tensor:
        T = se3_exp(self.tau) @ self.st.T_cw
        return view_fields(*self.scene, T[None], self.proj, **self.intr.raster_kw(),
                           config=self.config.raster)[2]

    def _loss_grads(self):
        out = self.out.detach().requires_grad_()
        ab = self.st.exp_ab.detach().requires_grad_()
        color, depth, alpha, _ = image_from_tiles(out, self.grid, self.bg)
        loss = _loss(apply_exposure(color[0], ab[0], ab[1]), depth[0], alpha[0],
                     self.targets, self.config)
        d_out, d_ab = torch.autograd.grad(loss, (out, ab))
        return loss.detach(), d_out, d_ab

    def _step(self, fields, loss, d_ab, st: _State) -> None:
        (g_tau,) = torch.autograd.grad(fields, self.tau, self.dfields)
        with torch.no_grad():
            _adam_step(torch.cat([g_tau, d_ab]), loss, st, self.lr, self.bc)

    def _capture(self) -> None:
        """Runs the three bodies once on the capture stream (on a copy of the
        state, which they would change), then captures them into one pool,
        in the order they replay."""
        stream = _capture_stream(self.st.T_cw.device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            warm = _State(*(t.clone() for t in self.st))
            loss, _, d_ab = self._loss_grads()
            self._step(self._fields(), loss, d_ab, warm)
        torch.cuda.current_stream().wait_stream(stream)
        pool = torch.cuda.graph_pool_handle()
        graphs = tuple(torch.cuda.CUDAGraph() for _ in range(3))
        # each capture begins with a device synchronisation
        with sync("track.capture", len(graphs)):
            with torch.cuda.graph(graphs[0], pool=pool, stream=stream):
                fields = self._fields()
            with torch.cuda.graph(graphs[1], pool=pool, stream=stream):
                self.loss_grads = self._loss_grads()
            with torch.cuda.graph(graphs[2], pool=pool, stream=stream):
                self._step(fields, self.loss_grads[0], self.loss_grads[2], self.st)
        self.fields = fields.detach()
        self.graphs = graphs
        COUNTS["graph_captures"] += 1

    def iterate(self, bins, replay: bool) -> None:
        """One iteration on `bins`: the three bodies, eagerly or replayed
        from their graphs, with the compositor between them."""
        if replay and self.graphs is None:
            self._capture()
        if replay:
            self.graphs[0].replay()
            fields = self.fields
        else:
            fields = self._fields()
        f = fields.detach().requires_grad_()
        out, _ = composite(f, bins, self.grid)
        self.out.copy_(out.detach())
        if replay:
            self.graphs[1].replay()
            loss, d_out, d_ab = self.loss_grads
        else:
            loss, d_out, d_ab = self._loss_grads()
        (dfields,) = torch.autograd.grad(out, f, d_out)
        self.dfields.copy_(dfields)
        if replay:
            self.graphs[2].replay()
        else:
            self._step(fields, loss, d_ab, self.st)


_LOOPS: dict = {}    # key -> _Loop, the most recently used last
_KEEP = 2            # loops kept: a growing map's last two capacities
_STREAMS: dict = {}  # device -> the stream every capture on it uses


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """One capture stream per device: a captured backward runs on the
    stream its forward ran on, so all of a key's captures share one."""
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream(dev)
    return _STREAMS[dev]


def _loop_for(scene, targets, T_init, exposure_init, intr: Intrinsics,
              config: TrackingConfig) -> _Loop:
    """The cached loop of this input's key, loaded with the call's inputs;
    made on a miss, with buffers of its own. Keeps the `_KEEP` most
    recently used."""
    key = (T_init.device, scene[0].shape[0], intr, config, targets[3] is not None)
    loop = _LOOPS.pop(key, None)
    if loop is None:
        while len(_LOOPS) >= _KEEP:
            _LOOPS.pop(next(iter(_LOOPS)))
        own = lambda ts: tuple(None if t is None else t.detach().clone() for t in ts)  # noqa: E731
        loop = _Loop(own(scene), own(targets), T_init, exposure_init, intr, config)
    else:
        loop.load(scene, targets, T_init, exposure_init)
    _LOOPS[key] = loop
    return loop


def track_frame(
    gmap: GaussianMap,
    frame: Frame,
    T_init: torch.Tensor,
    exposure_init: torch.Tensor,
    intr: Intrinsics,
    config: TrackingConfig = TrackingConfig(),
    use_motion_mask: bool = True,
) -> TrackResult:
    """Optimize the frame pose against the static map."""
    with span("track_frame") as sp:
        res = _track(gmap, frame, T_init, exposure_init, intr, config, use_motion_mask)
        sp.work = res.n_iters
    return res


def _track(gmap, frame, T_init, exposure_init, intr, config, use_motion_mask,
           _eager: bool = False) -> TrackResult:
    """`track_frame`'s loop; `_eager` keeps a CUDA call off the graphs (for
    the tests that compare the two)."""
    dev = T_init.device
    with torch.no_grad():
        scene = (gmap.params.xyz, gmap.get_scaling, gmap.get_rotation, gmap.get_opacity,
                 gmap.get_color, gmap.alive & ~gmap.dygs)
    targets = (frame.image, frame.depth, frame.grad_mask,
               frame.motion_mask if use_motion_mask else None)
    graphed = dev.type == "cuda" and not _eager
    if graphed:
        loop = _loop_for(scene, targets, T_init, exposure_init, intr, config)
    else:
        loop = _Loop(scene, targets, T_init, exposure_init, intr, config)
    st = loop.st
    xyz, scales, quats, opac, _, static_alive = loop.scene
    kw = intr.raster_kw()

    count = 0
    converged = False
    loss_val = float("inf")
    ov_seen, pm_seen = False, 0
    rb = max(config.rebin_every, 1)
    n_rounds = -(-config.max_iters // rb)
    for _ in range(n_rounds):
        if count >= config.max_iters or converged:
            break
        bins = compute_bins(xyz, scales, quats, static_alive, st.T_cw, loop.proj, opac,
                            config=config.raster, **kw)
        if not ov_seen:
            with sync("bin.overflow"):
                ov_seen = bool(bins.overflow.any())
        with sync("bin.num_pairs"):
            pm_seen = max(pm_seen, int(bins.num_pairs.max()))
        for _ in range(rb):
            if count >= config.max_iters or converged:
                break
            with span("track_iter"):
                replay = graphed and count > 0   # a call's first iteration runs eagerly
                loop.iterate(bins, replay)
                COUNTS["graph_replays" if replay else "eager_iters"] += 1
                count += 1
                with sync("track.step"):
                    tau_norm, loss_val = st.stat.tolist()
            converged = tau_norm < config.converged_threshold
            if tau_norm > config.rebin_delta_threshold:
                break  # stale bins: the next round re-bins at the new pose

    with torch.no_grad(), span("track_render"):
        out = rasterize(*loop.scene, st.T_cw, loop.proj, loop.bg, config=config.raster, **kw)
        med, _, _ = median_depth(out.depth, out.alpha)
        overflow = ov_seen
        if not overflow:
            with sync("track.render_overflow"):
                overflow = bool(out.overflow)
        with sync("track.render_pairs"):
            num_pairs = max(pm_seen, int(out.num_pairs))
    return TrackResult(
        T_cw=st.T_cw.clone(),
        exposure=st.exp_ab.clone(),
        n_iters=count,
        final_loss=loss_val,
        median_depth=med,
        visibility=out.n_touched > 0,
        opacity=out.alpha,
        depth=out.depth,
        overflow=overflow,
        num_pairs=num_pairs,
    )
