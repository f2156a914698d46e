"""The correctness check: the reference follows the program's calls from
the program's own state, and judges what the calls returned.

The program optimises. From one state, the card's float32 rounding and
the order of its atomic sums make two runs part by a little at every
step, and Adam (eps 1e-15 on the map) grows that over a call's
iterations. So the reference cannot replay a whole run: it starts each
checked call from a copy of the inputs the program handed that call in
the window (hooks.Recorder) and runs the frozen plain path
(benchmark/reference/) on them. Two kinds of number come out:

  at the call's first iteration, before anything has grown:
    <call>_fwd     the first compositor forward's per-tile outputs
                   (colour, depth, transmittance of every pixel of every
                   view) against the reference's: largest gap over the
                   largest magnitude
    <call>_bwd     the first compositor backward's field gradients
                   against the reference's: largest gap of each field over
                   that field's largest magnitude, the worst field
    dyn_warp       (4D) the deformation MLP's outputs (d_xyz, d_rotation,
                   d_scaling) at every node and time the iteration
                   evaluates: largest gap over the largest magnitude, the
                   worst head
    dyn_field_bwd  (4D) the iteration's gradient of each tensor of the
                   field (the nodes' radii and weights, the MLP's weights
                   and biases, each head), where the flow loss, the ARAP
                   and elastic terms and the warp's backward all show: as
                   <call>_bwd reads, the worst tensor; a tensor whose
                   reference gradient is nought to rounding (norm under a
                   thousandth of the median tensor's: the nodes, which
                   every use detaches) is left out
    dyn_field_step (4D) the field after its first Adam step: the largest
                   gap in units of the learning rate, over the elements
                   whose reference gradient is at least a thousandth of
                   its tensor's largest
  at the call's end:
    track_pose     the tracked pose against the reference's tracking: the
                   larger of the translation gap (mm) and the rotation gap
                   (mrad)
    track_render   the depth and opacity the program rendered at its final
                   pose against the reference's render of the same map at
                   that pose: mean absolute gap of each, summed
    map_* / dyn_*  one keyframe mapping call (`map_chunk`, or in the 4D
                   cell `map_chunk_dynamic`): the last loss (relative gap),
                   the window poses (largest pose gap), the returned map
                   rendered at the first window view (mean absolute colour
                   gap, both maps rendered by the reference; in the 4D
                   cell deformed to that view's time), and `_change`: how
                   far the call moved each field of the map (a leaf), the
                   gap between the program's norm of a leaf's change and
                   the reference's over the reference's norm of that leaf
                   or of the median leaf, whichever is larger, the worst
                   leaf; a leaf whose gradient is nought to rounding in
                   the reference (its Adam first moment under a thousandth
                   of the median leaf's) moves by round-off alone and is
                   left out; in the 4D cell `dyn_field_change` is the
                   same over the deformation field's tensors (the
                   control nodes' radii and weights, the MLP's weights,
                   biases and heads), by the same rule
  over the sequence:
    ate            camera-centre RMSE of every tracked frame against the
                   ground truth (mm); the configuration states its limit
    poses, frames  (4D cell, where the port renders the sequence) its
                   poses against the frozen generator's, and frames 0-5
                   against the frozen generator and plain renderer

`<call>` is `track` for tracking, `map` for `map_chunk` and `dyn` for
`map_chunk_dynamic`. A cell compares the numbers its limits file names;
the others are worked out all the same (the result's `numbers`).

The deformation field is held at the 4D call's first iteration because
its end state cannot be: over a call of 50 iterations the field's Adam
(eps 1e-15) grows the card's rounding and the order of its atomic sums
into gaps that no limit tells from faults (on the card `dyn_field_change`
read up to 0.54 over 12 sound seeds, and 0.36 for the float32 reference
run again). So `dyn_loss`, `dyn_pose`, `dyn_render` and
`dyn_field_change` are not compared; `dyn_change`, the map's, is. The
program's side of the field numbers is read around its `mlp_forward`
inside the timed call itself (hooks.py, FieldTap), the reference's
around its own in a one-iteration run from the same copied inputs.
The readings that set each limit come from control.py: the control, the
reference in the program's place computed one precision lower (TF32
matmuls, the compositor's field table in bfloat16); two faults planted in
the reference in the program's place, every step returning its state
unchanged (`unchanged`) and half of the window's views left out of the
mapping call (`half`); three faults of the deformation field, read at the
4D call's first iteration (`FIELD_FAULTS`: the flow loss's contribution
to the gradients dropped, the field's step skipped, the warp head's
output scaled by 1.01); and the float32 reference run again (`again`),
the spread of the reference against itself.
"""

from __future__ import annotations

import math
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from benchmark.reference.models import deform as RD
from benchmark.reference.models import gaussian_map as RG
from benchmark.reference.ops.rasterize import api as RA
from benchmark.reference.ops.rasterize import compositor as RCOMP
from benchmark.reference.slam import camera as RC
from benchmark.reference.slam import keyframes as RK
from benchmark.reference.slam import mapping as RM
from benchmark.reference.slam import mapping_dynamic as RMD
from benchmark.reference.slam import tracking as RT

REF_TYPES = {cls.__name__: cls for cls in (
    RG.GaussianMap, RG.GaussianParams, RG.AdamState, RG.MapLRs, RC.Frame, RC.Intrinsics,
    RT.TrackingConfig, RA.RasterConfig, RM.MappingConfig, RM.PoseAdam, RK.KeyframeStore,
    RD.ControlNodes, RD.MLPParams, RD.ControlNodeFloats, RMD.DeformAdam)}
CONTROL = "control"


def rebuild(x):
    """A `hooks.plain` tree as the reference's own types."""
    if isinstance(x, tuple) and len(x) == 3 and x[0] == "nt":
        cls = REF_TYPES[x[1]]
        return cls(**{k: rebuild(v) for k, v in x[2].items()})
    if isinstance(x, list):
        return tuple(rebuild(v) for v in x)
    if isinstance(x, dict):
        return {k: rebuild(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.clone()
    return x


@contextmanager
def precision(tf32: bool):
    """Matmuls and convolutions in TF32 or in full float32."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


@contextmanager
def _patched(module=RCOMP, **fns):
    """Functions of a reference module (the compositor's
    `composite_forward` / `_backward` by default) replaced for a while."""
    old = {k: getattr(module, k) for k in fns}
    for k, f in fns.items():
        setattr(module, k, f)
    try:
        yield
    finally:
        for k, f in old.items():
            setattr(module, k, f)


@contextmanager
def _field_fault(name: str | None):
    """A fault of the deformation field planted in the reference:
    `noflow` the flow loss's contribution to the gradients dropped,
    `nostep` the field's Adam step skipped (its moments still move),
    `head` the warp head's output scaled by 1.01; otherwise nothing."""
    if name == "noflow":
        f = RMD.masked_flow_l1
        with _patched(RMD, masked_flow_l1=lambda *a, **k: f(*a, **k).detach()):
            yield
    elif name == "nostep":
        f = RMD._adam_flat
        with _patched(RMD, _adam_flat=lambda p, *a, **k: (p, *f(p, *a, **k)[1:])):
            yield
    elif name == "head":
        f = RD.mlp_forward

        def scaled(*a):
            d_xyz, d_rot, d_scale = f(*a)
            return d_xyz * 1.01, d_rot, d_scale

        with _patched(RD, mlp_forward=scaled):
            yield
    else:
        yield


@contextmanager
def variant(name: str | None):
    """The reference as run for `name`: None (float32, TF32 off); the
    control, "control": TF32 matmuls and each compositor call's field
    table rounded to bfloat16, the nearest precision below float32 of each
    kind of its arithmetic (matmuls; the compositor's elementwise work);
    or a fault, computed in float32 (the field's faults: `_field_fault`)."""
    if name != CONTROL:
        with precision(False), _field_fault(name):
            yield
        return
    f, b = RCOMP.composite_forward, RCOMP.composite_backward
    r = lambda t: t.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    with precision(True), _patched(
            composite_forward=lambda fields, bins, grid: f(r(fields), bins, grid),
            composite_backward=lambda fields, bins, grid, *a: b(r(fields), bins, grid, *a)):
        yield


@contextmanager
def first_calls():
    """Keeps the outputs of the first compositor forward and backward made
    inside the block."""
    box: dict = {}
    f, b = RCOMP.composite_forward, RCOMP.composite_backward

    def fwd(*a):
        res = f(*a)
        box.setdefault("fwd", res[0].detach().clone())
        return res

    def bwd(*a):
        res = b(*a)
        box.setdefault("bwd", res.detach().clone())
        return res

    with _patched(composite_forward=fwd, composite_backward=bwd):
        yield box


HEADS = ("head_warp", "head_scaling", "head_rotation")
# the columns of (d_xyz, d_rotation, d_scaling), as mlp_forward returns them
HEAD_COLS = (slice(0, 3), slice(3, 7), slice(7, 10))
FIELD_FAULTS = ("noflow", "nostep", "head")


def mlp_tensors(mlp) -> dict:
    """The MLP's tensors by name, in the order a field flattens them."""
    out = {f"weights.{i}": w for i, w in enumerate(mlp.weights)}
    out.update({f"biases.{i}": b for i, b in enumerate(mlp.biases)})
    for h in HEADS:
        out[f"{h}.W"], out[f"{h}.b"] = getattr(mlp, h)
    return out


def field_tensors(cn) -> dict:
    """A deformation field's floating-point tensors by name: the control
    nodes, their radii and weights, then the MLP's."""
    return {"nodes": cn.nodes, "radius_raw": cn.radius_raw, "weight_raw": cn.weight_raw,
            **mlp_tensors(cn.mlp)}


class FieldTap:
    """What a mapping call's first iteration does with the deformation
    field, read around `mlp_forward(mlp, x, t)` (call it after each
    evaluation with its output):

      warp  every evaluation's inputs and outputs, [(x, t) rows (R, 4),
            (d_xyz, d_rotation, d_scaling) rows (R, 10)], until the
            field's gradient is taken;
      grad  the field's gradient there, by tensor: a hook on the flat
            vector the MLP's tensors are views of, where they are views of
            one vector laid out as `field_tensors` orders the call's input
            field `cn` (the MLP's tensors and the nodes', radii and
            weights'), else a hook on each of the MLP's tensors;
      step  the field at the first evaluation after that gradient, the
            field after its first step (`result` takes the call's
            returned field where no evaluation followed)."""

    def __init__(self, cn):
        like = field_tensors(cn)
        self.shapes = {k: t.shape for k, t in like.items()}
        sizes = np.cumsum([0] + [t.numel() for t in like.values()])
        self.offsets = dict(zip(like, sizes[:-1].tolist()))
        self.total = int(sizes[-1])
        self.warp: list = []
        self.grad: dict | None = None
        self.step: dict | None = None
        self._hooked = False

    def _base(self, mlp):
        """The flat vector the MLP's tensors are views of at their places
        in the field's layout, or None."""
        ts = mlp_tensors(mlp)
        base = ts["weights.0"]._base
        if base is None or base.dim() != 1 or base.numel() != self.total:
            return None
        for k, t in ts.items():
            if (t._base is not base or t.shape != self.shapes[k]
                    or t.storage_offset() - base.storage_offset() != self.offsets[k]):
                return None
        return base

    def _split(self, flat) -> dict:
        return {k: flat[o:o + math.prod(self.shapes[k])].reshape(self.shapes[k]).clone()
                for k, o in self.offsets.items()}

    def _set_grad(self, name: str | None, g):
        self.grad = self.grad or {}
        self.grad.update(self._split(g) if name is None else {name: g.detach().clone()})

    def __call__(self, mlp, x, t, out) -> None:
        if self.grad is not None:
            if self.step is None:
                base = self._base(mlp)
                self.step = (self._split(base.detach()) if base is not None else
                             {k: v.detach().clone() for k, v in mlp_tensors(mlp).items()})
            return
        rows = torch.cat([x.detach().reshape(-1, x.shape[-1]),
                          t.detach().expand(x.shape[:-1] + (1,)).reshape(-1, 1)], dim=1)
        self.warp.append((rows, torch.cat([o.detach().reshape(rows.shape[0], -1) for o in out],
                                          dim=1)))
        ts = mlp_tensors(mlp)
        if self._hooked or not torch.is_grad_enabled() or not any(
                v.requires_grad for v in ts.values()):
            return
        self._hooked = True
        base = self._base(mlp)
        if base is not None:
            base.register_hook(lambda g: self._set_grad(None, g))
        else:
            for k, v in ts.items():
                if v.requires_grad:
                    v.register_hook(lambda g, k=k: self._set_grad(k, g))

    def result(self, final) -> dict:
        """warp, grad and step (from `final`, the call's returned field,
        where no evaluation followed the gradient)."""
        step = self.step if self.step is not None else {
            k: v.detach().clone() for k, v in field_tensors(final).items()}
        return {"warp": self.warp or None, "grad": self.grad, "step": step}


@contextmanager
def tapped(module, cn):
    """A FieldTap on `module.mlp_forward` for the block."""
    tap, f = FieldTap(cn), module.mlp_forward

    def wrapper(mlp, x, t):
        out = f(mlp, x, t)
        tap(mlp, x, t, out)
        return out

    with _patched(module, mlp_forward=wrapper):
        yield tap


def rel_gap(a, b) -> float:
    """Largest gap over the reference's largest magnitude (inf where a
    side is missing or the shapes differ)."""
    if a is None or b is None or a.shape != b.shape:
        return math.inf
    m = float(b.abs().max()) if b.numel() else 0.0
    d = float((a - b).abs().max()) if b.numel() else 0.0
    return d / m if m > 0 else d


def field_gap(a, b) -> float:
    """The worst field's largest gap over that field's largest magnitude,
    for (..., 10) field gradients."""
    if a is None or b is None or a.shape != b.shape:
        return math.inf
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return max(rel_gap(a[:, j], b[:, j]) for j in range(b.shape[-1]))


def pose_gap(Ta, Tb) -> float:
    """The larger of the translation gap in mm and the rotation gap in
    mrad between two world-to-camera poses."""
    Ta = np.asarray(torch.as_tensor(Ta).detach().cpu(), np.float64)
    Tb = np.asarray(torch.as_tensor(Tb).detach().cpu(), np.float64)
    D = Ta @ np.linalg.inv(Tb)
    cos = np.clip((np.trace(D[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    return float(max(np.linalg.norm(D[:3, 3]) * 1e3, np.arccos(cos) * 1e3))


def _render_static(gmap, T_cw, intr, raster):
    """The render tracking makes: the static Gaussians at pose T_cw."""
    with torch.no_grad():
        return RA.rasterize(
            gmap.params.xyz, gmap.get_scaling, gmap.get_rotation, gmap.get_opacity,
            gmap.get_color, gmap.alive & ~gmap.dygs, T_cw, intr.proj(device=T_cw.device),
            torch.zeros(3, device=T_cw.device), config=raster, **intr.raster_kw())


def _halve(valid) -> np.ndarray:
    valid = np.asarray(valid, bool).copy()
    ids = np.nonzero(valid)[0]
    valid[ids[(len(ids) + 1) // 2:]] = False
    return valid


def _call(kind: str, a: dict, iters: int | None = None, name: str | None = None):
    """The reference's run of the call `kind` on rebuilt arguments `a`,
    over `iters` iterations (all of the program's when None)."""
    if kind == "track":
        cfg = a["config"] if iters is None else a["config"]._replace(max_iters=iters)
        return RT.track_frame(a["gmap"], a["frame"], a["T_init"], a["exposure_init"],
                              a["intr"], cfg, a["use_motion_mask"])
    if name == "half":
        a["window_valid"] = _halve(a["window_valid"])
    if iters is not None:
        a["num_iters"] = iters
        if kind == "map":
            a["picks"] = a["picks"][:iters]
        else:
            a["draws"] = tuple(d[:iters] for d in a["draws"])
    return (RM.map_chunk if kind == "map" else RMD.map_chunk_dynamic)(**a)


def first_iteration(kind: str, snap, name: str | None = None) -> dict:
    """The reference's first iteration of the call from the snapshot: its
    first compositor forward and backward outputs, and its loss there; in
    a 4D call also the field's (FieldTap: warp, grad, step)."""
    a = rebuild(snap["args"])
    cn = a.get("cn")
    with variant(name), first_calls() as box, (
            tapped(RD, cn) if kind == "dyn" else nullcontext()) as tap:
        res = _call(kind, a, 1, name)
    out = {"fwd": box.get("fwd"), "bwd": box.get("bwd"), "loss": float(res.final_loss)}
    if kind == "dyn":
        out.update(tap.result(res.deform))
    return out


def warp_gap(a, b) -> float:
    """`dyn_warp`: the MLP's outputs at every (node, time) the first
    iteration evaluates (rows met twice counted once), against the
    reference's at the same inputs: per head the largest gap over the
    largest magnitude, the worst head; inf where the two evaluated at
    other inputs."""
    if not a or not b:
        return math.inf
    (xa, oa), (xb, ob) = _unique_rows(a), _unique_rows(b)
    if xa.shape != xb.shape or not torch.allclose(xa, xb, rtol=1e-6, atol=1e-6):
        return math.inf
    return max(rel_gap(oa[:, c], ob[:, c]) for c in HEAD_COLS)


def _unique_rows(warp):
    """The distinct input rows of a FieldTap's warp, sorted, each with the
    output of its first evaluation."""
    x = torch.cat([r for r, _ in warp])
    o = torch.cat([v for _, v in warp])
    _, inv = torch.unique(torch.round(x.double() * 2.0**20), dim=0, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), x.shape[0], dtype=torch.long, device=x.device)
    first.scatter_reduce_(0, inv, torch.arange(x.shape[0], device=x.device), "amin")
    return x[first], o[first]


def _kept_tensors(ref: dict) -> list[str]:
    """The field tensors whose reference gradient is above round-off: a
    norm of at least a thousandth of the median tensor's (the nodes, which
    every use detaches, read 0 and are left out)."""
    norms = {k: float(torch.linalg.norm(v)) for k, v in ref.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n > 0 and n >= 1e-3 * med]


def field_grad_gap(prog, ref) -> float:
    """`dyn_field_bwd`: the first iteration's gradient of each field tensor
    against the reference's, as `field_gap` reads, the worst tensor; the
    tensors that `_kept_tensors` leaves out, and the nodes' radii and
    weights where the program's side read only the MLP's, are not
    compared."""
    if not prog or not ref:
        return math.inf
    keep = _kept_tensors(ref)
    if not any(k in prog for k in keep):
        return math.inf
    return max(rel_gap(prog[k], ref[k]) for k in keep if k in prog)


def field_step_gap(prog, ref, ref_grad, lr: float) -> float:
    """`dyn_field_step`: the field after its first Adam step against the
    reference's, the largest gap in units of the learning rate, over the
    elements whose reference gradient is above round-off (at least a
    thousandth of its tensor's largest, in a tensor `_kept_tensors`
    keeps)."""
    if not prog or not ref or not ref_grad:
        return math.inf
    worst = 0.0
    for k in _kept_tensors(ref_grad):
        if k not in prog:
            continue
        if prog[k].shape != ref[k].shape:
            return math.inf
        g = ref_grad[k].abs()
        sel = g >= 1e-3 * g.max()
        worst = max(worst, float((prog[k] - ref[k]).abs()[sel].max()) / lr)
    return worst


def judge_first(kind: str, out: dict, ref: dict) -> dict:
    nums = {f"{kind}_fwd": rel_gap(out.get("fwd"), ref["fwd"]),
            f"{kind}_bwd": field_gap(out.get("bwd"), ref["bwd"])}
    if kind == "dyn":
        nums["dyn_warp"] = warp_gap(out.get("warp"), ref["warp"])
        nums["dyn_field_bwd"] = field_grad_gap(out.get("grad"), ref["grad"])
        nums["dyn_field_step"] = field_step_gap(out.get("step"), ref["step"], ref["grad"],
                                                RMD.DEFORM_LR)
    return nums


# -- tracking -----------------------------------------------------------
def follow_track(snap, name: str | None = None) -> dict:
    """The reference's whole tracking call from the snapshot's inputs: its
    pose, and its render at that pose."""
    a = rebuild(snap["args"])
    if name == "unchanged":
        T = a["T_init"]
        r = _render_static(a["gmap"], T, a["intr"], a["config"].raster)
        return {"T_cw": T, "depth": r.depth, "opacity": r.alpha}
    with variant(name):
        res = _call("track", a, None, name)
    return {"T_cw": res.T_cw, "depth": res.depth, "opacity": res.opacity}


def judge_track(snap, out: dict, ref: dict) -> dict:
    """End numbers of one tracked frame: `out` (the program's, or a
    control's) against the float32 reference's pose `ref`, and its render
    against the reference's render at `out`'s own pose."""
    a = rebuild(snap["args"])
    with precision(False):
        r = _render_static(a["gmap"], out["T_cw"], a["intr"], a["config"].raster)
    render = float(torch.mean(torch.abs(out["depth"] - r.depth))
                   + torch.mean(torch.abs(out["opacity"] - r.alpha)))
    return {"track_pose": pose_gap(out["T_cw"], ref["T_cw"]), "track_render": render}


# -- keyframe mapping ---------------------------------------------------
def follow_map(kind: str, snap, name: str | None = None, first: dict | None = None) -> dict:
    """The reference's whole mapping call from the snapshot's inputs: its
    map (and field), last loss and window poses. For "unchanged" the
    call's inputs, with the loss of its first iteration (`first`)."""
    a = rebuild(snap["args"])
    slots = torch.as_tensor(np.asarray(a["window_slots"]), device=a["store"].T_cw.device)
    if name == "unchanged":
        out = {"gmap": a["gmap"], "final_loss": first["loss"], "T_cw": a["store"].T_cw[slots]}
        if kind == "dyn":
            out["deform"] = a["cn"]
        return out
    with variant(name):
        res = _call(kind, a, None, name)
    out = {"gmap": res.gmap, "final_loss": float(res.final_loss), "adam": res.adam,
           "T_cw": res.store.T_cw[slots].clone(), "times": res.store.times[slots].clone()}
    if kind == "dyn":
        out["deform"], out["deform_adam"] = res.deform, res.deform_adam
    return out


def leaf_change_gap(base, prog, ref, mu) -> float:
    """The worst leaf (a tensor of the parameters) by the gap between the
    norm of the program's change of it and the reference's, over the
    reference's norm of that leaf's change or of the median leaf's,
    whichever is larger. `base` holds the leaves before the call, `prog`
    and `ref` after it, `mu` the reference's Adam first moments; a leaf
    whose gradient the reference leaves at round-off (first moment under
    1e-3 of the median leaf's) is left out."""
    g = np.array([float(torch.linalg.norm(m)) for m in mu])
    keep = g >= 1e-3 * np.median(g)
    dp = np.array([float(torch.linalg.norm(x - b)) for x, b in zip(prog, base)])[keep]
    dr = np.array([float(torch.linalg.norm(x - b)) for x, b in zip(ref, base)])[keep]
    scale = np.maximum(dr, np.median(dr))
    return float(np.max(np.abs(dp - dr) / np.where(scale > 0, scale, 1.0)))


def change_gap(a: dict, out: dict, ref: dict) -> float:
    """`leaf_change_gap` over the map's five fields."""
    return leaf_change_gap(a["gmap"].params, out["gmap"].params, ref["gmap"].params,
                           ref["adam"].mu)


def field_change_gap(a: dict, out: dict, ref: dict) -> float:
    """`leaf_change_gap` over the deformation field's tensors."""
    field = lambda cn: RD.leaves(RD.cn_floats(cn))  # noqa: E731
    return leaf_change_gap(field(a["cn"]), field(out["deform"]), field(ref["deform"]),
                           RD.leaves(ref["deform_adam"].mu))


def judge_map(kind: str, snap, out: dict, ref: dict) -> dict:
    """End numbers of one mapping call: `out` (the program's, rebuilt, or
    a control's) against the float32 reference's `ref`."""
    a = rebuild(snap["args"])
    intr, cfg = a["intr"], a["cfg"]
    valid = np.nonzero(np.asarray(a["window_valid"], bool))[0]
    poses = max(pose_gap(out["T_cw"][i], ref["T_cw"][i]) for i in valid)
    loss = abs(out["final_loss"] - ref["final_loss"]) / abs(ref["final_loss"])
    v = int(valid[0])
    T = ref["T_cw"][v]
    with precision(False), torch.no_grad():
        if kind == "map":
            ra = RM.render_keyframe(out["gmap"], T, intr, cfg)
            rb = RM.render_keyframe(ref["gmap"], T, intr, cfg)
        else:
            t = ref["times"][v]
            proj = intr.proj(device=T.device)
            ra, _ = RMD._deformed_render(out["gmap"], out["deform"], T, t, proj, intr, cfg)
            rb, _ = RMD._deformed_render(ref["gmap"], ref["deform"], T, t, proj, intr, cfg)
    render = float(torch.mean(torch.abs(ra.color - rb.color)))
    nums = {f"{kind}_loss": loss, f"{kind}_pose": poses, f"{kind}_render": render,
            f"{kind}_change": change_gap(a, out, ref)}
    if kind == "dyn":
        nums["dyn_field_change"] = field_change_gap(a, out, ref)
    return nums


def program_map_out(kind: str, snap) -> dict:
    """The program's outputs of a mapping snapshot, as reference types."""
    o = snap["out"]
    out = {"gmap": rebuild(o["gmap"]), "final_loss": o["final_loss"], "T_cw": o["T_cw"]}
    if kind == "dyn":
        out["deform"] = rebuild(o["deform"])
    return out


# -- the sequence ---------------------------------------------------------
def ate_mm(poses_est: dict, poses_gt) -> float:
    """Camera-centre RMSE (mm) of the tracked frames against ground truth;
    frame 0 starts at ground truth, so no alignment is made."""
    errs = []
    for i, T in poses_est.items():
        Te = np.asarray(T, np.float64)
        Tg = np.asarray(poses_gt[i], np.float64)
        ce = -Te[:3, :3].T @ Te[:3, 3]
        cg = -Tg[:3, :3].T @ Tg[:3, 3]
        errs.append(np.sum((ce - cg) ** 2))
    return float(np.sqrt(np.mean(errs)) * 1e3)
