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
`map_chunk_dynamic`. A cell compares the numbers its limits file names.
The readings that set each limit come from control.py: the control, the
reference in the program's place computed one precision lower (TF32
matmuls, the compositor's field table in bfloat16); two faults planted in
the reference in the program's place, every step returning its state
unchanged (`unchanged`) and half of the window's views left out of the
mapping call (`half`); and the float32 reference run again (`again`),
the spread of the reference against itself.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

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
def _patched(**fns):
    """The reference compositor's `composite_forward` / `_backward`
    replaced for a while."""
    old = {k: getattr(RCOMP, k) for k in fns}
    for k, f in fns.items():
        setattr(RCOMP, k, f)
    try:
        yield
    finally:
        for k, f in old.items():
            setattr(RCOMP, k, f)


@contextmanager
def variant(name: str | None):
    """The reference as run for `name`: None (float32, TF32 off); the
    control, "control": TF32 matmuls and each compositor call's field
    table rounded to bfloat16, the nearest precision below float32 of each
    kind of its arithmetic (matmuls; the compositor's elementwise work);
    or a fault, computed in float32."""
    if name != CONTROL:
        with precision(False):
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
    first compositor forward and backward outputs, and its loss there."""
    with variant(name), first_calls() as box:
        res = _call(kind, rebuild(snap["args"]), 1, name)
    return {"fwd": box.get("fwd"), "bwd": box.get("bwd"), "loss": float(res.final_loss)}


def judge_first(kind: str, out: dict, ref: dict) -> dict:
    return {f"{kind}_fwd": rel_gap(out.get("fwd"), ref["fwd"]),
            f"{kind}_bwd": field_gap(out.get("bwd"), ref["bwd"])}


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
