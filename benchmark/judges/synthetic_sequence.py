"""The sequence the program renders itself, held against the frozen
generator: where the configuration's route is the port's synthetic
dataset (traffic.py), the program makes its own frames, so the check
holds them as it holds the program's other outputs.

  poses   the dataset's world-to-camera poses against the generator's
          orbit (traffic.synthetic_poses): the largest gap of an entry
  frames  its frames 0-5, which it rendered in set-up, against the frozen
          generator's scene rendered by the plain renderer at the same
          poses: the mean absolute colour gap plus the mean absolute
          depth gap, the worst frame

Under control.py, "control" reads `frames` with the plain renderer
computed one precision lower (checks.variant); the other variants have
no reading of their own here.
"""

from __future__ import annotations

import numpy as np

from benchmark import checks, traffic
from benchmark.harness import WARMUP_FRAMES
from benchmark.reference import generator as G


def collect(slam, ctx) -> None:
    """The runner's dataset's poses and frames 0-5 (no patch is needed:
    the dataset keeps them)."""
    if ctx.config["Dataset"]["type"] != "synthetic":
        return
    ds = slam.dataset
    ctx.poses = [np.asarray(T, np.float64) for T in ds.poses]
    ctx.frames = [ds[i][:2] for i in range(WARMUP_FRAMES)]


def _render(ctx, i: int, variant: str | None):
    """Frame i of the frozen generator's scene (the room from the seed,
    the blob from the seed + 1), by the plain renderer as `variant` runs
    it."""
    n = int(ctx.mix["frames"])
    if not hasattr(ctx, "scene"):
        ctx.scene = (G.make_room_scene(ctx.seed, int(ctx.mix["points_per_wall"])),
                     G.make_dynamic_blob(ctx.seed + 1) if ctx.mix["blob"] else None)
    room, blob = ctx.scene
    with checks.variant(variant):
        return G.render_frame(G.scene_at(room, blob, i / max(n - 1, 1)),
                              traffic.synthetic_poses(n)[i],
                              ctx.config["Dataset"]["Calibration"], ctx.device)


def _gap(a, b) -> float:
    return float(np.mean(np.abs(a[0] - b[0])) + np.mean(np.abs(a[1] - b[1])))


def judge(variant, ctx) -> dict:
    if not hasattr(ctx, "frames"):
        return {}
    if not hasattr(ctx, "ref_frames"):
        ctx.ref_frames = [_render(ctx, i, None) for i in range(len(ctx.frames))]
    if variant is None:
        expect = traffic.synthetic_poses(int(ctx.mix["frames"]))
        return {"poses": float(max(np.max(np.abs(a - b)) for a, b in zip(ctx.poses, expect))),
                "frames": max(_gap(f, r) for f, r in zip(ctx.frames, ctx.ref_frames))}
    if variant == checks.CONTROL:
        return {"frames": max(_gap(_render(ctx, i, variant), r)
                              for i, r in enumerate(ctx.ref_frames))}
    return {}
