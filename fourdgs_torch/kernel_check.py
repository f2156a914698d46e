"""Holding the compositor kernels against their plain torch versions on the
card, and timing them: what `chip_smoke.py`, `compositor_ab.py` and
`tests/test_torch_kernels_cuda.py` share.

`hold` is the one pass criterion: the forward's outputs, `n_contrib` and
`n_touched` equal to the plain version's (the kernels repeat its
arithmetic operation for operation, and their cull skips only invalid
(pixel, pair) combinations); each field's gradient within `GRAD_RTOL` of
that field's largest magnitude, since the backward sums over pixels in
another order and with atomics. The kernels to hold come in as launch
functions, so another build of them (an earlier commit's sources) is held
the same way.

`sample_map` and `compositor_inputs` give the inputs: the benchmark
configuration's map after 100 initialisation iterations on frame 0 of the
synthetic sequence, rendered at its ground-truth poses; optionally with
the last views carrying the signed flow payload of 4D mapping in their
colour channels. `small_map` gives the 80x60 map of `batch_eval
--synthetic`, whose tiles at the image's lower edge are partial.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .ops.rasterize import compositor as C

GRAD_RTOL = 1e-5
WIDTH, HEIGHT = 640, 480
CAPACITY = 1 << 15


def bench_config(n_frames: int):
    """The configuration of `bench.py`: the static synthetic sequence at
    TUM fr3 intrinsics, with its iteration counts and window."""
    from .utils.config import ConfigDict

    return ConfigDict.wrap({
        "Dataset": {
            "type": "synthetic", "dataset_path": "", "num_frames": n_frames,
            "points_per_wall": 6000, "pcd_downsample": 128, "pcd_downsample_init": 32,
            "adaptive_pointsize": True, "point_size": 0.01,
            "Calibration": {"fx": 535.4, "fy": 539.2, "cx": 320.1, "cy": 247.6,
                            "width": WIDTH, "height": HEIGHT, "depth_scale": 1.0},
        },
        "Training": {
            "init_itr_num": 1050, "init_gaussian_update": 100, "init_gaussian_reset": 500,
            "init_gaussian_th": 0.005, "init_gaussian_extent": 30,
            "tracking_itr_num": 100, "mapping_itr_num": 50, "keyframe_mapping_iters": 200,
            "gaussian_update_every": 150, "gaussian_update_offset": 50,
            "gaussian_th": 0.7, "gaussian_extent": 1.0, "gaussian_reset": 2001,
            "size_threshold": 20, "kf_interval": 5, "window_size": 8, "pose_window": 3,
            "edge_threshold": 1.1, "rgb_boundary_threshold": 0.01, "alpha": 0.9,
            "kf_translation": 0.08, "kf_min_translation": 0.05, "kf_overlap": 0.9,
            "kf_cutoff": 0.3, "monocular": False,
            "lr": {"cam_rot_delta": 0.003, "cam_trans_delta": 0.001},
        },
        "opt_params": {"densify_grad_threshold": 0.0002},
    })


def bench_dynamic_config(n_frames: int):
    """The configuration of `bench.py --dynamic`: the benchmark's, with the
    moving blob, the deformation field from frame 8 on (512 control
    nodes) and flow weights 3 and 2."""
    cfg = bench_config(n_frames)
    cfg["Dataset"]["dynamic"] = True
    cfg["Training"].update(dystart=8, flow_loss=3, flow_loss_fine=2)
    cfg["ModelHiddenParams"] = {"node_num": 512}
    return cfg


def _initialised(cfg, **slam_kw):
    from .data.prefetch import iter_frames
    from .slam.runner import SLAM

    slam = SLAM(cfg, max_frames=10, **slam_kw)
    frames = dict(iter_frames(slam.dataset, slam.edge_threshold, 2, device=slam.device))
    slam._initialize(frames[0])
    return slam, frames


def sample_map():
    """A SLAM object whose map had 100 initialisation iterations on frame 0
    of the synthetic sequence, at the benchmark's widths, on the card;
    with frames 0 and 1."""
    cfg = bench_config(40)
    cfg["Training"]["init_itr_num"] = 100
    return _initialised(cfg, capacity=CAPACITY, max_capacity=CAPACITY, max_keyframes=64)


def small_map():
    """A SLAM object at `batch_eval --synthetic`'s 80x60 configuration,
    its map initialised on frame 0 as that run initialises it, on the
    card; with frames 0 and 1. Its last tile row is 12 pixels high (60 =
    3 x 16 + 12): the kernels' partial tiles."""
    from .batch_eval import synthetic_config

    return _initialised(synthetic_config())


def compositor_inputs(slam, n_views: int, n_flow: int = 0, seed: int = 0):
    """Field table, bins and grid of `n_views` views of the current map at
    the sequence's ground-truth poses: the compositor's inputs. The last
    `n_flow` views carry a flow view's payload in place of colour: signed
    values in [-0.1, 0.1) in the first two channels and a 0/1 dynamic
    flag (a quarter of the Gaussians) in the third."""
    from .ops.rasterize.api import screen_fields
    from .slam.mapping import _activated

    g = slam.gmap
    dev = slam.device
    n_poses = len(slam.dataset.poses)
    poses = torch.stack([slam._pose_tensor(slam.dataset.poses[i % n_poses])
                         for i in range(n_views)])
    xyz, scales, quats, opac, rgb = _activated(g.params)
    colors = rgb.expand((n_views,) + rgb.shape).clone()
    if n_flow:
        gen = torch.Generator(device=dev).manual_seed(seed)
        flow = torch.rand((n_flow, g.capacity, 2), generator=gen, device=dev) * 0.2 - 0.1
        dy = (torch.rand((g.capacity,), generator=gen, device=dev) < 0.25).to(torch.float32)
        colors[n_views - n_flow:] = torch.cat([flow, dy.expand(n_flow, -1)[..., None]], -1)
    with torch.no_grad():
        _, fields, bins, grid = screen_fields(
            xyz, scales, quats, opac, colors, g.alive, poses, slam.intr.proj(device=dev),
            config=slam.raster, **slam.intr.raster_kw())
    return fields.contiguous(), bins, grid


@dataclass
class Reference:
    """The plain versions' results on one input, with the output gradient
    (normal, from `seed`) that the backward is given."""
    out: torch.Tensor
    n_contrib: torch.Tensor
    n_touched: torch.Tensor
    grad_out: torch.Tensor
    dfields: torch.Tensor


def reference(fields, bins, grid, seed: int) -> Reference:
    out, n_contrib, n_touched = C.composite_forward_plain(fields, bins, grid)
    gen = torch.Generator(device=fields.device).manual_seed(seed)
    grad_out = torch.randn(out.shape, generator=gen, device=fields.device)
    dfields = C.composite_backward_plain(fields, bins, grid, out, n_contrib, grad_out)
    return Reference(out, n_contrib, n_touched, grad_out, dfields)


def hold(fwd, bwd, ref: Reference) -> dict:
    """Run `fwd() -> (out, n_contrib, n_touched)` and `bwd(out, n_contrib,
    grad_out) -> dfields` and compare them with `ref`. Returns the errors
    and `ok`: forward equal, every field's gradient error within GRAD_RTOL
    of that field's largest magnitude (exactly 0 where that is 0)."""
    out, n_contrib, n_touched = fwd()
    dfields = bwd(out, n_contrib, ref.grad_out)
    torch.cuda.synchronize()
    scale = ref.dfields.abs().amax(dim=(0, 1))
    grad_err = (dfields - ref.dfields).abs().amax(dim=(0, 1))
    err = {
        "color": float((out[:, :3] - ref.out[:, :3]).abs().max()),
        "depth": float((out[:, 3] - ref.out[:, 3]).abs().max()),
        "T_final": float((out[:, 4] - ref.out[:, 4]).abs().max()),
        "n_contrib": int((n_contrib != ref.n_contrib).sum()),
        "n_touched": int((n_touched != ref.n_touched).sum()),
        "grad_abs": float(grad_err.max()),
        "grad_rel": float((grad_err / scale.clamp(min=1e-30)).max()),
    }
    ok = (torch.equal(out, ref.out) and torch.equal(n_contrib, ref.n_contrib)
          and torch.equal(n_touched, ref.n_touched)
          and bool((grad_err <= GRAD_RTOL * scale).all()))
    return {"err": err, "ok": ok}


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of `fn` over `reps` back-to-back calls, by CUDA events,
    after one call to warm up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
