"""SLAM orchestrator, RGB-D (port of fourdgs/slam/runner.py).

One host loop alternates tracking and keyframe mapping, as the reference
does with `single_thread: True`:

  frame 0: pose <- GT, spawn Gaussians from RGB-D, `init_itr_num`
           mapping iterations with densify every `init_gaussian_update`
           and an opacity reset at `init_gaussian_reset`,
  else:    track -> keyframe test (translation/covisibility, checked
           every `kf_interval` frames) -> on a keyframe: spawn Gaussians,
           window update, mapping chunks with the densify/reset cadence,
           pose resync.

With `dynamic=True` (the 4D path) the frame `dystart` is always a
keyframe; keyframes before it map 20 static iterations. At the first
keyframe from `dystart` on, Gaussians spawn on its dynamic pixels
(`dygs`), control nodes are sampled from them and the deformation MLP is
warmed up on that keyframe; every later keyframe phase is one
`map_chunk_dynamic` with flow losses against the closest earlier
keyframe, followed by one densify check. Flow comes from the exact
synthetic provider on the synthetic sequence; on recorded sequences from
RAFT, or GMA with `Training.flow_model: gma`, run on the runner's device
on the colour images of the two keyframes (the keyframe store's 8-bit
copies, exact for 8-bit recordings), when a weights file is found
(perception/flow.py `network_weights`); without one the flow loss is off.

Recorded sequences (`tum`, which also reads the Bonn layout, and
`CoFusion`) with `model_params.dynamic_model` get a segmenter
(perception/segmentation.py `make_segmenter`): YOLOv9-seg on the
runner's device when its weights file is found, else the geometric motion
segmenter, fed the constant-velocity prediction from the tracked poses of
the two frames before the one it segments. Frames are read, and so
segmented, on the main thread in order: each mask is the same from run to
run.

After `run`, the command line (cli.py) evaluates the trajectory
(`eval_ate`) and the renders (`eval_rendering`), refines colour over
random keyframes (`color_refinement`) and writes the artifacts (`save`,
`save_checkpoint`) under `save_dir`.

With `Training.monocular` (a config, no flag) tracking and mapping take
the RGB-only losses, Gaussians spawn at a noisy 2 m depth drawn per
frame, and the map starts uninitialised: keyframes map `mapping_itr_num`
iterations until the window first fills, then 300 iterations of initial
bundle adjustment; a keyframe that pushes another out of the window
before then resets the map to that keyframe (`_reset`). Monocular
recordings (`Dataset.sensor_type: monocular`) carry no depth: their
frames carry depth zeros, so the window's covisibility selection finds
no picks and mapping renders window[:3] and the replay views. With
`Training.rm_initdy`, each static mapping phase masks out of the RGB-D
loss the pixels of each window view that the first keyframe's static
depth reprojects onto (keyframes.py `reproject_mask`), computed once per
phase on the runner's device.

With `Results.use_gui` and a `save_dir`, `run()` drives the live viewer
(gui/viewer.py, on `Results.gui_port` when set): after each frame's
tracking it renders on the viewer's interval (`save_interval`) and blocks
while the viewer is paused; the viewer closes at the end of `run()`. With
`Results.use_wandb`, the periodic ATE goes to wandb as {"ate", "frame"}
(without the package, a line is logged and the run goes on). A RealSense
dataset's own calibration sets the intrinsics.

`run()` makes the tracer's spans (utils/trace.py): a `frame` per frame,
holding `fetch`, `init` (frame 0) and the phases `track`, `kf_check` and
`keyframe`, whose seconds are `metrics["phase_s"]` (with `dyn_mapping`,
the 4D mapping call); a keyframe phase holds `spawn`, `window`, the
mapping calls' spans, `densify` and `resync`. Its reads of device values
and copies to the device are sync sites (`runner.*`).

The port runs on the CUDA device unless `device="cpu"` is passed; with no
device and no CUDA it raises. It has no fixed pair buffer, so the
reference's pair-budget ladder and re-runs on overflow are gone; an
overflow past `RasterConfig.max_pairs` is only logged. Every random draw
goes through `draws` (utils/draws.py), in the order the reference
consumes its keys.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from fourdgs_torch.data.base import load_dataset
from fourdgs_torch.data.prefetch import iter_frames
from fourdgs_torch.device import resolve_device
from fourdgs_torch.geometry.se3 import se3_exp
from fourdgs_torch.models import deform
from fourdgs_torch.models import gaussian_map as gm
from fourdgs_torch.ops.rasterize.api import RasterConfig
from fourdgs_torch.slam import keyframes as kfs
from fourdgs_torch.slam import mapping_dynamic as mdyn
from fourdgs_torch.slam.cadence import mapping_cadence
from fourdgs_torch.slam.camera import Frame, Intrinsics
from fourdgs_torch.slam.losses import median_depth
from fourdgs_torch.slam.mapping import (
    MappingConfig,
    init_pose_adam,
    map_chunk,
    render_keyframe,
    window_visibility,
)
from fourdgs_torch.slam.tracking import TrackingConfig, track_frame
from fourdgs_torch.utils.config import merge_hparams
from fourdgs_torch.utils.draws import TorchDraws
from fourdgs_torch.utils.logging import Log
from fourdgs_torch.utils.trace import span, sync


def _zero_phases() -> dict:
    """Seconds per phase of `SLAM.run`, with the tracking and dynamic
    mapping iteration counts."""
    return {"track": 0.0, "kf_check": 0.0, "keyframe": 0.0, "track_iters": 0,
            "dyn_mapping": 0.0, "dyn_iters": 0}


class SLAM:
    def __init__(
        self,
        config,
        save_dir: str | None = None,
        save_interval: int = 50,
        dynamic: bool = False,
        max_frames: int | None = None,
        capacity: int = 1 << 14,
        max_capacity: int = 1 << 18,
        max_keyframes: int = 512,
        device: str | torch.device | None = None,
        draws=None,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.save_dir = save_dir
        self.save_interval = save_interval
        self.dynamic = dynamic
        tr = config["Training"]
        self.monocular = bool(tr.get("monocular", False))
        self.rm_initdy = bool(tr.get("rm_initdy", False))
        self.kf_interval = int(tr.get("kf_interval", 5))
        self.window_size = int(tr.get("window_size", 8))
        self.pose_window = int(tr.get("pose_window", 3))
        self.kf_translation = float(tr.get("kf_translation", 0.08))
        self.kf_min_translation = float(tr.get("kf_min_translation", 0.05))
        self.kf_overlap = float(tr.get("kf_overlap", 0.9))
        self.kf_cutoff = float(tr.get("kf_cutoff", 0.3))
        self.alpha = float(tr.get("alpha", 0.95))
        self.mapping_itr_num = int(tr.get("mapping_itr_num", 50))
        self.init_itr_num = int(tr.get("init_itr_num", 1050))
        self.init_gaussian_update = int(tr.get("init_gaussian_update", 100))
        self.init_gaussian_reset = int(tr.get("init_gaussian_reset", 500))
        self.init_gaussian_th = float(tr.get("init_gaussian_th", 0.005))
        self.init_gaussian_extent = float(tr.get("init_gaussian_extent", 30))
        self.gaussian_update_every = int(tr.get("gaussian_update_every", 150))
        self.gaussian_update_offset = int(tr.get("gaussian_update_offset", 50))
        self.gaussian_th = float(tr.get("gaussian_th", 0.7))
        self.gaussian_extent = float(tr.get("gaussian_extent", 1.0))
        self.gaussian_reset = int(tr.get("gaussian_reset", 2001))
        self.size_threshold = float(tr.get("size_threshold", 20))
        self.tracking_itr_num = int(tr.get("tracking_itr_num", 100))
        self.kf_iters = int(tr.get("keyframe_mapping_iters", 200))
        self.edge_threshold = float(tr.get("edge_threshold", 1.1))
        self.dystart = int(tr.get("dystart", 0))
        op = config.get("opt_params", {})
        self.densify_grad_threshold = float(op.get("densify_grad_threshold", 2e-4))
        ds = config["Dataset"]

        self.dataset = load_dataset(None, ds.get("dataset_path", ""), config,
                                    device=self.device)
        # the dataset's calibration: the YAML's, or a live camera's own
        # (the reference builds its intrinsics from the YAML: ROADMAP §3)
        self.intr = Intrinsics.from_dataset(self.dataset)
        if ds.get("type") in ("tum", "CoFusion") and config.get(
                "model_params", {}).get("dynamic_model", True):
            from fourdgs_torch.perception.segmentation import make_segmenter

            seg = make_segmenter(config, self.intr, self.device)
            if getattr(seg, "pose_provider", False) is None:
                # the geometric segmenter: the constant-velocity prediction
                # from tracked poses, never the dataset's ground truth
                seg.pose_provider = self._predict_pose
            self.dataset.mask_fn = seg
        n_frames = len(self.dataset)
        self.n_frames = n_frames if max_frames is None else min(n_frames, max_frames)

        # 4D deformation state, made at the first keyframe from dystart on
        self.hp = merge_hparams(config)
        self.deform = None
        self.deform_adam = None
        self.deform_init = False
        self.time_interval = 1.0 / max(self.n_frames, 1)
        self.flow_weight = float(tr.get("flow_loss", 3))
        self.flow_weight_fine = float(tr.get("flow_loss_fine", tr.get("flow_loss", 3)))
        self.flow_cache = None
        if dynamic and ds.get("type") == "synthetic":
            from fourdgs_torch.perception.flow import FlowCache, SyntheticFlowProvider

            self.flow_cache = FlowCache(SyntheticFlowProvider(self.dataset))
        elif dynamic:
            from fourdgs_torch.perception.flow import FlowCache, network_weights
            from fourdgs_torch.perception.gma import GmaFlowProvider
            from fourdgs_torch.perception.raft import RaftFlowProvider

            flow_model = str(tr.get("flow_model", "raft")).lower()
            weights = network_weights(flow_model)
            if weights is None:
                Log(f"{flow_model.upper()} weights not found; flow loss disabled")
                self.flow_weight = 0.0
            else:
                provider = GmaFlowProvider if flow_model == "gma" else RaftFlowProvider
                self.flow_cache = FlowCache(provider(weights, device=self.device))
                Log(f"{flow_model.upper()} flow from {weights}")
        self.max_capacity = max_capacity
        # multi-device mapping: the mapping views sharded over a mesh of
        # Training.mesh_devices ranks (parallel/mesh.py), on as many cards,
        # or as many CPU processes with device="cpu"; too few cards raise
        # here, and the mesh is made at the first mapping call
        self.mesh_devices = int(tr.get("mesh_devices", 0))
        self.mesh = None
        self._held = False
        if self.mesh_devices > 1:
            from fourdgs_torch.parallel.mesh import placement

            placement(self.mesh_devices, self._mesh_placement())
        self.raster = RasterConfig()
        self.track_cfg = TrackingConfig(
            max_iters=self.tracking_itr_num,
            monocular=self.monocular,
            lr_rot=float(tr["lr"]["cam_rot_delta"]),
            lr_trans=float(tr["lr"]["cam_trans_delta"]),
            alpha=self.alpha,
            raster=self.raster,
        )
        pl_init = float(op.get("position_lr_init", 0.00016))
        pl_final = float(op.get("position_lr_final", 1.6e-6))
        self.map_cfg = MappingConfig(
            num_window_views=self.window_size,
            pose_window=self.pose_window,
            alpha=self.alpha,
            monocular=self.monocular,
            lr_rot=float(tr["lr"]["cam_rot_delta"]) * 0.5,
            lr_trans=float(tr["lr"]["cam_trans_delta"]) * 0.5,
            rm_dynamic=True,
            raster=self.raster,
            xyz_lr_ratio=pl_final / max(pl_init, 1e-30),
            xyz_lr_max_steps=int(op.get("position_lr_max_steps", 30000)),
        )

        self.gmap = gm.empty_map(capacity, self.device)
        self.adam = gm.init_adam(capacity, self.device)
        self.store = kfs.empty_store(max_keyframes, self.intr.height, self.intr.width,
                                     self.device)
        self.draws = TorchDraws(0, self.device) if draws is None else draws

        # host bookkeeping
        self.poses_est: dict[int, np.ndarray] = {}
        self.exposures: dict[int, np.ndarray] = {}
        self.kf_slot: dict[int, int] = {}
        self.occ_visibility: dict[int, np.ndarray] = {}
        self.window: list[int] = []
        self.kf_indices: list[int] = []
        # monotone count of keyframes ever stored: slot assignment keys
        # off it so store wraparound evicts deterministically
        self.kf_total = 0
        self.iteration_count = 0
        self.median_depth = 2.0
        self.max_pairs_seen = 0
        self.rng = np.random.default_rng(0)
        # RGB-D maps start initialised; a monocular map once its window
        # first fills (the initial bundle adjustment)
        self.initialized = not self.monocular
        self.metrics: dict = {}
        self._phase = _zero_phases()
        self.viewer = None
        self._wandb = None
        if config.get("Results", {}).get("use_wandb", False):
            try:
                import wandb

                wandb.init(project="fourdgs-slam", config=config.to_plain())
                self._wandb = wandb
            except Exception:
                Log("wandb unavailable; logging disabled")

    def _wandb_log(self, data: dict):
        if self._wandb is not None:
            try:
                self._wandb.log(data)
            except Exception:
                pass

    def _mesh_placement(self):
        """The mesh's devices: the CPU's processes with device="cpu", else
        the default (one card per rank)."""
        return [self.device] * self.mesh_devices if self.device.type == "cpu" else None

    def _mapping_mesh(self):
        """The mesh the mapping calls shard their views over (None: one
        device). Made from Training.mesh_devices at the first call, and
        again after a close."""
        if self.mesh_devices > 1 and (self.mesh is None or self.mesh.closed):
            from fourdgs_torch.parallel import make_mesh

            self.mesh = make_mesh(self.mesh_devices, self._mesh_placement())
            rank0 = self.device if self.device.type == "cpu" else torch.device(
                "cuda", self.device.index or 0)
            if self.mesh.devices[0] != rank0:
                self.mesh.close()
                raise ValueError(f"mesh rank 0 is on {self.mesh.devices[0]}, the runner on "
                                 f"{self.device}")
        return self.mesh

    def close(self):
        """Stop the mesh's workers and the live viewer's server, if open."""
        if self.mesh is not None:
            self.mesh.close()
        self._close_viewer()

    def _close_viewer(self):
        if self.viewer is not None:
            self.viewer.close()
            self.viewer = None

    def __enter__(self) -> "SLAM":
        """Inside a `with` block the mesh lives until the block ends;
        otherwise `run()` and `color_refinement()` each close it at their
        end."""
        self._held = True
        return self

    def __exit__(self, *exc):
        self._held = False
        self.close()

    def _end_call(self):
        if not self._held:
            self.close()

    def _note_pairs(self, num_pairs: int, overflow: bool):
        self.max_pairs_seen = max(self.max_pairs_seen, int(num_pairs))
        if overflow:
            Log(f"{num_pairs} pairs binned in one view, above max_pairs "
                f"{self.raster.max_pairs}", tag="Perf")

    def _grow_to(self, new_cap: int):
        self.gmap, self.adam = gm.resize_map(self.gmap, self.adam, new_cap)
        Log(f"Capacity bucket grown to {new_cap}")

    def _maybe_grow(self):
        """Double the capacity when the map is more than 70% full."""
        cap = self.gmap.capacity
        if self.gmap.num_alive > 0.7 * cap and cap < self.max_capacity:
            self._grow_to(min(self.max_capacity, cap * 2))

    # ------------------------------------------------------------------
    def _spawn_gaussians(self, frame: Frame, T_cw: torch.Tensor, exposure, init: bool,
                         dygs: bool = False) -> int:
        """Back-project the keyframe depth (invalid-RGB pixels zeroed, and
        the dynamic pixels, or with `dygs` all but them) into new
        Gaussians, flagged dynamic with `dygs`."""
        ds = self.config["Dataset"]
        downs = int(ds.get("pcd_downsample_init" if init else "pcd_downsample",
                           32 if init else 128))
        valid_rgb = torch.sum(frame.image, dim=0) > 0.01
        motion = ~frame.motion_mask if dygs else frame.motion_mask
        depth = frame.depth
        if self.monocular:
            # no depth to spawn from: 2 m + 0.3 N(0, 1), drawn per frame
            rng = np.random.default_rng(int(frame.uid) + 1234)
            noise = (2.0 + rng.standard_normal(tuple(valid_rgb.shape)) * 0.3).astype(np.float32)
            depth = torch.as_tensor(noise, device=self.device)
        depth = depth * valid_rgb * motion
        cands = gm.candidates_from_rgbd(
            self.draws.uniform(depth.numel()), frame.image, depth, T_cw,
            self.intr.fx, self.intr.fy, self.intr.cx, self.intr.cy,
            downsample=downs,
            point_size=float(ds.get("point_size", 0.01)),
            adaptive_pointsize=bool(ds.get("adaptive_pointsize", True)),
            exposure_a=float(exposure[0]), exposure_b=float(exposure[1]),
        )
        n_new = cands.valid.shape[0]
        while (self.gmap.num_alive + n_new > 0.9 * self.gmap.capacity
               and self.gmap.capacity < self.max_capacity):
            self._grow_to(min(self.max_capacity, self.gmap.capacity * 2))
        self.gmap, self.adam, n = gm.insert(self.gmap, self.adam, cands, kf_id=frame.uid,
                                            dygs=dygs)
        return n

    def _densify(self, min_opacity: float, extent: float, max_screen_size: float):
        with span("densify"):
            self.gmap, self.adam = gm.densify_and_prune(
                self.gmap, self.adam, self.draws.normal2(self.gmap.params.xyz.shape),
                self.densify_grad_threshold, min_opacity, extent, max_screen_size,
            )
            self._maybe_grow()

    def _map(self, slots, valid, opt_pose, pool, pool_size, pose_adam, chunk,
             step_after, extra_masks=None):
        res = map_chunk(
            self.gmap, self.adam, self.store, slots, valid, opt_pose, pool, pool_size,
            pose_adam, self.draws.replay_picks(chunk, pool_size), chunk, step_after,
            self.iteration_count, self.intr, self.map_cfg, extra_masks=extra_masks,
            mesh=self._mapping_mesh(),
        )
        self._note_pairs(res.num_pairs, res.overflow)
        self.gmap, self.adam, self.store = res.gmap, res.adam, res.store
        return res

    def _pose_tensor(self, T) -> torch.Tensor:
        with sync("runner.pose_h2d"):
            return torch.as_tensor(np.asarray(T), dtype=torch.float32, device=self.device)

    def _visibility_at(self, T_cw: torch.Tensor):
        """(n_touched > 0 as numpy, the render) at pose T_cw."""
        out = render_keyframe(self.gmap, T_cw, self.intr, self.map_cfg)
        with sync("runner.visibility"):
            return (out.n_touched > 0).cpu().numpy(), out

    def _initialize(self, frame: Frame):
        T_gt = np.asarray(frame.T_gt)
        self.poses_est[0] = T_gt
        self.exposures[0] = np.zeros(2)
        kfs.store_keyframe(self.store, 0, frame, T_gt, np.zeros(2))
        self.kf_slot[0] = 0
        self.kf_indices = [0]
        self.kf_total = 1
        self.window = [0]
        n = self._spawn_gaussians(frame, self._pose_tensor(T_gt), np.zeros(2), init=True)
        Log(f"Init: spawned {n} Gaussians", tag="4DGS-SLAM")

        vw = self.map_cfg.num_window_views
        slots = np.zeros(vw, np.int64)
        valid = np.arange(vw) == 0
        opt_pose = np.zeros(vw, bool)
        pool = np.zeros(1, np.int64)
        pose_adam = init_pose_adam(vw, self.device)
        done = 0
        res = None
        while done < self.init_itr_num:
            boundary = self.init_gaussian_update - (done % self.init_gaussian_update)
            to_reset = self.init_gaussian_reset - done
            chunk = int(min(self.init_itr_num - done, boundary,
                            to_reset if to_reset > 0 else 1 << 30))
            res = self._map(slots, valid, opt_pose, pool, 0, pose_adam, chunk, -1)
            pose_adam = res.pose_adam
            done += chunk
            self.iteration_count += chunk
            if done % self.init_gaussian_update == 0 and done < self.init_itr_num:
                self._densify(self.init_gaussian_th, self.init_gaussian_extent, 0.0)
            if done == self.init_gaussian_reset:
                self.gmap, self.adam = gm.reset_opacity(self.gmap, self.adam)

        vis, out = self._visibility_at(self.store.T_cw[0])
        self.occ_visibility[0] = vis
        med = median_depth(out.depth, out.alpha)[0]
        with sync("runner.median_depth"):
            self.median_depth = float(med)
        loss = float("nan") if res is None else res.final_loss
        Log(f"Initialized map: {self.gmap.num_alive} Gaussians, final loss {loss:.4f}",
            tag="4DGS-SLAM")

    def _assign_kf_slot(self, idx: int) -> int:
        """Slot for a new keyframe, with wraparound eviction of the old
        keyframe that held it from every id-keyed structure."""
        slot = self.kf_total % self.store.capacity
        self.kf_total += 1
        for old in [k for k, s in self.kf_slot.items() if s == slot]:
            del self.kf_slot[old]
            self.occ_visibility.pop(old, None)
            if old in self.kf_indices:
                self.kf_indices.remove(old)
            if old in self.window:
                self.window.remove(old)
        self.kf_slot[idx] = slot
        self.kf_indices.append(idx)
        return slot

    def _window_arrays(self):
        """The mapping view set: window[:3] + covisibility picks (key_opt),
        and the replay pool of the other keyframes."""
        vw = self.map_cfg.num_window_views
        key_opt = list(self.window[:3])
        if len(self.window) > 3:
            anchor = self.window[0]
            with sync("runner.window_depth"):
                depth = self.store.depths[self.kf_slot[anchor]].cpu().numpy()
            picks = kfs.keyframe_selection_overlap(
                depth,
                self.poses_est[anchor],
                self.intr,
                {k: self.poses_est[k] for k in self.kf_indices},
                before_uid=self.window[2],
                max_selected=self.window_size - self.pose_window,
                rng=self.rng,
            )
            key_opt += [int(p) for p in picks if int(p) not in key_opt]
        key_opt = key_opt[:vw]
        slots = np.zeros(vw, np.int64)
        valid = np.zeros(vw, bool)
        opt_pose = np.zeros(vw, bool)
        for i, kf in enumerate(key_opt):
            slots[i] = self.kf_slot[kf]
            valid[i] = True
            opt_pose[i] = i < self.pose_window
        pool = [self.kf_slot[k] for k in self.kf_indices if k not in key_opt]
        return slots, valid, opt_pose, np.asarray(pool or [0], np.int64), len(pool), key_opt

    def _reproject_masks(self, key_opt: list[int]) -> torch.Tensor:
        """(Vw, H, W) bool: per mapped window view, the pixels the first
        keyframe's static depth does not reproject onto (True elsewhere and
        on unused views). Computed once per mapping phase: the reference
        recomputes them per iteration, while window poses move by under
        1e-3 within a phase."""
        anchor = self.kf_slot[self.kf_indices[0]]
        vw = self.map_cfg.num_window_views
        masks = torch.ones((vw, self.intr.height, self.intr.width), dtype=torch.bool,
                           device=self.device)
        for i, kf in enumerate(key_opt[:vw]):
            masks[i] = kfs.reproject_mask(
                self.store.depths[anchor], self.store.motion[anchor], self.store.T_cw[anchor],
                self.store.T_cw[self.kf_slot[kf]],
                fx=self.intr.fx, fy=self.intr.fy, cx=self.intr.cx, cy=self.intr.cy,
            )
        return masks

    def _run_mapping(self, total_iters: int, step_after: int):
        """`total_iters` mapping iterations, in chunks broken at the
        densify/reset cadence boundaries; a full window marks the map
        initialised afterwards (the reference's prune pass, which prunes
        nothing on either path)."""
        with span("window"):
            slots, valid, opt_pose, pool, pool_size, key_opt = self._window_arrays()
        extra_masks = self._reproject_masks(key_opt) if self.rm_initdy else None
        pose_adam = init_pose_adam(self.map_cfg.num_window_views, self.device)
        done = 0
        for chunk, new_it, fire in mapping_cadence(
            total_iters, step_after, self.iteration_count,
            self.gaussian_update_every, self.gaussian_update_offset, self.gaussian_reset,
        ):
            res = self._map(slots, valid, opt_pose, pool, pool_size, pose_adam, chunk,
                            step_after - done, extra_masks)
            pose_adam = res.pose_adam
            done += chunk
            self.iteration_count = new_it
            if fire == "densify":
                self._densify(self.gaussian_th, self.gaussian_extent, self.size_threshold)
            elif fire == "reset":
                vis = window_visibility(self.gmap, self.store, slots, valid, self.intr,
                                        self.map_cfg)
                self.gmap, self.adam = gm.reset_opacity_nonvisible(
                    self.gmap, self.adam, torch.any(vis, dim=0)
                )

        with span("resync"):
            self._resync_window(key_opt, count_obs=True)
        if len(self.window) == self.window_size:
            self.initialized = True

    def _reset(self, idx: int, frame: Frame):
        """The monocular recovery: drop the map and the keyframes, and start
        again from keyframe idx at its tracked pose, uninitialised."""
        self.gmap = gm.empty_map(self.gmap.capacity, self.device)
        self.adam = gm.init_adam(self.gmap.capacity, self.device)
        self.store = kfs.empty_store(self.store.capacity, self.intr.height, self.intr.width,
                                     self.device)
        self.kf_slot.clear()
        self.occ_visibility.clear()
        self.iteration_count = 0
        self.initialized = False
        T = self.poses_est[idx]
        kfs.store_keyframe(self.store, 0, frame, T, np.zeros(2))
        self.kf_slot[idx] = 0
        self.kf_indices = [idx]
        self.kf_total = 1
        self.window = [idx]
        self._spawn_gaussians(frame, self._pose_tensor(T), np.zeros(2), init=True)
        self.occ_visibility[idx], _ = self._visibility_at(self.store.T_cw[0])

    def _resync_window(self, key_opt: list[int], count_obs: bool):
        """After a mapping phase: the window's occlusion-aware visibility
        (with `count_obs`, also each Gaussian's n_obs, as the static path
        keeps it), and the mapped keyframes' poses and exposures read back."""
        vw = self.map_cfg.num_window_views
        in_window = self.window[:vw]
        vw_slots = np.zeros(vw, np.int64)
        vw_valid = np.arange(vw) < len(in_window)
        vw_slots[:len(in_window)] = [self.kf_slot[kf] for kf in in_window]
        vis = window_visibility(self.gmap, self.store, vw_slots, vw_valid, self.intr,
                                self.map_cfg)
        if count_obs:
            self.gmap = self.gmap._replace(n_obs=vis.sum(dim=0).to(torch.int32))
        with sync("runner.resync_visibility"):
            vis = vis.cpu().numpy()
        for i, kf in enumerate(in_window):
            self.occ_visibility[kf] = vis[i]
        for kf in key_opt:
            slot = self.kf_slot[kf]
            with sync("runner.resync_pose", 2):
                self.poses_est[kf] = self.store.T_cw[slot].cpu().numpy()
                self.exposures[kf] = self.store.exposure[slot].cpu().numpy()

    # ------------------------------------------------------------------
    # the 4D path
    def _init_deform(self, idx: int, frame: Frame) -> bool:
        """Spawn dynamic Gaussians on the keyframe's dynamic pixels, sample
        control nodes from them and warm the deformation MLP up on the
        keyframe. False (and nothing made) when it has no dynamic pixel."""
        n_dy = self._spawn_gaussians(frame, self._pose_tensor(self.poses_est[idx]),
                                     self.exposures[idx], init=False, dygs=True)
        if n_dy == 0:
            Log("no dynamic object at dystart; deferring deform init")
            return False
        dy_mask = self.gmap.dygs & self.gmap.alive
        node_cap = int(self.hp.node_num)
        start = self.draws.fps_start(dy_mask)
        ws, heads = self.draws.mlp_init(deform.mlp_dims(), [d for _, d, _ in deform.HEADS])
        self.deform = deform.init_nodes(
            node_cap, self.gmap.params.xyz, dy_mask,
            min(node_cap, max(int(dy_mask.sum()), 8)), start, deform.init_mlp(ws, heads),
        )
        self.deform_adam = mdyn.init_deform_adam(self.deform)
        self.draws.warmup()
        self.gmap, self.adam, self.deform, self.deform_adam, loss = mdyn.warmup_network(
            self.gmap, self.adam, self.deform, self.deform_adam, self.store,
            self.kf_slot[idx], 100, self.intr, self.map_cfg,
        )
        self.deform_init = True
        self.metrics["dygs_spawned"] = n_dy
        Log(f"Deform initialized at frame {idx}: {n_dy} dynamic gaussians, "
            f"warmup loss {loss:.4f}", tag="Backend")
        return True

    def _flow_arrays(self, key_opt: list[int]):
        """Per window view: the slot of the closest earlier keyframe (-1:
        none) and the flows between the two, (Vw, 2, H, W) each, computed
        from the two keyframes' stored colour images."""
        vw = self.map_cfg.num_window_views
        h, w = self.intr.height, self.intr.width
        pair_slots = np.full(vw, -1, np.int64)
        fwd = np.zeros((vw, 2, h, w), np.float32)
        bwd = np.zeros((vw, 2, h, w), np.float32)
        if self.flow_cache is not None and self.flow_weight != 0.0:
            for i, kf in enumerate(key_opt[:vw]):
                earlier = [k for k in self.kf_indices if k < kf]
                if not earlier:
                    continue
                closest = max(earlier)
                images = kfs.fetch_images(self.store, [self.kf_slot[kf], self.kf_slot[closest]])
                fwd[i], bwd[i], _, _ = self.flow_cache.get(kf, closest, images[0], images[1])
                pair_slots[i] = self.kf_slot[closest]
        return (pair_slots, torch.as_tensor(fwd, device=self.device),
                torch.as_tensor(bwd, device=self.device))

    def _run_mapping_dynamic(self, total_iters: int, step_after: int):
        """One dynamic mapping chunk over the window, then one densify
        check, the window's visibility and the pose resync (n_obs is left
        as it was, as the reference leaves it)."""
        key_opt = self._map_dynamic(total_iters, step_after)
        if (self.iteration_count % self.gaussian_update_every) < total_iters:
            self._densify(self.gaussian_th, self.gaussian_extent, self.size_threshold)
        with span("resync"):
            self._resync_window(key_opt, count_obs=False)

    def _map_dynamic(self, total_iters: int, step_after: int) -> list[int]:
        """The `map_chunk_dynamic` of a keyframe phase over the window;
        returns the mapped keyframes (key_opt)."""
        with span("window"):
            slots, valid, opt_pose, pool, pool_size, key_opt = self._window_arrays()
        pair_slots, fwd, bwd = self._flow_arrays(key_opt)
        nv = self.map_cfg.num_views
        with span("dyn_mapping", clock=True) as phase:
            res = mdyn.map_chunk_dynamic(
                self.gmap, self.adam, self.store, self.deform, self.deform_adam,
                slots, valid, opt_pose, pair_slots, fwd, bwd, pool, pool_size,
                init_pose_adam(self.map_cfg.num_window_views, self.device),
                self.draws.dynamic_chunk(total_iters, pool_size, nv),
                total_iters, step_after, self.iteration_count, self.intr, self.map_cfg,
                flow_weight=self.flow_weight, flow_weight_fine=self.flow_weight_fine,
                time_interval=self.time_interval, mesh=self._mapping_mesh(),
            )
        self._phase["dyn_mapping"] += phase.seconds
        self._phase["dyn_iters"] += total_iters
        self._note_pairs(res.num_pairs, res.overflow)
        self.gmap, self.adam, self.store = res.gmap, res.adam, res.store
        self.deform, self.deform_adam = res.deform, res.deform_adam
        self.iteration_count += max(0, total_iters - max(step_after, 0))
        return key_opt

    def _handle_keyframe(self, idx: int, frame: Frame, curr_visibility: np.ndarray):
        slot = self._assign_kf_slot(idx)
        kfs.store_keyframe(self.store, slot, frame, self.poses_est[idx], self.exposures[idx])
        self.occ_visibility[idx] = curr_visibility
        self.window, removed = kfs.add_to_window(
            idx, curr_visibility, self.occ_visibility, self.window,
            self.poses_est, self.kf_cutoff, self.window_size, initialized=self.initialized,
        )
        if self.monocular and not self.initialized and removed is not None:
            Log("Keyframes lack sufficient overlap to initialize; resetting")
            self.metrics["resets"] = self.metrics.get("resets", 0) + 1
            self._reset(idx, frame)
            return
        with span("spawn"):
            self._spawn_gaussians(frame, self._pose_tensor(self.poses_est[idx]),
                                  self.exposures[idx], init=False)
        if self.dynamic and not self.deform_init and idx >= self.dystart:
            with span("deform_init"):
                self._init_deform(idx, frame)
        # map parameters step only after the first 100 of a long phase
        iters = self.kf_iters
        step_after = 100 if iters > 100 else -1
        if self.dynamic and not self.deform_init and idx < self.dystart:
            # before dystart, the 4D path maps a short static phase
            iters, step_after = 20, -1
        if not self.initialized:
            # monocular: short phases until the window first fills, then
            # the initial bundle adjustment
            full = len(self.window) == self.window_size
            iters, step_after = (300 if full else self.mapping_itr_num), -1
            if full:
                Log("Performing initial BA for initialization", tag="Backend")
                self.metrics["initial_ba_at"] = idx
        if self.dynamic and self.deform_init:
            self._run_mapping_dynamic(iters, step_after)
        else:
            self._run_mapping(iters, step_after)

    def _predict_pose(self) -> np.ndarray:
        """Constant-velocity w2c prediction for the next frame from the two
        latest tracked poses (the segmenter's pose source)."""
        if not self.poses_est:
            return np.eye(4, dtype=np.float32)
        ks = sorted(self.poses_est)
        T1 = self.poses_est[ks[-1]]
        if len(ks) == 1:
            return T1
        T0 = self.poses_est[ks[-2]]
        return (T1 @ np.linalg.inv(T0) @ T1).astype(np.float32)

    def run(self, warmup_frames: int = 0) -> dict:
        """Process the sequence; returns frames/s over the whole run (`fps`),
        the map size and the seconds spent per phase (`phase_s`). With
        `warmup_frames` N > 0 and more than N frames, also `fps_steady`:
        the frames from N on over the seconds from frame N's start. The
        device is synchronised there and the phase clocks start again, so
        `phase_s` holds the steady state's. `phase_s` is set also when the
        run stops early, on an exception (from the dataset, say). The mesh,
        if any, is closed at the end, unless the runner is used in a `with`
        block."""
        try:
            return self._run(warmup_frames)
        finally:
            self.metrics["phase_s"] = dict(self._phase)
            self._close_viewer()
            self._end_call()

    def _run(self, warmup_frames: int) -> dict:
        results = self.config.get("Results", {})
        if results.get("use_gui", False) and self.save_dir:
            from fourdgs_torch.gui.viewer import LiveViewer

            self.viewer = LiveViewer(self.save_dir, interval=self.save_interval,
                                     serve_port=results.get("gui_port"))
        t0 = time.time()
        t_warm = t0
        self._phase = _zero_phases()
        last_kf = 0
        frames = iter_frames(self.dataset, self.edge_threshold, self.n_frames,
                             device=self.device)
        for idx in range(self.n_frames):
            with span("frame", 1):
                _, frame = next(frames)
                if idx == warmup_frames:
                    self._sync()
                    t_warm = time.time()
                    self._phase = _zero_phases()   # steady-state attribution
                if idx == 0:
                    with span("init"):
                        self._initialize(frame)
                    last_kf = 0
                    continue

                self.initialized = self.initialized or len(self.window) == self.window_size
                with span("track", clock=True) as phase:
                    res = track_frame(
                        self.gmap, frame, self._pose_tensor(self.poses_est[idx - 1]),
                        self._pose_tensor(self.exposures.get(idx - 1, np.zeros(2))),
                        self.intr, self.track_cfg,
                    )
                    self._note_pairs(res.num_pairs, res.overflow)
                    with sync("runner.track_pose", 2):
                        self.poses_est[idx] = res.T_cw.cpu().numpy()
                        self.exposures[idx] = res.exposure.cpu().numpy()
                    with sync("runner.median_depth"):
                        self.median_depth = float(res.median_depth)
                self._phase["track"] += phase.seconds
                self._phase["track_iters"] += res.n_iters
                if self.viewer is not None:
                    self.viewer.maybe_update(self, idx)
                    self.viewer.wait_if_paused()   # blocks between frames while paused

                check_time = (idx - last_kf) >= self.kf_interval
                # the 4D path makes the dystart frame a keyframe
                force_dystart = self.dynamic and idx == self.dystart
                if not (check_time or force_dystart):
                    continue
                with span("kf_check", clock=True) as phase:
                    curr_visibility, _ = self._visibility_at(res.T_cw)
                    last_vis = self.occ_visibility[last_kf]
                    if len(self.window) < self.window_size:
                        union = np.count_nonzero(curr_visibility | last_vis)
                        inter = np.count_nonzero(curr_visibility & last_vis)
                        create_kf = (inter / union if union else 0.0) < self.kf_overlap
                    else:
                        create_kf = kfs.is_keyframe(
                            self.poses_est[idx], self.poses_est[last_kf], self.median_depth,
                            curr_visibility, last_vis, self.kf_translation,
                            self.kf_min_translation, self.kf_overlap,
                        )
                    create_kf = ((check_time and (create_kf or (idx - last_kf) >= 5))
                                 or force_dystart)
                self._phase["kf_check"] += phase.seconds

                if create_kf:
                    with span("keyframe", clock=True) as phase:
                        self._handle_keyframe(idx, frame, curr_visibility)
                        self._sync()
                    dt = phase.seconds
                    self._phase["keyframe"] += dt
                    last_kf = idx
                    Log(f"KF {idx}: {self.gmap.num_alive} gaussians, window {self.window} "
                        f"({dt:.1f}s)", tag="Backend")
                    if (results.get("save_trj", False) and self.save_dir
                            and self.kf_total % int(results.get("save_trj_kf_intv", 5)) == 0):
                        stats = self.eval_ate(label=f"frame_{idx}")
                        Log(f"ATE RMSE @ frame {idx}: {stats['rmse']:.4f} m", tag="Eval")
                        self._wandb_log({"ate": stats["rmse"], "frame": idx})

        self._sync()
        elapsed = time.time() - t0
        ph = self._phase
        steady_s = time.time() - t_warm
        Log("Steady-state phase times: track {track:.1f}s ({track_iters} iters), kf_check "
            "{kf_check:.1f}s, keyframe(mapping) {keyframe:.1f}s (4D mapping {dyn_mapping:.1f}s, "
            "{dyn_iters} iters), other {other:.1f}s".format(
                other=steady_s - ph["track"] - ph["kf_check"] - ph["keyframe"], **ph),
            tag="Perf")
        self.metrics["fps"] = self.n_frames / elapsed
        Log(f"Total FPS: {self.metrics['fps']:.3f} ({self.n_frames} frames / {elapsed:.1f}s)")
        if warmup_frames > 0 and self.n_frames > warmup_frames:
            self.metrics["fps_steady"] = (self.n_frames - warmup_frames) / steady_s
            Log(f"Steady-state FPS (after {warmup_frames} warmup frames): "
                f"{self.metrics['fps_steady']:.3f}")
        self.metrics["n_frames"] = self.n_frames
        self.metrics["n_gaussians"] = self.gmap.num_alive
        return self.metrics

    def _sync(self):
        if self.device.type == "cuda":
            with sync("runner.sync"):
                torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def color_refinement(self, iterations: int = 1500):
        """Global colour refinement: every iteration maps `num_views`
        distinct keyframes drawn uniformly from the whole history, the map
        parameters alone stepping, their learning rate scheduled from the
        refinement's own iteration count; on the mesh of
        Training.mesh_devices ranks when that asks for one (closed at the
        end, as `run()` closes it)."""
        try:
            self._color_refinement(iterations)
        finally:
            self._end_call()

    def _color_refinement(self, iterations: int):
        vw = self.map_cfg.num_window_views
        pool = [self.kf_slot[k] for k in self.kf_indices]
        # the pool padded to a power of two of at least 8: the draws are one
        # per entry, as the reference's
        pool_full = np.zeros(1 << max(3, int(np.ceil(np.log2(max(len(pool), 1))))), np.int64)
        pool_full[:len(pool)] = pool
        res = map_chunk(
            self.gmap, self.adam, self.store, np.zeros(vw, np.int64), np.zeros(vw, bool),
            np.zeros(vw, bool), pool_full, len(pool), init_pose_adam(vw, self.device),
            self.draws.refine_chunk(iterations, len(pool_full)), iterations, -1, 0,
            self.intr, self.map_cfg._replace(refine=True), mesh=self._mapping_mesh(),
        )
        self._note_pairs(res.num_pairs, res.overflow)
        self.gmap, self.adam, self.store = res.gmap, res.adam, res.store

    def eval_ate(self, label: str = "final") -> dict:
        """ATE of the tracked poses; with `save_dir`, also the trajectory
        artifacts of `label`."""
        from fourdgs_torch.eval.ate import evaluate_ate, save_trajectory

        ids = sorted(self.poses_est)
        est = [self.poses_est[i] for i in ids]
        gt = [np.asarray(self.dataset.poses[i]) for i in ids]
        if self.save_dir:
            return save_trajectory(est, gt, ids, self.save_dir, label)
        return evaluate_ate(est, gt)

    def _render_at(self, T: torch.Tensor, idx: int):
        """(colour, depth) of the map at pose T, the 4D map deformed to frame
        idx's time."""
        if self.dynamic and self.deform_init:
            # each frame at the time its keyframes carry
            t = torch.tensor(idx / max(len(self.dataset) - 1, 1), device=self.device)
            with torch.no_grad():
                out, _ = mdyn._deformed_render(self.gmap, self.deform, T, t,
                                               self.intr.proj(device=self.device),
                                               self.intr, self.map_cfg)
        else:
            out = render_keyframe(self.gmap, T, self.intr, self.map_cfg)
        return out.color, out.depth

    def eval_rendering(self, label: str = "final", interval: int | None = None,
                       dump_interval: int | None = None) -> dict:
        """Rendering metrics over the tracked frames (every `interval`-th);
        with `save_dir`, written under `psnr/<label>/`, with the renders, the
        ground truth and a novel view (the pose moved by a fixed offset)
        dumped every `dump_interval` frames (`save_interval` when None)."""
        from fourdgs_torch.eval.rendering import eval_rendering

        tau = torch.tensor([0.1, -0.05, 0.0, 0.0, 0.2, 0.0], device=self.device)

        def render_at(idx):
            return self._render_at(self._pose_tensor(self.poses_est[idx]), idx)

        def novel_at(idx):
            return self._render_at(se3_exp(tau) @ self._pose_tensor(self.poses_est[idx]), idx)

        return eval_rendering(render_at, self.dataset, sorted(self.poses_est),
                              save_dir=self.save_dir, label=label,
                              mask_dynamic=not self.dynamic, interval=interval or 1,
                              novel_render_fn=novel_at if self.save_dir else None,
                              dump_interval=dump_interval or self.save_interval)

    def save_checkpoint(self, path: str):
        """The whole state: map, Adam, keyframe store and host bookkeeping
        (io/checkpoint.py), and the deformation field beside it."""
        from fourdgs_torch.io.checkpoint import save_deform, save_state

        host = {
            "iteration_count": self.iteration_count,
            "kf_total": self.kf_total,
            "kf_indices": self.kf_indices,
            "window": self.window,
            "kf_slot": {str(k): v for k, v in self.kf_slot.items()},
            "poses_est": {str(k): np.asarray(v).tolist() for k, v in self.poses_est.items()},
            "exposures": {str(k): np.asarray(v).tolist() for k, v in self.exposures.items()},
            "initialized": self.initialized,
            "median_depth": self.median_depth,
            "deform_init": self.deform_init,
        }
        save_state(path, self.gmap, self.adam, self.store, host)
        if self.deform is not None:
            save_deform(path + ".deform.npz", self.deform, self.deform_adam)

    def _deform_template(self) -> deform.ControlNodes:
        """Zero control nodes and MLP at the configured node capacity, to
        load a saved field into."""
        cap, dev = int(self.hp.node_num), self.device
        ws = [torch.zeros(d, device=dev) for d in deform.mlp_dims()]
        heads = [torch.zeros((ws[-1].shape[1], d), device=dev) for _, d, _ in deform.HEADS]
        return deform.ControlNodes(
            nodes=torch.zeros((cap, 3), device=dev), radius_raw=torch.zeros(cap, device=dev),
            weight_raw=torch.zeros((cap, 1), device=dev),
            valid=torch.zeros(cap, dtype=torch.bool, device=dev),
            mlp=deform.init_mlp(ws, heads))

    def load_checkpoint(self, path: str):
        """Restore a `save_checkpoint` of this package or the reference's; the
        window's visibility is recomputed."""
        from fourdgs_torch.io.checkpoint import load_deform, load_state

        self.gmap, self.adam, self.store, host = load_state(path, self.gmap, self.adam,
                                                            self.store)
        self.iteration_count = host["iteration_count"]
        self.kf_indices = list(host["kf_indices"])
        self.kf_total = int(host.get("kf_total", len(self.kf_indices)))
        self.window = list(host["window"])
        self.kf_slot = {int(k): v for k, v in host["kf_slot"].items()}
        self.poses_est = {int(k): np.asarray(v) for k, v in host["poses_est"].items()}
        self.exposures = {int(k): np.asarray(v) for k, v in host["exposures"].items()}
        self.median_depth = host["median_depth"]
        self.initialized = bool(host.get("initialized", not self.monocular))
        if host.get("deform_init", False) and os.path.exists(path + ".deform.npz"):
            if self.deform is None:
                self.deform = self._deform_template()
                self.deform_adam = mdyn.init_deform_adam(self.deform)
            self.deform, adam = load_deform(path + ".deform.npz", self.deform,
                                            self.deform_adam)
            if adam is not None:
                self.deform_adam = adam
            self.deform_init = True
        for kf in self.window:
            self.occ_visibility[kf], _ = self._visibility_at(self.store.T_cw[self.kf_slot[kf]])

    def save(self, label: str = "final"):
        """With `save_dir`: `point_cloud/<label>/point_cloud.ply`, the field
        as `deform/<label>/deform.npz`, and the metrics as
        `final_result.json`."""
        if not self.save_dir:
            return
        from fourdgs_torch.io.checkpoint import save_deform
        from fourdgs_torch.io.ply import save_gaussians_ply

        pdir = os.path.join(self.save_dir, "point_cloud", label)
        os.makedirs(pdir, exist_ok=True)
        save_gaussians_ply(self.gmap, os.path.join(pdir, "point_cloud.ply"))
        if self.deform is not None:
            save_deform(os.path.join(self.save_dir, "deform", label, "deform.npz"), self.deform)
        with open(os.path.join(self.save_dir, "final_result.json"), "w") as f:
            json.dump(self.metrics, f, indent=2)
