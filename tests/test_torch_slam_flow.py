"""The network flow route of the 4D path end to end: `SLAM(dynamic=True)`
of the port on a recorded (CoFusion-layout) 128x96 sequence with a RAFT
`.npz` of seeded weights in `pretrained/`, against the JAX runner.

The reference's route crashes: its runner calls `FlowCache.get(kf,
closest)` without images (fourdgs/slam/runner.py:469) and
`RaftFlowProvider.__call__` runs the network on them
(fourdgs/perception/raft.py:471-481), a TypeError at the first 4D
mapping phase with a flow pair. The port gives the provider the two
keyframes' colour images, as the original system's `generate_flow(image,
image_last)` does (departure 4, ROADMAP §3), taken from the keyframe
store's 8-bit copies, which are exact for 8-bit recordings (the Bonn
layout's undistorted frames too). Held here: that crash; every pair in
the port's flow cache equal to JAX `RaftFlowProvider._run` on the same
two frames within 1e-3 px, the masks on at least 99.9% of pixels; the
run's cameras and ATE within 5e-3 m and PSNR within 1.5 dB of the
reference's when the reference's
provider is handed the dataset's images for the two uids (inside this
test only); GMA under `flow_model: gma`, the loss off without weights,
and a corrupt weights file or an unknown flow model raising.

128x96 is the smallest size whose last correlation level is not empty in
the JAX RAFT (96 / 8 / 2^3 = 1.5 -> 1 row)."""

import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.perception import raft as jr
from fourdgs.perception.gma import make_gma_params
from fourdgs.perception.flow import FlowCache as JFlowCache
from fourdgs.perception.flow import compute_fwdbwd_mask as jmasks
from fourdgs.perception.weights_io import save_pytree_npz as jsave
from fourdgs.slam.runner import SLAM as JSLAM
from fourdgs.utils.config import ConfigDict as JConfigDict
from fourdgs_torch.data.cofusion import CoFusionDataset
from fourdgs_torch.data.synthetic import SyntheticDataset, write_cofusion_format
from fourdgs_torch.perception.gma import GmaFlowProvider
from fourdgs_torch.perception.raft import FLOW_HEAD_GAIN, RaftFlowProvider
from fourdgs_torch.slam import keyframes as kfs
from fourdgs_torch.slam.runner import SLAM
from fourdgs_torch.utils.config import ConfigDict
from tests.test_torch_slam import JaxDraws, one_torch_thread  # noqa: F401

W, H, N = 128, 96, 4
FX = 160.0


def _calibration(**extra):
    return {"fx": FX, "fy": FX, "cx": (W - 1) / 2, "cy": (H - 1) / 2, "width": W,
            "height": H, "depth_scale": 5000.0, "distorted": False, **extra}


def _config(seq_dir, **training):
    """Keyframes 0 and 2 (dystart: the deformation's warmup, then 4D
    mapping with the pair (2, 0)), then a tracked frame; the iteration
    counts of tests/test_torch_slam_dynamic.py's parity run."""
    tr = {
        "init_itr_num": 5, "init_gaussian_update": 3, "init_gaussian_reset": 2000,
        "init_gaussian_th": 0.005, "init_gaussian_extent": 30, "tracking_itr_num": 6,
        "mapping_itr_num": 4, "keyframe_mapping_iters": 4,
        "gaussian_update_every": 10000, "gaussian_update_offset": 50, "gaussian_th": 0.7,
        "gaussian_extent": 1.0, "gaussian_reset": 20001, "size_threshold": 20,
        "kf_interval": 2, "window_size": 3, "pose_window": 2, "edge_threshold": 1.1,
        "rgb_boundary_threshold": 0.01, "alpha": 0.9, "kf_translation": 0.08,
        "kf_min_translation": 0.05, "kf_overlap": 1.01, "kf_cutoff": 0.3,
        "single_thread": True, "monocular": False, "dystart": 2, "flow_loss": 3,
        "flow_loss_fine": 2, "lr": {"cam_rot_delta": 0.003, "cam_trans_delta": 0.001},
    }
    tr.update(training)
    return {
        "Results": {"save_results": False, "use_gui": False},
        "Dataset": {"type": "CoFusion", "sensor_type": "depth", "dataset_path": seq_dir,
                    "pcd_downsample": 16, "pcd_downsample_init": 8,
                    "adaptive_pointsize": True, "point_size": 0.05,
                    "Calibration": _calibration()},
        "Training": tr,
        "opt_params": {"densify_grad_threshold": 0.0002},
        "model_params": {"sh_degree": 0, "dynamic_model": True},
        "ModelHiddenParams": {"node_num": 16},
    }


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A working directory holding the sequence (`seq/`, CoFusion layout:
    the blob's exact masks in `mask_colour/`) and `pretrained/` with a RAFT
    `.npz` of seeded weights written by the JAX package."""
    root = tmp_path_factory.mktemp("flow_route")
    syn = ConfigDict.wrap({"Dataset": {
        "type": "synthetic", "sensor_type": "depth", "num_frames": N, "dynamic": True,
        "points_per_wall": 1500, "Calibration": {**_calibration(), "depth_scale": 1.0}}})
    write_cofusion_format(SyntheticDataset(None, "", syn, device="cpu"), str(root / "seq"))
    os.makedirs(root / "pretrained")
    params = jr.make_params(jax.random.key(0))
    params["update"]["flow_conv2"]["weight"] = params["update"]["flow_conv2"]["weight"] \
        * FLOW_HEAD_GAIN
    jsave(str(root / "pretrained" / "raft-things.npz"), params)
    return root


@pytest.fixture
def in_workdir(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    monkeypatch.setenv("HOME", str(workdir))   # no ~/.cache/fourdgs weights
    return workdir


class _WithImages:
    """The reference's provider handed the dataset's colour images of the
    two uids, which its runner does not pass."""

    def __init__(self, provider, dataset):
        self.provider, self.dataset = provider, dataset

    def __call__(self, uid1, uid2, img1=None, img2=None):
        return self.provider(uid1, uid2, self.dataset[uid1][0], self.dataset[uid2][0])


@pytest.fixture(scope="module")
def runs(workdir, one_torch_thread):  # noqa: F811
    """The port's run (the JAX runner's draws) and the reference's, its
    provider handed the images."""
    cwd, home = os.getcwd(), os.environ.get("HOME")
    os.chdir(workdir)
    os.environ["HOME"] = str(workdir)
    try:
        cfg = _config(str(workdir / "seq"))
        tslam = SLAM(ConfigDict.wrap(cfg), dynamic=True, capacity=4096, max_keyframes=8,
                     device="cpu", draws=JaxDraws(0))
        tslam.run()
        jslam = JSLAM(JConfigDict.wrap(cfg), dynamic=True, capacity=4096, max_keyframes=8,
                      raster=JRasterConfig(use_oracle=False, tile_cap=512, max_pairs=1 << 15))
        jslam.flow_cache = JFlowCache(_WithImages(jslam.flow_cache.provider, jslam.dataset))
        jslam.run()
    finally:
        os.chdir(cwd)
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home
    return tslam, jslam


def test_reference_route_raises_type_error(in_workdir):
    provider = jr.RaftFlowProvider(str(in_workdir / "pretrained" / "raft-things.npz"))
    with pytest.raises(TypeError, match="not subscriptable"):
        JFlowCache(provider).get(2, 0)
    # the JAX runner's own cache, built from pretrained/, as its
    # _flow_arrays calls it
    jslam = JSLAM(JConfigDict.wrap(_config("seq")), dynamic=True, capacity=4096,
                  max_keyframes=8)
    assert jslam.flow_weight == 3.0
    with pytest.raises(TypeError, match="not subscriptable"):
        jslam.flow_cache.get(2, 0)


def test_port_flows_equal_jax_raft_on_the_keyframe_images(runs, in_workdir):
    tslam, jslam = runs
    assert tslam.kf_indices == [0, 2] and tslam.deform_init
    assert isinstance(tslam.flow_cache.provider, RaftFlowProvider)
    assert tslam.flow_weight == 3.0
    assert sorted(tslam.flow_cache._cache) == [(2, 0)]
    jraft = jr.RaftFlowProvider(str(in_workdir / "pretrained" / "raft-things.npz"))
    scale = np.array([W, H], np.float32) / 2.0
    for (kf, closest), (fwd, bwd, fwd_mask, bwd_mask) in tslam.flow_cache._cache.items():
        img_kf, img_closest = jslam.dataset[kf][0], jslam.dataset[closest][0]
        want_fwd, want_bwd = jraft._run(img_closest, img_kf), jraft._run(img_kf, img_closest)
        assert np.median(np.abs(want_fwd)) > 0.5
        for got, want in ((fwd, want_fwd), (bwd, want_bwd)):
            np.testing.assert_allclose(got.transpose(1, 2, 0) * scale, want, atol=1e-3, rtol=0)
        for got, want in zip((fwd_mask, bwd_mask), jmasks(want_fwd, want_bwd)):
            assert (got == want).mean() >= 0.999


def test_port_run_near_the_reference(runs):
    tslam, jslam = runs
    assert tslam.kf_indices == jslam.kf_indices
    for i in range(N):
        c_t = -tslam.poses_est[i][:3, :3].T @ tslam.poses_est[i][:3, 3]
        c_j = -jslam.poses_est[i][:3, :3].T @ jslam.poses_est[i][:3, 3]
        # tests/test_torch_slam_dynamic.py's bound from dystart on
        assert np.linalg.norm(c_t - c_j) < 5e-3, (i, c_t, c_j)
    t_ate, j_ate = tslam.eval_ate()["rmse"], jslam.eval_ate()["rmse"]
    assert t_ate < 0.08 and abs(t_ate - j_ate) < 5e-3, (t_ate, j_ate)
    # the maps part more than the cameras: the deformation warmup's Adam
    # steps at eps 1e-15 move the Gaussians too, chaotic in the reference
    # itself (tests/test_torch_mapping_dynamic.py); on this run the port's
    # own PSNR moves by 0.4 dB between one and two torch threads
    t_psnr = tslam.eval_rendering(interval=2)["mean_psnr"]
    j_psnr = jslam.eval_rendering(interval=2)["mean_psnr"]
    assert abs(t_psnr - j_psnr) < 1.5, (t_psnr, j_psnr)


def test_keyframe_store_copy_is_exact_for_8_bit_frames(workdir):
    # every 8-bit value as the loaders make it, u8 / 255 in float32
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16).repeat(3, 0)
    frames = [np.clip(u8.astype(np.float32) / 255.0, 0.0, 1.0)]
    # and the frames of a distorted calibration, undistorted by OpenCV on
    # the 8-bit image, as the Bonn configs read theirs
    cfg = _config(str(workdir / "seq"))
    cfg["Dataset"]["Calibration"].update(distorted=True, k1=0.04, k2=-0.02, p1=0.001,
                                         p2=-0.001, k3=0.0)
    ds = CoFusionDataset(None, str(workdir / "seq"), ConfigDict.wrap(cfg))
    frames += [ds[i][0] for i in range(N)]
    for image in frames:
        h, w = image.shape[1:]
        store = kfs.empty_store(2, h, w, "cpu")
        frame = type("F", (), {"image": torch.tensor(image), "depth": torch.zeros(h, w),
                               "motion_mask": torch.ones(h, w, dtype=torch.bool),
                               "time": 0.0, "uid": 0})()
        kfs.store_keyframe(store, 1, frame, np.eye(4), np.zeros(2))
        assert torch.equal(kfs.fetch_images(store, [1])[0], torch.tensor(image))


def test_flow_model_choice_and_missing_or_corrupt_weights(in_workdir):
    seq = str(in_workdir / "seq")
    slam = lambda **tr: SLAM(ConfigDict.wrap(_config(seq, **tr)), dynamic=True,  # noqa: E731
                             capacity=4096, max_keyframes=8, device="cpu")
    # gma: its weights file, in the JAX package's layout
    os.makedirs("gma_only/pretrained")
    jsave("gma_only/pretrained/gma-things.npz", make_gma_params(jax.random.key(1)))
    os.chdir("gma_only")
    gma = slam(flow_model="gma")
    assert isinstance(gma.flow_cache.provider, GmaFlowProvider)
    assert gma.flow_weight == 3.0 and gma.flow_cache.provider.iters == 12
    # raft's weights absent here: the flow loss is off
    raft = slam()
    assert raft.flow_cache is None and raft.flow_weight == 0.0
    # a weights file that does not read raises, and so does a flow model
    # that does not exist
    with open("pretrained/raft-things.npz", "wb") as f:
        f.write(b"not an npz file")
    with pytest.raises(zipfile.BadZipFile):
        slam()
    with pytest.raises(ValueError, match="unknown flow model"):
        slam(flow_model="pwc")
