"""The monocular path of the port against the JAX package: the RGB-only
losses and their gradients, one `track_frame` and one `map_chunk` with
`monocular`, the scale-aligned trajectory error, `SLAM.run` with
`Training.monocular` through its initial bundle adjustment, the recovery
`_reset`, a sequence recorded without depth, and the `initialized` flag
through a checkpoint.

The reference writes its RGB-only losses inline
(fourdgs/slam/tracking.py:132-143, fourdgs/slam/mapping.py:236-243); the
loss test holds the port's functions against those expressions, copied
here in jnp. The runs replay the reference's draws (`JaxDraws`), and the
JAX runner renders through its Pallas kernels in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.eval import ate as jate
from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.ops.rasterize import rasterize as j_rasterize
from fourdgs.slam import mapping as jm
from fourdgs.slam.camera import make_frame as j_make_frame
from fourdgs.slam.runner import SLAM as JSLAM
from fourdgs.slam.tracking import TrackingConfig as JTrackingConfig
from fourdgs.slam.tracking import track_frame as j_track_frame
from fourdgs.utils.config import ConfigDict as JConfigDict
from fourdgs_torch import convert
from fourdgs_torch.data.prefetch import iter_frames
from fourdgs_torch.data.synthetic import SyntheticDataset, write_tum_format
from fourdgs_torch.eval import ate as tate
from fourdgs_torch.slam import losses as tls
from fourdgs_torch.slam import mapping as tm
from fourdgs_torch.slam.camera import make_frame
from fourdgs_torch.slam.runner import SLAM
from fourdgs_torch.slam.tracking import TrackingConfig, track_frame
from fourdgs_torch.utils.config import ConfigDict
from tests.test_torch_losses_image import TOL, _inputs
from tests.test_torch_mapping import J_RASTER as J_MAP_RASTER
from tests.test_torch_mapping import _jax_picks, _state
from tests.test_torch_slam import JaxDraws, _config, one_torch_thread  # noqa: F401
from tests.test_torch_tracking import H, J_INTR, J_RASTER, T_INTR, W, _jax_map

THR = 0.01   # rgb_boundary_threshold


def _run_config(num_frames=6, **training):
    """64x48, window 3, keyframes every second frame (kf_overlap above 1:
    every check makes one), so the window fills at keyframe 4 and the
    300-iteration initial bundle adjustment runs there. The iteration
    counts are those of tests/test_torch_slam.py's parity run, and no
    densify fires (gaussian_update_offset above gaussian_update_every
    never does; init_gaussian_update above init_itr_num): clone, split
    and prune decide at thresholds where rounding noise, which Adam
    amplifies on freshly spawned isotropic Gaussians, flips a Gaussian."""
    return _config(num_frames, 64, 48, 60.0, init_itr_num=5, init_gaussian_update=1000,
                   tracking_itr_num=6, keyframe_mapping_iters=4, mapping_itr_num=4,
                   gaussian_update_offset=20000, kf_interval=2, kf_overlap=1.01,
                   window_size=3, **training)


def _centre(T):
    T = np.asarray(T, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _j_tracking_rgb(image_ab, opacity, gt, grad_mask, motion):
    """fourdgs/slam/tracking.py:134-143."""
    rgb_mask = (jnp.sum(gt, axis=0) > THR) & grad_mask
    if motion is not None:
        rgb_mask = rgb_mask & motion
    return jnp.mean(opacity[None] * jnp.abs((image_ab - gt) * rgb_mask.astype(jnp.float32)[None]))


def _j_mapping_rgb(images_ab, images_gt):
    """fourdgs/slam/mapping.py:237-243."""
    rgb_masks = (jnp.sum(images_gt, axis=1) > THR).astype(jnp.float32)[:, None]
    return jnp.mean(jnp.abs((images_ab - images_gt) * rgb_masks), axis=(1, 2, 3))


@pytest.mark.parametrize("with_motion", [False, True])
def test_tracking_loss_rgb_and_gradients_match(with_motion):
    from fourdgs.ops.image import grad_intensity_mask

    img, gt, _, _, opacity, motion = _inputs(7)
    grad_mask = np.asarray(grad_intensity_mask(jnp.asarray(gt), 1.1))[0]
    mm = motion if with_motion else None
    jv, jg = jax.value_and_grad(
        lambda i, o: _j_tracking_rgb(i, o, jnp.asarray(gt), jnp.asarray(grad_mask),
                                     None if mm is None else jnp.asarray(mm)),
        argnums=(0, 1))(jnp.asarray(img), jnp.asarray(opacity))
    ti, to = (torch.tensor(a, requires_grad=True) for a in (img, opacity))
    tv = tls.tracking_loss_rgb(ti, to, torch.tensor(gt), torch.tensor(grad_mask),
                               None if mm is None else torch.tensor(mm),
                               rgb_boundary_threshold=THR)
    tg = torch.autograd.grad(tv, (ti, to))
    np.testing.assert_allclose(float(tv.detach()), float(jv), **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())


def test_mapping_loss_rgb_and_gradients_match():
    views = [_inputs(s) for s in (8, 9)]
    img = np.stack([v[0] for v in views])
    gt = np.stack([v[1] for v in views])
    jv, jvjp = jax.vjp(lambda i: _j_mapping_rgb(i, jnp.asarray(gt)), jnp.asarray(img))
    (jg,) = jvjp(jnp.asarray([1.0, 2.0]))
    ti = torch.tensor(img, requires_grad=True)
    tv = tls.mapping_loss_rgb(ti, torch.tensor(gt), rgb_boundary_threshold=THR)
    (tg,) = torch.autograd.grad(tv, ti, torch.tensor([1.0, 2.0]))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())


# ---------------------------------------------------------------------------
# one tracking and one mapping step
# ---------------------------------------------------------------------------


def test_track_frame_monocular_matches_jax():
    """The tolerances of tests/test_torch_tracking.py, at 10 iterations: the
    RGB-only loss is flat near its minimum, and at 20 the poses still agree
    within the tolerance but the last step's loss, small there, lands just
    outside its relative one. The frame's depth is zeros: the monocular
    loss reads none."""
    from fourdgs.geometry import se3_exp as j_se3

    gmap = _jax_map()
    target = j_rasterize(
        gmap.params.xyz, gmap.get_scaling, gmap.get_rotation, gmap.get_opacity,
        gmap.get_color, gmap.alive & ~gmap.dygs, jnp.eye(4), J_INTR.proj(), jnp.zeros(3),
        fx=J_INTR.fx, fy=J_INTR.fy, width=W, height=H, tan_fovx=J_INTR.tan_fovx,
        tan_fovy=J_INTR.tan_fovy, config=J_RASTER)
    image = np.asarray(target.color)
    depth = np.zeros((H, W), np.float32)
    motion = np.ones((H, W), bool)
    motion[10:20, 30:45] = False
    T0 = np.asarray(j_se3(jnp.asarray([0.02, -0.015, 0.01, 0.006, -0.008, 0.004])))
    exp0 = np.array([0.01, -0.02], np.float32)
    jres = j_track_frame(gmap, j_make_frame(1, image, depth, np.eye(4), 0.5, motion),
                         jnp.asarray(T0), jnp.asarray(exp0), J_INTR,
                         JTrackingConfig(max_iters=10, monocular=True, raster=J_RASTER))
    tres = track_frame(convert.gaussian_map_from_arrays(gmap, "cpu"),
                       make_frame(1, image, None, np.eye(4), 0.5, motion, device="cpu"),
                       convert.pose_from_array(T0, "cpu"), torch.tensor(exp0), T_INTR,
                       TrackingConfig(max_iters=10, monocular=True))
    assert tres.n_iters == int(jres.n_iters)
    np.testing.assert_allclose(tres.T_cw.numpy(), np.asarray(jres.T_cw), atol=1e-4)
    np.testing.assert_allclose(tres.exposure.numpy(), np.asarray(jres.exposure), atol=1e-4)
    np.testing.assert_allclose(tres.final_loss, float(jres.final_loss), rtol=1e-3)
    # the median depth still comes from the render
    np.testing.assert_allclose(float(tres.median_depth), float(jres.median_depth), rtol=1e-4)
    # and the pose moved towards the view the frame was rendered at
    assert np.abs(tres.T_cw.numpy() - np.eye(4)).max() < np.abs(T0 - np.eye(4)).max()


def test_map_chunk_monocular_matches_jax():
    """The tolerances and the second case of tests/test_torch_mapping.py
    (map parameters step after iteration 2). Stepping from the first
    iteration, the RGB-only loss leaves a few gradient components near zero
    (two orders of magnitude below the median), whose sign rounding sets;
    Adam turns each into a full step, and those land just outside the
    tolerance apart."""
    gmap, adam, store = _state()
    slots = np.array([1, 2, 0], np.int32)
    valid = np.array([True, True, False])
    opt_pose = np.array([True, False, False])
    pool = [3, 0, 2]
    pool_arr = np.zeros(8, np.int32)
    pool_arr[:len(pool)] = pool
    iters, step_after, base = 6, 2, 40
    key = jax.random.key(4)
    jres = jm.map_chunk(gmap, adam, store, jnp.asarray(slots), jnp.asarray(valid),
                        jnp.asarray(opt_pose), jnp.asarray(pool_arr), jnp.int32(len(pool)),
                        jm.init_pose_adam(3), key, jnp.int32(iters), jnp.int32(step_after),
                        jnp.int32(base), J_INTR,
                        jm.MappingConfig(num_window_views=3, num_random_views=2, alpha=0.9,
                                         monocular=True, raster=J_MAP_RASTER))
    tres = tm.map_chunk(convert.gaussian_map_from_arrays(gmap, "cpu"),
                        convert.adam_from_arrays(adam, "cpu"),
                        convert.store_from_arrays(store, "cpu"), slots, valid, opt_pose,
                        pool_arr, len(pool), tm.init_pose_adam(3, "cpu"),
                        _jax_picks(key, iters, len(pool)), iters, step_after, base, T_INTR,
                        tm.MappingConfig(num_window_views=3, num_random_views=2, alpha=0.9,
                                         monocular=True))
    tg, jg = convert.gaussian_map_to_arrays(tres.gmap), jres.gmap
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        a, b = tg["params"][name], np.asarray(getattr(jg.params, name))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(), err_msg=name)
    ts = convert.store_to_arrays(tres.store)
    np.testing.assert_allclose(ts["T_cw"], np.asarray(jres.store.T_cw), atol=1e-5)
    np.testing.assert_allclose(ts["exposure"], np.asarray(jres.store.exposure), atol=1e-5)
    np.testing.assert_allclose(tres.final_loss, float(jres.final_loss), rtol=1e-4)
    # the RGB-D loss differs on the same state: the branch was taken
    rgbd = tm.map_chunk(convert.gaussian_map_from_arrays(gmap, "cpu"),
                        convert.adam_from_arrays(adam, "cpu"),
                        convert.store_from_arrays(store, "cpu"), slots, valid, opt_pose,
                        pool_arr, len(pool), tm.init_pose_adam(3, "cpu"),
                        _jax_picks(key, iters, len(pool)), 1, step_after, base, T_INTR,
                        tm.MappingConfig(num_window_views=3, num_random_views=2, alpha=0.9))
    assert abs(rgbd.final_loss - tres.final_loss) > 1e-3


# ---------------------------------------------------------------------------
# trajectory error
# ---------------------------------------------------------------------------


def test_scaled_alignment_and_evo_match_jax(tmp_path):
    rng = np.random.default_rng(11)
    gt = rng.normal(size=(3, 30))
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    est = 0.37 * R @ gt + rng.normal(size=(3, 1)) + 0.01 * rng.normal(size=(3, 30))
    for with_scale in (False, True):
        for a, b in zip(tate.umeyama_alignment(est, gt, with_scale=with_scale),
                        jate.umeyama_alignment(est, gt, with_scale=with_scale)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert abs(tate.umeyama_alignment(est, gt, with_scale=True)[2] - 1 / 0.37) < 0.05

    def c2w(p):
        T = np.eye(4)
        T[:3, 3] = p
        return T

    poses_gt = [c2w(p) for p in gt.T]
    poses_est = [c2w(p) for p in est.T]
    for mono in (False, True):
        t = tate.evaluate_evo(poses_gt, poses_est, str(tmp_path / "t"), monocular=mono)
        j = jate.evaluate_evo(poses_gt, poses_est, str(tmp_path / "j"), monocular=mono)
        assert abs(t - j) <= 1e-9, (mono, t, j)
    assert tate.evaluate_evo(poses_gt, poses_est, str(tmp_path / "t"), monocular=True) < 0.05


# ---------------------------------------------------------------------------
# the whole run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(one_torch_thread):  # noqa: F811
    cfg = _run_config(monocular=True)
    jslam = JSLAM(JConfigDict.wrap(cfg), capacity=4096, max_keyframes=8,
                  raster=JRasterConfig(use_oracle=False, tile_cap=256, max_pairs=1 << 13))
    jslam.run()
    tslam = SLAM(ConfigDict.wrap(cfg), capacity=4096, max_keyframes=8, device="cpu",
                 draws=JaxDraws(0))
    tslam.run()
    return tslam, jslam


def test_monocular_run_matches_jax(runs):
    tslam, jslam = runs
    assert tslam.monocular and jslam.monocular
    assert tslam.kf_indices == jslam.kf_indices == [0, 2, 4]
    assert tslam.initialized and jslam.initialized
    # the initial bundle adjustment ran at keyframe 4, where the window filled
    assert tslam.metrics["initial_ba_at"] == 4
    assert tslam.iteration_count == jslam.iteration_count >= 300
    assert tslam.gmap.num_alive == int(jslam.gmap.num_alive)
    assert sorted(tslam.poses_est) == sorted(jslam.poses_est) == list(range(6))
    for i in range(6):
        err = np.linalg.norm(_centre(tslam.poses_est[i]) - _centre(jslam.poses_est[i]))
        assert err < 1e-3, (i, err)


def test_reset_matches_jax(runs):
    """The recovery, called on both runners from their finished states with
    the same frame: both maps rebuilt from it alike, one keyframe, the
    window restarted, uninitialised."""
    tslam, jslam = runs
    idx = 5
    image, depth, pose, motion = jslam.dataset[idx]
    jframe = j_make_frame(idx, image, depth, pose, idx / (len(jslam.dataset) - 1), motion)
    tframe = dict(iter_frames(tslam.dataset, tslam.edge_threshold, idx + 1, device="cpu"))[idx]
    # both runners at the same pose for the frame (the runs agree within 1e-3 m)
    jslam.poses_est[idx] = tslam.poses_est[idx].copy()
    jslam._reset(idx, jframe)
    tslam._reset(idx, tframe)
    for s in (tslam, jslam):
        assert s.kf_indices == [idx] and s.window == [idx] and s.kf_slot == {idx: 0}
        assert not s.initialized and s.iteration_count == 0 and s.kf_total == 1
    tg = convert.gaussian_map_to_arrays(tslam.gmap)
    assert tslam.gmap.num_alive == int(jslam.gmap.num_alive) > 0
    np.testing.assert_array_equal(tg["alive"], np.asarray(jslam.gmap.alive))
    np.testing.assert_allclose(tg["params"]["xyz"], np.asarray(jslam.gmap.params.xyz),
                               atol=1e-5)
    np.testing.assert_allclose(tslam.store.T_cw[0].numpy(), np.asarray(jslam.store.T_cw[0]),
                               atol=1e-6)
    vis_t, vis_j = tslam.occ_visibility[idx], jslam.occ_visibility[idx]
    assert vis_t.sum() > 0
    assert np.mean(vis_t == vis_j) > 0.999


# ---------------------------------------------------------------------------
# a recording without depth
# ---------------------------------------------------------------------------


def test_reference_frame_without_depth_raises():
    """The reference cannot make a frame without depth: its loader returns
    None for `sensor_type: monocular` (fourdgs/data/base.py:103) and
    `make_frame` raises, inside its prefetch thread, which then never ends
    the queue. Called here directly, never through the loader."""
    image = np.zeros((3, H, W), np.float32)
    with pytest.raises(ValueError):
        j_make_frame(0, image, None, np.eye(4), 0.0)
    frame = make_frame(0, image, None, np.eye(4), 0.0, device="cpu")
    assert frame.depth.shape == (H, W) and not frame.depth.any()


@pytest.fixture(scope="module")
def tum_sequence(tmp_path_factory):
    cfg = ConfigDict.wrap(_run_config(num_frames=5))
    root = tmp_path_factory.mktemp("mono_tum")
    write_tum_format(SyntheticDataset(None, "", cfg, device="cpu"), str(root / "seq"),
                     depth_scale=5000.0)
    return str(root / "seq")


def _tum_config(seq, sensor_type, wrap=True):
    cfg = _run_config(num_frames=5, monocular=True)
    cfg["Dataset"].update(type="tum", dataset_path=seq, sensor_type=sensor_type)
    cfg["Dataset"]["Calibration"]["depth_scale"] = 5000.0
    return ConfigDict.wrap(cfg) if wrap else cfg


def test_monocular_recording_runs_without_depth(tum_sequence, one_torch_thread):  # noqa: F811
    """Departure 5: on a TUM-layout sequence with `sensor_type: monocular`
    the loader reads no depth and the frames carry zeros; the monocular
    run is the same as on the same sequence with its depth read (the
    monocular path reads no depth at a window of 3, where covisibility
    selection, which reads the anchor's depth, never runs)."""
    no_depth = SLAM(_tum_config(tum_sequence, "monocular"), capacity=4096, max_keyframes=8,
                    device="cpu")
    assert not no_depth.dataset.has_depth and no_depth.dataset[1][1] is None
    no_depth.run()
    with_depth = SLAM(_tum_config(tum_sequence, "depth"), capacity=4096, max_keyframes=8,
                      device="cpu")
    assert with_depth.dataset.has_depth
    with_depth.run()
    assert not no_depth.store.depths.any() and with_depth.store.depths.any()
    assert no_depth.kf_indices == with_depth.kf_indices == [0, 2, 4]
    assert no_depth.initialized and with_depth.initialized
    for i in range(5):
        err = np.linalg.norm(_centre(no_depth.poses_est[i]) - _centre(with_depth.poses_est[i]))
        assert err < 1e-6, (i, err)
    rend = no_depth.eval_rendering()
    assert rend["mean_l1_depth"] is None and np.isfinite(rend["mean_psnr"])


def test_monocular_config_through_the_command_line(tum_sequence, tmp_path,
                                                   one_torch_thread):  # noqa: F811
    """A monocular run is a config, not a flag: `Dataset.sensor_type:
    monocular` and `Training.monocular: true` through `cli.main --eval`,
    refinement included; the metrics have no depth error."""
    import yaml

    from fourdgs_torch import cli

    cfg = _tum_config(tum_sequence, "monocular", wrap=False)
    cfg["Results"].update(save_dir=str(tmp_path / "results"))
    cfg["Training"]["refinement_iters"] = 3
    with open(tmp_path / "mono.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    metrics = cli.main(["--config", str(tmp_path / "mono.yaml"), "--eval", "--device", "cpu",
                        "--capacity", "4096"])
    assert metrics["n_frames"] == 5 and metrics["l1_depth_after"] is None
    assert np.isfinite(metrics["ate_rmse"]) and np.isfinite(metrics["psnr_after"])
    (run_dir,) = list((tmp_path / "results").iterdir())
    assert (run_dir / "pose.txt").exists() and (run_dir / "psnr" / "after_opt").exists()


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def test_checkpoint_keeps_initialized(tmp_path, one_torch_thread):  # noqa: F811
    """A monocular run stopped before its window fills is not initialised,
    and resumes so; an RGB-D runner's checkpoint says initialised."""
    cfg = ConfigDict.wrap(_run_config(num_frames=4, monocular=True))
    slam = SLAM(cfg, capacity=4096, max_keyframes=8, device="cpu")
    slam.run()
    assert slam.kf_indices == [0, 2] and not slam.initialized
    path = str(tmp_path / "mono.npz")
    slam.save_checkpoint(path)
    resumed = SLAM(cfg, capacity=4096, max_keyframes=8, device="cpu")
    resumed.initialized = True
    resumed.load_checkpoint(path)
    assert not resumed.initialized and resumed.window == slam.window
    rgbd_cfg = ConfigDict.wrap(_run_config(num_frames=4))
    rgbd = SLAM(rgbd_cfg, capacity=4096, max_keyframes=8, device="cpu")
    assert rgbd.initialized
    rgbd._initialize(next(iter_frames(rgbd.dataset, 1.1, 1, device="cpu"))[1])
    rgbd.save_checkpoint(str(tmp_path / "rgbd.npz"))
    again = SLAM(rgbd_cfg, capacity=4096, max_keyframes=8, device="cpu")
    again.initialized = False
    again.load_checkpoint(str(tmp_path / "rgbd.npz"))
    assert again.initialized
