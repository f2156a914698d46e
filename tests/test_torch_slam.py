"""The slice as a whole: `fourdgs_torch.slam.runner.SLAM.run` against the
JAX `SLAM.run`, and a port-only run held to the reference's end-to-end
thresholds.

The parity run feeds both packages the same random numbers: `JaxDraws`
hands the port the draws the JAX runner takes from its own key sequence
(`SLAM._next_key`), call site by call site. The JAX runner renders through
its Pallas kernels in interpret mode, so both sides bin and composite
alike. Poses agree within 1e-3 m."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.slam.runner import SLAM as JSLAM
from fourdgs.utils.config import ConfigDict as JConfigDict
from fourdgs_torch.slam.runner import SLAM
from fourdgs_torch.utils.config import ConfigDict


class JaxDraws:
    """The port's random source (fourdgs_torch/utils/draws.py), drawing
    what the JAX runner draws: one split of the same key chain per call,
    and the same `jax.random` call on that key as the JAX call site."""

    def __init__(self, seed=0):
        self.key = jax.random.key(seed)

    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def uniform(self, n):
        # candidates_from_rgbd (fourdgs/models/gaussian_map.py:551)
        return torch.tensor(np.asarray(jax.random.uniform(self._next_key(), (n,))))

    def normal2(self, shape):
        # densify_and_prune's split samples (gaussian_map.py:442-444)
        keys = jax.random.split(self._next_key(), 2)
        return tuple(torch.tensor(np.asarray(jax.random.normal(k, tuple(shape))))
                     for k in keys)

    def replay_picks(self, num_iters, pool_size):
        # map_chunk's replay picks (fourdgs/slam/mapping.py:331-333)
        return jax_picks(self._next_key(), num_iters, pool_size)

    def refine_chunk(self, num_iters, pool_len):
        return jax_refine_draws(self._next_key(), num_iters, pool_len)

    def fps_start(self, valid):
        # init_nodes splits its key (fourdgs/models/deform.py:144): the FPS
        # start from the first half (fourdgs/ops/knn.py:123), the MLP from
        # the second, which mlp_init takes next
        k1, self._mlp_key = jax.random.split(self._next_key())
        vf = jnp.asarray(valid.cpu().numpy(), jnp.float32)
        start = jax.random.choice(k1, vf.shape[0], p=vf / jnp.maximum(jnp.sum(vf), 1.0))
        return torch.tensor(int(start))

    def mlp_init(self, dims, head_dims):
        # fourdgs/models/deform.py:102-130
        keys = jax.random.split(self._mlp_key, len(dims) + 3)
        ws = [torch.tensor(np.asarray(jax.random.uniform(
            keys[i], (d_in, d_out), minval=-jnp.sqrt(6.0 / d_in),
            maxval=jnp.sqrt(6.0 / d_in)))) for i, (d_in, d_out) in enumerate(dims)]
        width = dims[-1][1]
        heads = [torch.tensor(np.asarray(jax.random.normal(k, (width, d))))
                 for k, d in zip(keys[-3:], head_dims)]
        return ws, heads

    def warmup(self):
        # warmup_network takes a key and draws nothing from it
        self._next_key()

    def dynamic_chunk(self, num_iters, pool_size, num_views):
        return jax_dynamic_draws(self._next_key(), num_iters, pool_size, num_views)


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's tests on one torch thread. Their tensors are small,
    where one thread is about as fast as many, and the other test workers
    keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_picks(key, num_iters, pool_size):
    """The replay picks map_chunk and map_chunk_dynamic draw from `key`."""
    size = max(pool_size, 1)
    ki = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(num_iters))
    r1 = jax.vmap(lambda k: jax.random.randint(k, (), 0, size))(ki)
    r2 = jax.vmap(lambda k: jax.random.randint(jax.random.fold_in(k, 1), (), 0,
                                               max(size - 1, 1)))(ki)
    return np.stack([np.asarray(r1), np.asarray(r2)], 1).astype(np.int64)


def jax_refine_draws(key, num_iters, pool_len):
    """What a refine-mode map_chunk draws from `key`: per iteration one
    uniform per pool entry (fourdgs/slam/mapping.py:76-87, 293-297)."""
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (pool_len,)))
                     for i in range(num_iters)])


def jax_dynamic_draws(key, num_iters, pool_size, num_views):
    """What map_chunk_dynamic draws from `key` (fourdgs/slam/mapping_dynamic.py
    :339-343, :390-398 into fourdgs/models/deform.py:291-293, :322-324): the
    replay picks, and per iteration and view ARAP's (jitter, 2 samples) and
    the elastic term's (jitter, 8 samples)."""

    def one(i, v):
        kv = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(key, i), 100), v)
        out = []
        for k, n in ((kv, 2), (jax.random.fold_in(kv, 1), 8)):
            k1, k2 = jax.random.split(k)
            out.append(jnp.concatenate([jax.random.uniform(k1, ())[None],
                                        jax.random.uniform(k2, (n,))]))
        return out

    arap, elastic = jax.vmap(lambda i: jax.vmap(lambda v: one(i, v))(
        jnp.arange(num_views)))(jnp.arange(num_iters))
    return (jax_picks(key, num_iters, pool_size), torch.tensor(np.asarray(arap)),
            torch.tensor(np.asarray(elastic)))


def _config(num_frames, w, h, fx, **training):
    """The synthetic-sequence config of tests/test_end_to_end.py:16-67."""
    tr = {
        "init_itr_num": 40, "init_gaussian_update": 30, "init_gaussian_reset": 2000,
        "init_gaussian_th": 0.005, "init_gaussian_extent": 30,
        "tracking_itr_num": 30, "mapping_itr_num": 15, "keyframe_mapping_iters": 15,
        "gaussian_update_every": 10000, "gaussian_update_offset": 50,
        "gaussian_th": 0.7, "gaussian_extent": 1.0, "gaussian_reset": 20001,
        "size_threshold": 20, "kf_interval": 5, "window_size": 3, "pose_window": 2,
        "edge_threshold": 1.1, "rgb_boundary_threshold": 0.01, "alpha": 0.9,
        "kf_translation": 0.08, "kf_min_translation": 0.05, "kf_overlap": 0.9,
        "kf_cutoff": 0.3, "single_thread": True, "monocular": False,
        "lr": {"cam_rot_delta": 0.003, "cam_trans_delta": 0.001},
    }
    tr.update(training)
    return {
        "Results": {"save_results": False, "use_gui": False},
        "Dataset": {
            "type": "synthetic", "sensor_type": "depth", "dataset_path": "",
            "num_frames": num_frames, "points_per_wall": 1500,
            "pcd_downsample": 16, "pcd_downsample_init": 8,
            "adaptive_pointsize": True, "point_size": 0.05,
            "Calibration": {"fx": fx, "fy": fx, "cx": (w - 1) / 2, "cy": (h - 1) / 2,
                            "width": w, "height": h, "depth_scale": 1.0,
                            "distorted": False},
        },
        "Training": tr,
        "opt_params": {"densify_grad_threshold": 0.0002},
        "model_params": {"sh_degree": 0, "dynamic_model": False},
    }


def test_slam_run_matches_jax():
    # 4 frames at 64x48: init with one densify (at 3 of 5 iterations), two
    # tracked frames, a keyframe at frame 2 with its mapping phase, then one
    # more tracked frame. No densify fires in the keyframe phase: its fresh
    # Gaussians are exactly isotropic, where the isotropic loss's gradient
    # sign is rounding noise that Adam amplifies, and clone-or-split then
    # goes by that noise on either side
    cfg = _config(4, 64, 48, 60.0, init_itr_num=5, init_gaussian_update=3,
                  tracking_itr_num=6, keyframe_mapping_iters=4, mapping_itr_num=4,
                  kf_interval=2, kf_overlap=1.01)
    jslam = JSLAM(JConfigDict.wrap(cfg), capacity=4096, max_keyframes=8,
                  raster=JRasterConfig(use_oracle=False, tile_cap=256, max_pairs=1 << 13))
    jslam.run()
    tslam = SLAM(ConfigDict.wrap(cfg), capacity=4096, max_keyframes=8, device="cpu",
                 draws=JaxDraws(0))
    tslam.run()

    assert sorted(tslam.poses_est) == sorted(jslam.poses_est) == [0, 1, 2, 3]
    assert tslam.kf_indices == jslam.kf_indices == [0, 2]
    assert tslam.gmap.num_alive == int(jslam.gmap.num_alive)
    for i in range(4):
        c_t = -tslam.poses_est[i][:3, :3].T @ tslam.poses_est[i][:3, 3]
        c_j = -jslam.poses_est[i][:3, :3].T @ jslam.poses_est[i][:3, 3]
        assert np.linalg.norm(c_t - c_j) < 1e-3, (i, c_t, c_j)
        np.testing.assert_allclose(tslam.poses_est[i][:3, :3], jslam.poses_est[i][:3, :3],
                                   atol=1e-3)


@pytest.fixture(scope="module")
def port_run():
    cfg = ConfigDict.wrap(_config(15, 80, 60, 80.0))
    slam = SLAM(cfg, capacity=8192, max_keyframes=16, device="cpu")
    slam.run()
    return slam


def test_port_slam_meets_end_to_end_thresholds(port_run):
    # the thresholds of tests/test_end_to_end.py:87-101
    assert len(port_run.poses_est) == port_run.n_frames
    assert len(port_run.kf_indices) >= 2
    assert port_run.gmap.num_alive > 500
    stats = port_run.eval_ate()
    assert stats["rmse"] < 0.05, stats
    res = port_run.eval_rendering(interval=5)
    assert res["mean_psnr"] > 15.0, res
    assert res["mean_l1_depth"] < 1.2, res


def test_slam_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SLAM(ConfigDict.wrap(_config(2, 32, 24, 30.0)))
