"""The 4D path as a whole: `SLAM(dynamic=True).run` of the port against the
JAX one, and a port-only run held to the reference's end-to-end
thresholds for the dynamic path (tests/test_end_to_end_dynamic.py:35-74).

The parity run feeds both packages the same random numbers (`JaxDraws`:
the FPS start, the MLP's initial weights, the spawns, the replay picks and
the regularizers' time samples), and the JAX runner renders through its
Pallas kernels in interpret mode. Keyframes and the numbers of Gaussians
and of dynamic Gaussians come out equal, the control nodes within 1e-3 m
and the camera centres before dystart within 1e-3 m. From dystart on the
cameras are held within 5e-3 m and the learned field not at all: the
deformation warmup's 100 Adam steps at eps 1e-15 are chaotic in the
reference itself (tests/test_torch_mapping_dynamic.py
`test_warmup_diverges_in_the_reference_itself`), so the two fields part
after some tens of steps whatever the port does; and the port's flow
payloads reach no camera's pose, where the reference's do
(fourdgs_torch/slam/mapping_dynamic.py `_payload_camera`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.slam.runner import SLAM as JSLAM
from fourdgs.utils.config import ConfigDict as JConfigDict
from fourdgs_torch import convert
from fourdgs_torch.models.deform import warp
from fourdgs_torch.slam.runner import SLAM
from fourdgs_torch.utils.config import ConfigDict
from tests.test_torch_slam import JaxDraws, _config, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _dynamic(cfg, dystart, node_num):
    cfg["Dataset"]["dynamic"] = True
    cfg["Training"].update(dystart=dystart, flow_loss=3, flow_loss_fine=2)
    cfg["ModelHiddenParams"] = {"node_num": node_num}
    return cfg


def test_dynamic_slam_run_matches_jax():
    # 4 frames at 64x48: init, the forced keyframe at dystart 2 (off the
    # kf_interval grid of 3) with the deformation's init, its 100-iteration
    # warmup and 4 dynamic mapping iterations, then a tracked frame
    cfg = _dynamic(_config(4, 64, 48, 60.0, init_itr_num=5, init_gaussian_update=3,
                           tracking_itr_num=6, keyframe_mapping_iters=4, mapping_itr_num=4,
                           kf_interval=3, kf_overlap=1.01), 2, 16)
    jslam = JSLAM(JConfigDict.wrap(cfg), dynamic=True, capacity=4096, max_keyframes=8,
                  raster=JRasterConfig(use_oracle=False, tile_cap=256, max_pairs=1 << 13))
    jslam.run()
    tslam = SLAM(ConfigDict.wrap(cfg), dynamic=True, capacity=4096, max_keyframes=8,
                 device="cpu", draws=JaxDraws(0))
    tslam.run()

    assert tslam.kf_indices == jslam.kf_indices == [0, 2]
    assert tslam.deform_init and jslam.deform_init
    t_dy = tslam.gmap.dygs & tslam.gmap.alive
    assert int(t_dy.sum()) == int(jnp.sum(jslam.gmap.dygs & jslam.gmap.alive)) > 0
    assert tslam.gmap.num_alive == int(jslam.gmap.num_alive)
    for i in range(4):
        c_t = -tslam.poses_est[i][:3, :3].T @ tslam.poses_est[i][:3, 3]
        c_j = -jslam.poses_est[i][:3, :3].T @ jslam.poses_est[i][:3, 3]
        # before dystart the static path's bound; from it on, after the
        # warmup, the bound its divergence allows (see the module's doc)
        assert np.linalg.norm(c_t - c_j) < (1e-3 if i < 2 else 5e-3), (i, c_t, c_j)
    got = convert.control_nodes_to_arrays(tslam.deform)
    np.testing.assert_array_equal(got["valid"], np.asarray(jslam.deform.valid))
    np.testing.assert_allclose(got["nodes"], np.asarray(jslam.deform.nodes), atol=1e-3)
    assert len(np.unique(got["nodes"][got["valid"]], axis=0)) == int(got["valid"].sum())


@pytest.fixture(scope="module")
def port_run():
    cfg = _dynamic(_config(15, 80, 60, 80.0), 7, 64)
    slam = SLAM(ConfigDict.wrap(cfg), dynamic=True, capacity=8192, max_keyframes=16,
                device="cpu")
    slam.run()
    return slam


def test_port_dynamic_slam_meets_end_to_end_thresholds(port_run):
    # the thresholds of tests/test_end_to_end_dynamic.py:35-74
    assert len(port_run.poses_est) == port_run.n_frames
    assert port_run.deform_init
    assert int((port_run.gmap.dygs & port_run.gmap.alive).sum()) > 20
    assert 7 in port_run.kf_indices, port_run.kf_indices      # the forced dystart keyframe
    assert port_run.eval_ate()["rmse"] < 0.08
    res = port_run.eval_rendering(interval=5)
    assert res["mean_psnr"] is not None and res["mean_psnr"] > 14.0, res


def test_port_deform_field_produces_motion(port_run):
    xyz, dygs = port_run.gmap.params.xyz, port_run.gmap.dygs
    with torch.no_grad():
        d0 = warp(port_run.deform, xyz, torch.tensor(0.3), motion_mask=dygs)[0]
        d1 = warp(port_run.deform, xyz, torch.tensor(0.9), motion_mask=dygs)[0]
    dy = dygs & port_run.gmap.alive
    motion = torch.linalg.norm(d1 - d0, dim=-1)[dy]
    assert motion.numel() > 0
    # the blob sweeps ~1.2 units over t in [0, 1]
    assert float(motion.median()) > 0.02, float(motion.median())


def test_dynamic_slam_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SLAM(ConfigDict.wrap(_dynamic(_config(2, 32, 24, 30.0), 1, 8)), dynamic=True)
