"""`SLAM` with `Training.mesh_devices: 2` (fourdgs_torch/parallel/ under
the runner) against the reference's runner with the same key: the port's
mapping runs on 2 CPU ranks over gloo, the reference's on 2 devices of
the virtual 8-device mesh of tests/conftest.py, through its Pallas
kernels in interpret mode, both from the same draws (`JaxDraws`).

Held: keyframes equal and camera centres within tests/test_torch_slam.py's
1e-3 m; every rank ended each mapping call with the same state, bit for
bit (`Mesh.checksums`); no worker imported `jax` or `fourdgs`; the mesh
made at the first mapping call and closed after the run; a mesh run's
checkpoint resumes on one device; in a `with` block one mesh serves the
mapping and the colour refinement, and the block's end closes it. The
4D path on a mesh is held in tests/test_torch_parallel_dynamic.py."""

import numpy as np
import pytest

from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.slam.runner import SLAM as JSLAM
from fourdgs.utils.config import ConfigDict as JConfigDict
from fourdgs_torch.slam.runner import SLAM
from fourdgs_torch.utils.config import ConfigDict
from tests.test_torch_slam import JaxDraws, _config, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


RUN_CFG = _config(4, 64, 48, 60.0, init_itr_num=5, init_gaussian_update=3, tracking_itr_num=6,
                  keyframe_mapping_iters=4, mapping_itr_num=4, kf_interval=2, kf_overlap=1.01,
                  mesh_devices=2)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """tests/test_torch_slam.py's parity run with Training.mesh_devices: 2
    on both runners, the port's through its worker processes; the port's
    map checkpointed at the end."""
    jslam = JSLAM(JConfigDict.wrap(RUN_CFG), capacity=4096, max_keyframes=8,
                  raster=JRasterConfig(use_oracle=False, tile_cap=256, max_pairs=1 << 13))
    assert jslam.mesh is not None
    jslam.run()
    tslam = SLAM(ConfigDict.wrap(RUN_CFG), capacity=4096, max_keyframes=8, device="cpu",
                 draws=JaxDraws(0))
    assert tslam.mesh is None      # made at the first mapping call
    tslam.run()
    mesh = tslam.mesh
    assert mesh.size == 2 and mesh.backend == "gloo"
    path = str(tmp_path_factory.mktemp("mesh_ckpt") / "ckpt.npz")
    tslam.save_checkpoint(path)
    return tslam, jslam, mesh, path


def test_runner_mesh_matches_reference_runner(mesh_runs):
    tslam, jslam, mesh, _ = mesh_runs
    assert tslam.kf_indices == jslam.kf_indices == [0, 2]
    assert sorted(tslam.poses_est) == sorted(jslam.poses_est) == [0, 1, 2, 3]
    for i in range(4):
        c_t = -tslam.poses_est[i][:3, :3].T @ tslam.poses_est[i][:3, 3]
        c_j = -jslam.poses_est[i][:3, :3].T @ jslam.poses_est[i][:3, 3]
        assert np.linalg.norm(c_t - c_j) < 1e-3, (i, c_t, c_j)
    # the mapping ran on the workers and the mesh is closed after the run
    assert mesh.closed and mesh.calls > 0
    assert mesh.imported == [[]]     # no worker imported jax or fourdgs


def test_runner_mesh_every_rank_ends_alike(mesh_runs):
    """Each call's result checksums, one per rank, were equal (Mesh.run
    raises otherwise): here the last call's."""
    _, _, mesh, _ = mesh_runs
    assert len(mesh.checksums) == 2 and len(set(mesh.checksums)) == 1


def test_checkpoints_cross_between_mesh_and_one_device(mesh_runs):
    """A mesh run's checkpoint loads into a runner without a mesh, and into
    one with a mesh; a mapping phase from it then gives the same map on
    both (binning every iteration on both, as the mesh does). In a `with`
    block, the colour refinement after it runs on the same mesh, which
    the block's end closes."""
    tslam, _, _, path = mesh_runs
    maps, poses = [], []
    for n in (0, 2):
        cfg = {**RUN_CFG, "Training": {**RUN_CFG["Training"], "mesh_devices": n}}
        with SLAM(ConfigDict.wrap(cfg), capacity=4096, max_keyframes=8, device="cpu") as s:
            s.load_checkpoint(path)
            np.testing.assert_array_equal(s.gmap.params.xyz.numpy(),
                                          tslam.gmap.params.xyz.numpy())
            assert s.kf_indices == tslam.kf_indices and s.window == tslam.window
            s.map_cfg = s.map_cfg._replace(rebin_every=1)
            s._run_mapping(3, -1)
            assert (s.mesh is None) == (n == 0)
            maps.append([p.clone() for p in s.gmap.params])
            poses.append({kf: s.poses_est[kf] for kf in s.window})
            if n:
                mesh = s.mesh
                s.color_refinement(2)
                assert s.mesh is mesh and not mesh.closed and mesh.calls == 2
        assert s.mesh is None or s.mesh.closed
    assert mesh.closed
    for a, b in zip(*maps):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
    for kf in poses[0]:
        np.testing.assert_allclose(poses[0][kf], poses[1][kf], atol=1e-5)
