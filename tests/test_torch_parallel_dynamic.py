"""The 4D path on a mesh through the runner: `SLAM(dynamic=True)` with
`Training.mesh_devices: 2` on 2 CPU ranks over gloo against the same run
on one device, both from the reference's draws (`JaxDraws`). The
one-device run is held against the reference's runner in
tests/test_torch_slam_dynamic.py; this file holds the runner's wiring of
`map_chunk_dynamic(mesh=)`.

The run is tests/test_torch_slam_dynamic.py's parity run (4 frames at
64x48, the deformation made at the keyframe at dystart 2, its warmup and
4D mapping, then a tracked frame), with camera learning rates a tenth of
that file's, as tests/test_torch_slam_yolo.py conditions its run: at
that file's, the mesh's other order of summation moved frame 2's camera
centre by 1.2 mm; at a tenth, by 0.014 mm.

Held: keyframes, the dynamic Gaussians and the control nodes equal;
camera centres within tests/test_torch_slam.py's 1e-3 m; the 4D chunk
(`_dynamic_rank`) ran on the mesh, every rank ending each call alike; no
worker imported `jax` or `fourdgs`; the mesh closed after the run."""

import numpy as np
import pytest

from fourdgs_torch.parallel.mesh import Mesh
from fourdgs_torch.slam.runner import SLAM
from fourdgs_torch.utils.config import ConfigDict
from tests.test_torch_slam import JaxDraws, _config, one_torch_thread  # noqa: F401
from tests.test_torch_slam_dynamic import _dynamic

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CONDITIONING = {"lr": {"cam_rot_delta": 0.0003, "cam_trans_delta": 0.0001}}


def _run(mesh_devices: int):
    cfg = _dynamic(_config(4, 64, 48, 60.0, init_itr_num=5, init_gaussian_update=3,
                           tracking_itr_num=6, keyframe_mapping_iters=4, mapping_itr_num=4,
                           kf_interval=3, kf_overlap=1.01, mesh_devices=mesh_devices,
                           **CONDITIONING), 2, 16)
    slam = SLAM(ConfigDict.wrap(cfg), dynamic=True, capacity=4096, max_keyframes=8,
                device="cpu", draws=JaxDraws(0))
    slam.run()
    return slam


@pytest.fixture(scope="module")
def dyn_runs():
    """The run on one device, and on 2 ranks with the names of the
    functions the mesh ran."""
    called = []
    run = Mesh.run

    def recording(self, fn, *args):
        called.append(fn.__name__)
        return run(self, fn, *args)

    one = _run(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Mesh, "run", recording)
        two = _run(2)
    return one, two, called


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def test_dynamic_runner_mesh_matches_one_device(dyn_runs):
    one, two, _ = dyn_runs
    assert one.kf_indices == two.kf_indices == [0, 2]
    assert one.deform_init and two.deform_init
    np.testing.assert_array_equal((one.gmap.dygs & one.gmap.alive).numpy(),
                                  (two.gmap.dygs & two.gmap.alive).numpy())
    assert int((two.gmap.dygs & two.gmap.alive).sum()) > 0
    np.testing.assert_array_equal(one.deform.valid.numpy(), two.deform.valid.numpy())
    np.testing.assert_allclose(one.deform.nodes.numpy(), two.deform.nodes.numpy(), atol=1e-5)
    assert sorted(one.poses_est) == sorted(two.poses_est) == [0, 1, 2, 3]
    for i in range(4):
        err = np.linalg.norm(_centre(one.poses_est[i]) - _centre(two.poses_est[i]))
        assert err < 1e-3, (i, err)


def test_dynamic_runner_ran_the_4d_chunk_on_the_mesh(dyn_runs):
    _, two, called = dyn_runs
    assert "_dynamic_rank" in called and "_map_chunk_rank" in called
    mesh = two.mesh
    assert mesh.closed and mesh.calls == len(called)
    assert len(mesh.checksums) == 2 and len(set(mesh.checksums)) == 1
    assert mesh.imported == [[]]     # no worker imported jax or fourdgs
