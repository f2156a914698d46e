"""The live viewer of the port (fourdgs_torch/gui/viewer.py): the cases of
tests/test_gui.py against the port; the trajectory plot, the depth
colouring and the scene payload byte-equal to the reference's on the same
inputs; `maybe_update` on a 64x48 map carried from the reference against
the reference's `maybe_update` (its `_render_view`) on the same state,
the renders within the rasterizer tolerances of tests/test_rasterizer.py
(colour 2e-5, depth 2e-4), the trajectory and the scene payload exactly
equal; and a 3-frame CPU run of the port's runner with `Results.use_gui`:
the files at the interval, status.json's frame, a pause over HTTP that
holds the next frame until resume, and the port free after `run()`. Every
HTTP request and thread join waits at most 5 s."""

import json
import os
import socket
import threading
import time
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fourdgs.gui import viewer as jv
from fourdgs.models.gaussian_map import candidates_from_rgbd, empty_map, init_adam, insert
from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.slam.camera import Intrinsics as JIntrinsics
from fourdgs.slam.mapping import MappingConfig as JMappingConfig
from fourdgs_torch import convert
from fourdgs_torch.gui import viewer as tv
from fourdgs_torch.slam.camera import Intrinsics
from fourdgs_torch.slam.mapping import MappingConfig
from tests.test_torch_slam import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H = 64, 48


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(port, query):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/ctl?{query}", timeout=5) as r:
        return json.loads(r.read())


# ---- tests/test_gui.py's cases against the port


def test_control_channel_pause_resume(tmp_path):
    port = _free_port()
    v = tv.LiveViewer(str(tmp_path), interval=1, serve_port=port)
    try:
        assert not v.paused
        _get(port, "cmd=pause")
        assert v.paused
        released = threading.Event()

        def waiter():
            v.wait_if_paused(timeout=5)
            released.set()

        th = threading.Thread(target=waiter, daemon=True)
        th.start()
        time.sleep(0.1)
        assert not released.is_set()
        assert _get(port, "cmd=resume")["paused"] is False
        th.join(timeout=5)
        assert released.is_set()
        _get(port, "cmd=orbit&yaw=45&x=-50")
        np.testing.assert_allclose(v.orbit[4], np.pi / 4, atol=1e-6)
        np.testing.assert_allclose(v.orbit[0], -0.5, atol=1e-6)
    finally:
        v.close()


def _poses(n=10):
    poses = {}
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.1 * i
        T[2, 3] = 0.05 * i
        poses[i] = T
    return poses


def test_trajectory_plot_marks_keyframes():
    img = tv._trajectory_plot(_poses(), kf_indices=[0, 5])
    assert img.shape == (256, 256, 3)
    assert (img[:, :, 1] > 0.5).sum() >= 10
    assert ((img[:, :, 0] > 0.5) & (img[:, :, 1] < 0.5)).sum() >= 2


def _scene_inputs(n=1000):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.uniform(-0.1, 1.1, size=(n, 3)).astype(np.float32)
    dyn = rng.uniform(size=n) < 0.25
    T = np.eye(4)
    T[0, 3] = 1.5
    return xyz, rgb, dyn, [np.eye(4), T], T


def test_write_scene_payload(tmp_path):
    xyz, rgb, dyn, kfs, T = _scene_inputs()
    wrote = tv.write_scene(str(tmp_path), xyz, rgb, dyn, kfs, T, max_points=256)
    buf = np.fromfile(tmp_path / "points.bin", np.float32).reshape(-1, 7)
    assert wrote == buf.shape[0] <= 256
    np.testing.assert_allclose(buf[0, :3], xyz[0], atol=1e-6)
    np.testing.assert_allclose(buf[0, 3:6], np.clip(rgb[0], 0, 1), atol=1e-6)
    assert set(np.unique(buf[:, 6])) <= {0.0, 1.0}
    scene = json.loads((tmp_path / "scene.json").read_text())
    assert scene["n_points"] == wrote
    assert len(scene["kf"]) == 2 and len(scene["kf"][0]) == 16
    np.testing.assert_allclose(np.asarray(scene["cur"]).reshape(4, 4), T)


def test_index_page_has_scene_widget(tmp_path):
    v = tv.LiveViewer(str(tmp_path), interval=1)
    html = (tmp_path / "gui" / "index.html").read_text()
    for needle in ("canvas", "points.bin", "scene.json", "VERTEX_SHADER", "/ctl?cmd=pause"):
        assert needle in html
    v.close()


# ---- byte-equal to the reference


@pytest.mark.parametrize("n", [1, 10, 40])
def test_trajectory_plot_byte_equal(n):
    rng = np.random.default_rng(n)
    poses = {i: T for i, T in _poses(n).items()}
    for T in poses.values():
        T[:3, 3] += rng.normal(0, 0.05, 3).astype(np.float32)
    kfs = [0, n // 2, n - 1]
    assert tv._trajectory_plot(poses, kfs).tobytes() == jv._trajectory_plot(poses, kfs).tobytes()
    assert tv._trajectory_plot({}, []).tobytes() == jv._trajectory_plot({}, []).tobytes()


def test_colorize_depth_byte_equal():
    rng = np.random.default_rng(4)
    d = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
    d[rng.uniform(size=(H, W)) < 0.2] = 0
    for depth in (d, np.zeros((H, W), np.float32), np.full((H, W), 2.0, np.float32)):
        assert tv._colorize_depth(depth).tobytes() == jv._colorize_depth(depth).tobytes()


@pytest.mark.parametrize("max_points", [256, 1 << 15])
def test_write_scene_byte_equal(tmp_path, max_points):
    xyz, rgb, dyn, kfs, T = _scene_inputs()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    assert (tv.write_scene(str(tmp_path / "t"), xyz, rgb, dyn, kfs, T, max_points)
            == jv.write_scene(str(tmp_path / "j"), xyz, rgb, dyn, kfs, T, max_points))
    for name in ("points.bin", "scene.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


# ---- maybe_update against the reference's on the same map


J_INTR = JIntrinsics(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=W, height=H)


def _jax_map():
    """A map spawned from a textured RGB-D view (3 m with a 2 m box), a
    quarter of it flagged dynamic."""
    v, u = np.mgrid[0:H, 0:W]
    img = np.stack([0.5 + 0.4 * np.sin(u / 4.0), 0.5 + 0.4 * np.cos(v / 6.0),
                    0.5 + 0.3 * np.sin((u + v) / 7.0)]).astype(np.float32)
    depth = np.full((H, W), 3.0, np.float32)
    depth[15:35, 20:45] = 2.0
    cap = 1024
    cands = candidates_from_rgbd(jax.random.key(1), jnp.asarray(img), jnp.asarray(depth),
                                 jnp.eye(4), J_INTR.fx, J_INTR.fy, J_INTR.cx, J_INTR.cy,
                                 downsample=4, max_new=cap)
    gmap, _, _ = insert(empty_map(cap), init_adam(cap), cands, kf_id=0)
    return gmap._replace(dygs=gmap.alive & (jnp.arange(cap) % 4 == 0))


def _poses_est():
    from fourdgs.geometry import se3_exp

    return {i: np.asarray(se3_exp(jnp.asarray([0.02 * i, -0.01 * i, 0, 0, 0.01 * i, 0],
                                              jnp.float32)), np.float32) for i in range(4)}


def _capture(module, monkeypatch):
    """Record the arrays `maybe_update` hands to _save_png and the depth it
    colours, per file name."""
    got = {}
    save, colorize = module._save_png, module._colorize_depth

    def save_png(path, img):
        got[os.path.basename(path)] = np.array(img)
        save(path, img)

    def colorize_depth(depth):
        got["raw_depth"] = np.array(depth)
        return colorize(depth)

    monkeypatch.setattr(module, "_save_png", save_png)
    monkeypatch.setattr(module, "_colorize_depth", colorize_depth)
    return got


def test_maybe_update_matches_reference(tmp_path, monkeypatch):
    jmap = _jax_map()
    poses = _poses_est()
    kfs = [0, 2]
    jslam = types.SimpleNamespace(
        gmap=jmap, poses_est=poses, intr=J_INTR, kf_indices=kfs,
        map_cfg=JMappingConfig(raster=JRasterConfig(use_oracle=False, tile_cap=256,
                                                    max_pairs=1 << 13)))
    tslam = types.SimpleNamespace(
        gmap=convert.gaussian_map_from_arrays(jmap, "cpu"), poses_est=poses,
        intr=Intrinsics(*J_INTR), kf_indices=kfs, map_cfg=MappingConfig(), device="cpu")
    jgot, tgot = _capture(jv, monkeypatch), _capture(tv, monkeypatch)
    jview = jv.LiveViewer(str(tmp_path / "j"), interval=3)
    tview = tv.LiveViewer(str(tmp_path / "t"), interval=3)
    for view in (jview, tview):
        view.orbit = np.asarray([0.2, -0.05, 0.1, 0.02, 0.3, 0.0], np.float32)
    assert tview.maybe_update(tslam, 2) is None and not tgot
    jsnap, tsnap = jview.maybe_update(jslam, 3), tview.maybe_update(tslam, 3)
    assert tsnap.n_gaussians == jsnap.n_gaussians > 0
    assert tsnap.n_dynamic == jsnap.n_dynamic > 0
    assert tsnap.frame_idx == 3
    np.testing.assert_array_equal(tsnap.T_cw, jsnap.T_cw)
    for name in ("current.png", "novel.png"):
        assert tgot[name].shape == (3, H, W)
        np.testing.assert_allclose(tgot[name], jgot[name], rtol=0, atol=2e-5, err_msg=name)
        assert tgot[name].std() > 0.05
    assert np.abs(tgot["current.png"] - tgot["novel.png"]).max() > 0.1
    np.testing.assert_allclose(tgot["raw_depth"], jgot["raw_depth"], rtol=0, atol=2e-4)
    np.testing.assert_array_equal(tgot["trajectory.png"], jgot["trajectory.png"])
    for name in ("points.bin", "scene.json", "status.json", "index.html"):
        tb, jb = (tmp_path / d / "gui" / name for d in ("t", "j"))
        if name == "index.html":
            assert "4DGS-SLAM" in tb.read_text()
            continue
        if name == "points.bin":
            np.testing.assert_array_equal(np.fromfile(tb, np.float32),
                                          np.fromfile(jb, np.float32))
        else:
            assert json.loads(tb.read_text()) == json.loads(jb.read_text())
    for name in ("current.png", "novel.png", "depth.png", "trajectory.png"):
        assert (tmp_path / "t" / "gui" / name).exists()


# ---- the runner's hook


def test_runner_drives_the_viewer(tmp_path, monkeypatch):
    from fourdgs_torch.slam.runner import SLAM
    from fourdgs_torch.utils.config import ConfigDict
    from tests.test_torch_cli import _config

    port = _free_port()
    cfg = _config("", str(tmp_path / "results"), dynamic_model=False)
    cfg["Dataset"] = {"type": "synthetic", "sensor_type": "depth", "num_frames": 3,
                      "points_per_wall": 600, "Calibration": cfg["Dataset"]["Calibration"]}
    cfg["Dataset"]["Calibration"]["depth_scale"] = 1.0
    cfg["Results"].update(use_gui=True, gui_port=port)
    cfg["Training"].update(init_itr_num=3, tracking_itr_num=3, mapping_itr_num=2,
                           keyframe_mapping_iters=2)
    # the viewer renders every second frame: frame 2 of frames 0-2
    slam = SLAM(ConfigDict.wrap(cfg), save_dir=str(tmp_path / "run"), save_interval=2,
                device="cpu", capacity=4096)
    seen = {}
    update = tv.LiveViewer.maybe_update

    def spy(view, s, idx):
        snap = update(view, s, idx)
        seen.setdefault("frames", []).append(idx)
        if snap is not None:
            seen.setdefault("updates", []).append(snap.frame_idx)
        if idx == 1:
            # pause over HTTP: the runner must not track frame 2 until resume
            assert _get(port, "cmd=pause")["paused"] is True

            def resumer():
                time.sleep(0.5)
                with open(os.path.join(view.dir, "status.json")) as f:
                    seen["status_paused"] = json.load(f)
                seen["held"] = 2 not in s.poses_est and view.paused
                seen["resumed"] = _get(port, "cmd=resume")["paused"] is False

            seen["thread"] = threading.Thread(target=resumer, daemon=True)
            seen["thread"].start()
        return snap

    monkeypatch.setattr(tv.LiveViewer, "maybe_update", spy)
    slam.run()
    seen["thread"].join(timeout=5)
    assert seen["frames"] == [1, 2] and seen["updates"] == [2]
    assert seen["held"] and seen["resumed"]
    assert seen["status_paused"]["paused"] is True and seen["status_paused"]["frame"] == 0
    gui = tmp_path / "run" / "gui"
    for name in ("index.html", "current.png", "novel.png", "depth.png", "trajectory.png",
                 "points.bin", "scene.json"):
        assert (gui / name).exists(), name
    status = json.loads((gui / "status.json").read_text())
    assert status["frame"] == 2 and status["paused"] is False and status["n"] > 0
    # the viewer closed with the run: nothing listens on its port, and a
    # new viewer can serve on it
    assert slam.viewer is None
    with pytest.raises(ConnectionRefusedError):
        socket.create_connection(("127.0.0.1", port), timeout=5).close()
    tv.LiveViewer(str(tmp_path / "again"), serve_port=port).close()
