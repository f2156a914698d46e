"""The recorded-sequence loaders of the port against the JAX package's, on
sequences laid out in the test: TUM layout written by each package's
`write_tum_format` and read by both loaders (images and depths exactly
equal, poses within 1e-6), timestamp association with dropped and
jittered entries and frame-rate thinning, the CoFusion layout with PNG
depth, ground-truth masks and a start/end window, and the undistortion of
the Bonn configs (OpenCV's map and remap in both packages: the images are
held exactly equal, and the maps within 1e-3 px)."""

import os

import numpy as np
import pytest
from PIL import Image

from fourdgs.data import load_dataset as j_load_dataset
from fourdgs.data.synthetic import SyntheticDataset as JSynthetic
from fourdgs.data.synthetic import write_tum_format as j_write_tum
from fourdgs.data.tum import TUMParser as JTUMParser
from fourdgs_torch.data import load_dataset
from fourdgs_torch.data.synthetic import SyntheticDataset as TSynthetic
from fourdgs_torch.data.synthetic import write_tum_format
from fourdgs_torch.data.tum import TUMParser
from fourdgs_torch.utils.config import ConfigDict
from tests.test_torch_slam import one_torch_thread  # noqa: F401

W, H = 64, 48


def _calib(**extra):
    return {"fx": 60.0, "fy": 60.0, "cx": (W - 1) / 2, "cy": (H - 1) / 2, "width": W,
            "height": H, "depth_scale": 5000.0, "distorted": False, **extra}


def _cfg(dtype, path, **calib):
    return ConfigDict.wrap({"Dataset": {"type": dtype, "sensor_type": "depth",
                                        "dataset_path": path, "Calibration": _calib(**calib)}})


def _both(dtype, path, **calib):
    cfg = _cfg(dtype, path, **calib)
    return j_load_dataset(None, path, cfg), load_dataset(None, path, cfg, device="cpu")


def _assert_same_frames(jds, tds, pose_atol=0.0):
    assert len(tds) == len(jds) > 0
    for i in range(len(jds)):
        ji, jdep, jT, jm = jds[i]
        ti, tdep, tT, tm = tds[i]
        np.testing.assert_array_equal(ti, ji)
        assert ti.dtype == np.float32 and tdep.dtype == np.float32
        np.testing.assert_array_equal(tdep, jdep)
        np.testing.assert_allclose(tT, jT, atol=pose_atol, rtol=0)
        np.testing.assert_array_equal(tm, jm)


@pytest.fixture(scope="module")
def tum_layouts(tmp_path_factory, one_torch_thread):  # noqa: F811
    """A 3-frame dynamic synthetic sequence written in TUM layout by each
    package (each from its own renderer), and the port's dataset."""
    syn = {"Dataset": {"type": "synthetic", "num_frames": 3, "points_per_wall": 300,
                       "dynamic": True, "Calibration": _calib(depth_scale=1.0)}}
    root = tmp_path_factory.mktemp("tum")
    tsyn = TSynthetic(None, "", ConfigDict.wrap(syn), "cpu")
    write_tum_format(tsyn, str(root / "port"))
    j_write_tum(JSynthetic(None, "", syn), str(root / "jax"))
    return root, tsyn


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tum_layout_reads_alike(tum_layouts, writer):
    root, _ = tum_layouts
    jds, tds = _both("tum", str(root / writer))
    _assert_same_frames(jds, tds, pose_atol=1e-6)
    assert tds.color_paths == jds.color_paths and tds.tstamps == jds.tstamps


def test_tum_writer_round_trip(tum_layouts):
    # the port's layout holds its sequence: colour to 1/255, depth to one
    # 16-bit step at depth_scale 5000, poses to the 6 written decimals
    root, tsyn = tum_layouts
    tds = load_dataset(None, str(root / "port"), _cfg("tum", str(root / "port")), device="cpu")
    for i in range(len(tsyn)):
        img, depth, T, _ = tsyn[i]
        ti, tdep, tT, _ = tds[i]
        assert np.abs(ti - img).max() <= 1.0 / 255 + 1e-6
        assert np.abs(tdep - depth).max() <= 1.0 / 5000 + 1e-6
        np.testing.assert_allclose(tT, T, atol=1e-5)
    # both writers give one file set, and the same trajectory to 1e-6
    for name in ("rgb.txt", "depth.txt"):
        assert (root / "port" / name).read_text() == (root / "jax" / name).read_text()
    tp = np.loadtxt(root / "port" / "groundtruth.txt")
    jp = np.loadtxt(root / "jax" / "groundtruth.txt")
    np.testing.assert_allclose(tp, jp, atol=1e-6)


def _write_lists(folder, rng, n=12, drop=(3, 7), jitter=0.02, pose_name="groundtruth.txt"):
    """rgb/depth/pose lists at 30 Hz with dropped depth entries, jittered
    depth and pose timestamps and a pose stream at 100 Hz."""
    os.makedirs(folder, exist_ok=True)
    t = 1305031102.0 + np.arange(n) / 30.0
    rgb = ["# color images", "# file: 'rgbd_dataset'", "# timestamp filename"]
    rgb += [f"{ti:.6f} rgb/{ti:.6f}.png" for ti in t]
    depth = ["# depth maps", "# file: 'rgbd_dataset'", "# timestamp filename"]
    depth += [f"{ti + jitter * rng.uniform(-1, 1):.6f} depth/{i:03d}.png"
              for i, ti in enumerate(t) if i not in drop]
    tp = 1305031101.9 + np.arange(int(n * 100 / 30) + 30) / 100.0
    poses = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    for ti in tp:
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        tr = rng.normal(size=3)
        poses.append(f"{ti + 0.002 * rng.uniform(-1, 1):.6f} "
                     + " ".join(f"{v:.6f}" for v in (*tr, *q)))
    for name, lines in (("rgb.txt", rgb), ("depth.txt", depth), (pose_name, poses)):
        with open(os.path.join(folder, name), "w") as f:
            f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("jitter,frame_rate,pose_name", [
    (0.02, 32, "groundtruth.txt"),   # jitter inside the 0.08 s window
    (0.1, 32, "groundtruth.txt"),    # some depth partners too far: dropped
    (0.0, 10, "pose.txt"),           # thinned to 10 Hz, the Bonn pose file name
])
def test_association_matches_jax(tmp_path, jitter, frame_rate, pose_name):
    rng = np.random.default_rng(0)
    _write_lists(str(tmp_path), rng, jitter=jitter, pose_name=pose_name)
    tp, jp = TUMParser(str(tmp_path), frame_rate), JTUMParser(str(tmp_path), frame_rate)
    assert tp.n_img == jp.n_img > 0
    assert tp.color_paths == jp.color_paths and tp.depth_paths == jp.depth_paths
    assert tp.tstamps == jp.tstamps
    for a, b in zip(tp.poses, jp.poses):
        np.testing.assert_array_equal(a, b)
    if frame_rate == 10:
        assert tp.n_img < 12 - 2
    # a dropped depth frame's image is matched to a neighbour's depth
    assert len(set(tp.depth_paths)) <= tp.n_img


def _write_cofusion(folder, rng, n=5):
    for sub in ("colour", "depth", "mask_colour", "trajectories"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    lines = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (H, W, 3), np.uint8)).save(
            os.path.join(folder, "colour", f"Color{i:04d}.png"))
        Image.fromarray(rng.integers(500, 20000, (H, W)).astype(np.uint16)).save(
            os.path.join(folder, "depth", f"Depth{i:04d}.png"))
        mask = np.zeros((H, W, 3), np.uint8)
        mask[10 + i:20 + i, 5:25] = (200, 40, 10)
        mask[30, 40] = (1, 1, 1)   # below 1% of 255 in grey: static
        Image.fromarray(mask).save(os.path.join(folder, "mask_colour", f"Mask{i:04d}.png"))
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        lines.append(f"{i} " + " ".join(f"{v:.6f}" for v in (*rng.normal(size=3), *q)))
    with open(os.path.join(folder, "trajectories", "gt-cam-0.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("start,end", [(0, -1), (1, 4)])
def test_cofusion_layout_reads_alike(tmp_path, start, end):
    _write_cofusion(str(tmp_path), np.random.default_rng(1))
    jds, tds = _both("CoFusion", str(tmp_path), depth_scale=1000.0, start=start, end=end)
    _assert_same_frames(jds, tds)
    assert len(tds) == (5 if end == -1 else end - start)
    masked = [(~tds[i][3]).sum() for i in range(len(tds))]
    assert all(m == 200 for m in masked), masked


@pytest.mark.parametrize("name", ["ballon", "placing_box"])
def test_undistortion_matches_jax(tum_layouts, name):
    # the Bonn calibration (distorted: true) scaled to 64x48
    from fourdgs.utils.config import load_config

    root, _ = tum_layouts
    c = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "rgbd", "bonn",
                                 f"{name}.yaml"))["Dataset"]["Calibration"]
    s = W / c["width"]
    calib = dict(fx=c["fx"] * s, fy=c["fy"] * s, cx=c["cx"] * s, cy=c["cy"] * s,
                 distorted=True, **{k: c[k] for k in ("k1", "k2", "p1", "p2", "k3")})
    path = str(root / "port")
    jds, tds = _both("tum", path, **calib)
    np.testing.assert_allclose(tds.map1x, jds.map1x, atol=1e-3, rtol=0)
    np.testing.assert_allclose(tds.map1y, jds.map1y, atol=1e-3, rtol=0)
    _assert_same_frames(jds, tds)
    # undistortion moves pixels: the image differs from the raw one
    _, raw = _both("tum", path, **dict(calib, distorted=False))
    assert np.abs(tds[0][0] - raw[0][0]).max() > 0.05


def test_without_depth_sensor_and_realsense(tum_layouts):
    root, _ = tum_layouts
    cfg = _cfg("tum", str(root / "port"))
    cfg["Dataset"]["sensor_type"] = "rgb"
    assert load_dataset(None, str(root / "port"), cfg, device="cpu")[0][1] is None
    cfg["Dataset"]["type"] = "realsense"
    with pytest.raises(ValueError, match="not ported yet"):
        load_dataset(None, "", cfg, device="cpu")
