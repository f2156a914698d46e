"""The live RealSense dataset of the port (fourdgs_torch/data/realsense.py)
against the reference's, both driven by a stub `pyrealsense2` in
sys.modules: a pipeline serving seeded 1280x720 BGR and depth frames with
fake intrinsics, distortion and depth scale. The frames (image, depth,
pose, motion mask from the same mask function) are exactly equal. Then
the two departures (ROADMAP §3): the port's runner takes the camera's
calibration where the reference's keeps the YAML's, and the port hands
`cv2.remap` a contiguous image where the reference hands it a
negative-stride view. Without the package both raise RuntimeError."""

import sys
import types

import numpy as np
import pytest

from fourdgs.data import load_dataset as j_load_dataset
from fourdgs_torch.data import load_dataset
from fourdgs_torch.data import realsense as trs
from fourdgs_torch.utils.config import ConfigDict
from tests.test_torch_slam import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H = 1280, 720
FX, FY, PPX, PPY = 912.5, 910.25, 641.3, 362.7     # the camera's, not the YAML's
COEFFS = [0.05, -0.08, 0.001, -0.0005, 0.02]
DEPTH_SCALE = 0.001


class _Frame:
    def __init__(self, data):
        self._data = data

    def get_data(self):
        return self._data


class _Frameset:
    def __init__(self, color, depth):
        self._color, self._depth = color, depth

    def get_color_frame(self):
        return _Frame(self._color)

    def get_depth_frame(self):
        return _Frame(self._depth)


class _Sensor:
    def __init__(self, log):
        self.log = log

    def set_option(self, option, value):
        self.log.append((option, value))

    def get_depth_scale(self):
        return DEPTH_SCALE


class _Device:
    def __init__(self, log):
        self.log = log

    def query_sensors(self):
        return [_Sensor(self.log), _Sensor(self.log)]

    def first_depth_sensor(self):
        return _Sensor(self.log)


class _Profile:
    def __init__(self):
        self.options = []

    def get_device(self):
        return _Device(self.options)

    def get_stream(self, stream):
        return stream


def stub_frame(i: int):
    """Frame i: a seeded BGR image with a gradient and a depth map in
    device units with holes."""
    rng = np.random.default_rng(100 + i)
    yy, xx = np.mgrid[0:H, 0:W]
    bgr = np.stack([(xx * 255 // W), (yy * 255 // H), np.full_like(xx, 40 * i)], -1)
    bgr = np.clip(bgr + rng.integers(-20, 20, bgr.shape), 0, 255).astype(np.uint8)
    depth = rng.integers(500, 4000, (H, W)).astype(np.uint16)
    depth[rng.uniform(size=(H, W)) < 0.05] = 0
    return bgr, depth


def make_stub():
    """A pyrealsense2 module whose pipeline serves `stub_frame(0)`,
    `stub_frame(1)`, ... in order."""
    rs = types.ModuleType("pyrealsense2")
    rs.stream = types.SimpleNamespace(color="color", depth="depth")
    rs.format = types.SimpleNamespace(bgr8="bgr8")
    rs.option = types.SimpleNamespace(enable_auto_exposure="ae", enable_auto_white_balance="awb",
                                      exposure="exposure")

    class config:
        def __init__(self):
            self.streams = []

        def enable_stream(self, *args):
            self.streams.append(args)

    class pipeline:
        def __init__(self):
            self.served = 0
            self.stopped = False

        def start(self, cfg):
            self.cfg = cfg
            self.profile = _Profile()
            return self.profile

        def wait_for_frames(self):
            bgr, depth = stub_frame(self.served)
            self.served += 1
            return _Frameset(bgr, depth)

        def stop(self):
            self.stopped = True

    class align:
        def __init__(self, stream):
            assert stream == "color"

        def process(self, frameset):
            return frameset

    class video_stream_profile:
        def __init__(self, stream):
            assert stream == "color"

        def get_intrinsics(self):
            return types.SimpleNamespace(fx=FX, fy=FY, ppx=PPX, ppy=PPY, width=W, height=H,
                                         coeffs=list(COEFFS))

    rs.config, rs.pipeline, rs.align = config, pipeline, align
    rs.video_stream_profile = video_stream_profile
    return rs


def _cfg(sensor="depth"):
    # the YAML's calibration, which the camera's replaces
    return ConfigDict.wrap({
        "Dataset": {"type": "realsense", "sensor_type": sensor, "num_frames": 3,
                    "Calibration": {"fx": 600.0, "fy": 600.0, "cx": 639.5, "cy": 359.5,
                                    "width": W, "height": H, "depth_scale": 1.0,
                                    "distorted": False}},
        "Training": {"lr": {"cam_rot_delta": 0.003, "cam_trans_delta": 0.001}},
    })


def _bright_green_mask(img, depth):
    # dynamic where green is bright: the image's lower rows
    return img[..., 1] > 200


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyrealsense2", make_stub())


@pytest.mark.parametrize("sensor", ["depth", "rgb"])
def test_frames_match_reference(stub, sensor):
    jds = j_load_dataset(None, "", _cfg(sensor))
    tds = load_dataset(None, "", _cfg(sensor), device="cpu")
    jds.mask_fn = tds.mask_fn = _bright_green_mask
    assert len(tds) == len(jds) == 3
    for name in ("fx", "fy", "cx", "cy", "width", "height", "depth_scale"):
        assert getattr(tds, name) == getattr(jds, name), name
    np.testing.assert_array_equal(tds.map1x, jds.map1x)
    np.testing.assert_array_equal(tds.map1y, jds.map1y)
    for i in range(3):
        ji, jdep, jT, jm = jds[i]
        ti, tdep, tT, tm = tds[i]
        assert ti.shape == (3, H, W) and ti.dtype == np.float32
        np.testing.assert_array_equal(ti, ji)
        if sensor == "depth":
            assert tdep.dtype == np.float32 and (tdep == 0).any()
            np.testing.assert_array_equal(tdep, jdep)
        else:
            assert tdep is None and jdep is None
        np.testing.assert_array_equal(tT, jT)
        np.testing.assert_array_equal(tm, jm)
        assert 0 < (~tm).sum() < tm.size
    # exposure and white balance fixed on the colour sensor
    opts = tds.profile.options
    assert ("ae", False) in opts and ("awb", False) in opts and ("exposure", 200) in opts
    tds.stop()
    assert tds.pipeline.stopped


def test_departure_runner_takes_the_camera_calibration(stub):
    # the reference's runner keeps the YAML's intrinsics although the
    # dataset carries the camera's; the port's takes the camera's
    from fourdgs.slam.runner import SLAM as JSLAM
    from fourdgs_torch.slam.runner import SLAM

    slam = SLAM(_cfg(), device="cpu", capacity=64, max_capacity=64, max_keyframes=1)
    assert (slam.intr.fx, slam.intr.fy, slam.intr.cx, slam.intr.cy) == (FX, FY, PPX, PPY)
    assert (slam.intr.width, slam.intr.height) == (W, H)
    jslam = JSLAM(_cfg(), capacity=64, max_capacity=64, max_keyframes=1)
    assert (jslam.dataset.fx, jslam.dataset.cx) == (FX, PPX)
    assert (jslam.intr.fx, jslam.intr.cx) == (600.0, 639.5)


def test_departure_remap_gets_a_contiguous_image(stub, monkeypatch):
    import cv2

    import fourdgs.data.realsense as jrs

    seen = {}

    def recording(key):
        def remap(src, *a, **k):
            seen[key] = src.strides
            assert key != "port" or src.flags["C_CONTIGUOUS"]
            return cv2.remap(src, *a, **k)
        return types.SimpleNamespace(remap=remap, INTER_LINEAR=cv2.INTER_LINEAR)

    jds = j_load_dataset(None, "", _cfg())
    tds = load_dataset(None, "", _cfg(), device="cpu")
    monkeypatch.setattr(jrs, "cv2", recording("reference"))
    monkeypatch.setattr(trs, "cv2", recording("port"))
    ji, tim = jds[0][0], tds[0][0]
    assert seen["reference"][-1] < 0 and seen["port"][-1] > 0
    # under this OpenCV the reference's view remaps to the same frame
    np.testing.assert_array_equal(tim, ji)


def test_without_pyrealsense2_both_raise(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyrealsense2", None)
    with pytest.raises(RuntimeError, match="needs pyrealsense2"):
        load_dataset(None, "", _cfg(), device="cpu")
    with pytest.raises(RuntimeError, match="needs pyrealsense2"):
        j_load_dataset(None, "", _cfg())
