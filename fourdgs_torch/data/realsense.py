"""Live Intel RealSense RGB-D capture (port of fourdgs/data/realsense.py).

The camera streams 1280x720 colour at 30 Hz, and depth aligned into the
colour frame. The device's calibration, read when the stream starts,
replaces the YAML's: the runner builds its intrinsics from this dataset
(`Intrinsics.from_dataset`), where the reference builds them from the YAML
before it opens the camera (ROADMAP §3). Colour is undistorted with the
device's coefficients; the BGR frame is flipped to RGB into a contiguous
copy before `cv2.remap` (the reference hands it a negative-stride view).
A live stream has no ground-truth pose: each frame's pose is the
identity.

Needs pyrealsense2 and a camera; without the package, construction raises
RuntimeError.
"""

from __future__ import annotations

import cv2
import numpy as np

from fourdgs_torch.data.base import BaseDataset


class RealsenseDataset(BaseDataset):
    def __init__(self, args, path, config):
        try:
            import pyrealsense2 as rs
        except ImportError as e:
            raise RuntimeError(
                "Realsense live capture needs pyrealsense2 and a camera; "
                "neither is available in this environment"
            ) from e

        super().__init__(args, path, config)
        self._rs = rs
        self.pipeline = rs.pipeline()
        self.w, self.h = 1280, 720
        self.rs_config = rs.config()
        self.rs_config.enable_stream(rs.stream.color, self.w, self.h, rs.format.bgr8, 30)
        if self.has_depth:
            self.rs_config.enable_stream(rs.stream.depth)
        self.profile = self.pipeline.start(self.rs_config)
        if self.has_depth:
            self.align = rs.align(rs.stream.color)

        # fixed exposure and white balance: the tracker's exposure terms
        # assume the sensor does not adapt as well
        rgb_sensor = self.profile.get_device().query_sensors()[1]
        rgb_sensor.set_option(rs.option.enable_auto_exposure, False)
        rgb_sensor.set_option(rs.option.enable_auto_white_balance, False)
        rgb_sensor.set_option(rs.option.exposure, 200)

        intr = rs.video_stream_profile(self.profile.get_stream(rs.stream.color)).get_intrinsics()
        self.fx, self.fy = intr.fx, intr.fy
        self.cx, self.cy = intr.ppx, intr.ppy
        self.width, self.height = intr.width, intr.height
        self.fovx = 2 * np.arctan(self.width / (2 * self.fx))
        self.fovy = 2 * np.arctan(self.height / (2 * self.fy))
        self.K = np.array([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]])
        self.dist_coeffs = np.asarray(intr.coeffs)
        self.distorted = True
        self.map1x, self.map1y = cv2.initUndistortRectifyMap(
            self.K, self.dist_coeffs, np.eye(3), self.K, (self.w, self.h), cv2.CV_32FC1)
        if self.has_depth:
            # device units -> metres
            self.depth_scale = float(self.profile.get_device().first_depth_sensor()
                                     .get_depth_scale())
        # a live stream's "length" is the run's frame budget
        self.num_imgs = int(config["Dataset"].get("num_frames", 10_000))

    def stop(self):
        self.pipeline.stop()

    def __getitem__(self, idx: int):
        frameset = self.pipeline.wait_for_frames()
        depth = None
        if self.has_depth:
            aligned = self.align.process(frameset)
            rgb_frame = aligned.get_color_frame()
            depth = np.asarray(aligned.get_depth_frame().get_data(), np.float32) * self.depth_scale
            depth[depth < 0] = 0
            np.nan_to_num(depth, nan=1000, copy=False)
        else:
            rgb_frame = frameset.get_color_frame()
        img = np.ascontiguousarray(np.asanyarray(rgb_frame.get_data())[..., ::-1])  # BGR -> RGB
        img = cv2.remap(img, self.map1x, self.map1y, cv2.INTER_LINEAR)
        image = np.clip(img.astype(np.float32) / 255.0, 0.0, 1.0).transpose(2, 0, 1)
        return image, depth, np.eye(4), ~self._dynamic_mask(idx, img, depth)
