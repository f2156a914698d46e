"""The learned segmenter end to end: both packages' command lines
(`slam.main` of the JAX package, `fourdgs_torch.cli.main --device cpu`)
with `--dynamic` on a 128x96 dynamic synthetic sequence in TUM layout,
with the same seeded YOLOv9-seg weights as `pretrained/yolov9e-seg.npz` in
the working directory: each runner takes its `Yolov9SegSegmenter`, and
the geometric segmenter's `pose_provider` is not set on it.

The weights are a tiny layer list (that of tests/test_yolov9_parity.py's
full-model test) at the 640x640 letterbox the configs run; the person
class's output convolution on the first level is planted (one input
channel's weight and the bias) so that each frame gives a few well-separated
detections: `test_planted_detections_are_well_conditioned` holds, on the
reference's outputs, that no decision of the post-processing lies within
rounding of its threshold. The same post-processing on the 25,600 tied
candidates of a uniform person bias is held bit for bit on shared
forward outputs. Held: every frame's dynamic mask equal between
the packages, every pixel, some frames with dynamic pixels and none all
dynamic; keyframes equal and each camera centre within 5e-3 m of the
reference's, as tests/test_torch_slam_flow.py holds the 4D path (the
deformation starts at dystart 2 on the segmented pixels). The run's
camera learning rates are a tenth of that file's (`CONDITIONING`): at
its own, the reference moved its camera centres by up to 9 mm when fx
moved by 2 float32 ulps, so the gate's verdict lay within rounding;
`test_reference_is_well_conditioned` holds that spread under 0.5 mm. The
port's runner replays the reference's draws (`JaxDraws`). On both recorded
layouts (TUM and CoFusion) the runner takes the YOLOv9 segmenter when the
weights are in `pretrained/`, and the geometric one, fed its tracked-pose
prediction, when they are not."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.perception import yolov9 as JY
from fourdgs.perception.segmentation import Yolov9SegSegmenter as JYolov9SegSegmenter
from fourdgs.slam import runner as jrunner
from fourdgs_torch import cli, convert
from fourdgs_torch.data.synthetic import (
    SyntheticDataset,
    write_cofusion_format,
    write_tum_format,
)
from fourdgs_torch.perception import yolov9 as Y
from fourdgs_torch.perception.segmentation import MotionSegmenter, Yolov9SegSegmenter
from fourdgs_torch.perception.weights_io import save_pytree_npz
from fourdgs_torch.slam import runner as trunner
from fourdgs_torch.utils.config import ConfigDict
from tests.test_torch_cli import _recording
from tests.test_torch_slam import JaxDraws, one_torch_thread  # noqa: F401
from tests.test_torch_slam_flow import _calibration, _config
from tests.test_torch_yolov9 import TINY_FULL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
# the person class (0) on the first level: its output convolution
# model.13.cv3.0.2 reads input channel PERSON_CHANNEL alone, with weight
# PERSON_WEIGHT and bias PERSON_BIAS. Chosen from the reference's outputs on
# the N frames: three candidates per frame (anchors of the leftmost column,
# two of them in the letterbox's padding), two kept, scores 2.8e-4 or more
# from conf and 4.2e-4 or more apart, box edges 0.02 px or more from an
# integer (the guard below holds it); the masks cover a band at the
# frame's left edge, 10% of its pixels (the seeded network's first-level
# features barely respond to the moving blob, so no detection is on it)
PERSON_CHANNEL, PERSON_WEIGHT, PERSON_BIAS = 3, 130.0, -14.93
TIED_BIAS = 0.0   # every first-level anchor a person candidate, scores tied within ulps
CONF, MAX_DET = 0.25, 100   # Yolov9SegSegmenter's conf, nms_numpy's max_det
# the run's training overrides: camera learning rates a tenth of
# tests/test_torch_slam_flow.py's. At those, frames 2 and 3 (the 4D phase
# at dystart, which steps frame 2's pose, and the frame tracked after it)
# were chaotic in the reference itself: fx moved by 2 float32 ulps moved
# its camera centres by up to 9 mm, against the 5 mm gate below. The
# guard `test_reference_is_well_conditioned` holds the spread under a
# tenth of the gate.
CONDITIONING = {"lr": {"cam_rot_delta": 0.0003, "cam_trans_delta": 0.0001}}
FX_NUDGE = 1 + 2.4e-7   # fx moved by 2 float32 ulps


def _params(planted: bool) -> dict:
    """The seeded tiny weights, with the person class planted, or (not
    `planted`) with its first-level bias at TIED_BIAS."""
    net = Y.init_weights(Y.Yolov9SegNet(TINY_FULL), torch.Generator().manual_seed(0))
    params = convert.yolo_params(net)
    if planted:
        w = params["model.13.cv3.0.2.weight"]
        w[0] = 0.0
        w[0, PERSON_CHANNEL] = PERSON_WEIGHT
        params["model.13.cv3.0.2.bias"][0] = PERSON_BIAS
    else:
        params["model.13.cv3.0.2.bias"][0] = TIED_BIAS
    return params


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, one_torch_thread):  # noqa: F811
    """A working directory with the sequence (`seq/`, TUM layout) and
    `pretrained/yolov9e-seg.npz` (seeded, the person bias planted), and the
    configuration of the run."""
    root = tmp_path_factory.mktemp("yolo_route")
    syn = ConfigDict.wrap({"Dataset": {
        "type": "synthetic", "sensor_type": "depth", "num_frames": N, "dynamic": True,
        "points_per_wall": 1500, "Calibration": {**_calibration(), "depth_scale": 1.0}}})
    synthetic = SyntheticDataset(None, "", syn, device="cpu")
    write_tum_format(synthetic, str(root / "seq"), depth_scale=5000.0)
    write_cofusion_format(synthetic, str(root / "seq_cofusion"), depth_scale=5000.0)
    params = _params(planted=True)
    os.makedirs(root / "pretrained")
    save_pytree_npz(str(root / "pretrained" / "yolov9e-seg.npz"), params,
                    meta={"cfg": TINY_FULL})
    cfg = _config(str(root / "seq"), **CONDITIONING)
    cfg["Dataset"]["type"] = "tum"
    cfg["Results"]["save_dir"] = str(root / "results")
    with open(root / "tum_yolo.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    cfg["Dataset"]["Calibration"]["fx"] *= FX_NUDGE
    cfg["Results"]["save_dir"] = str(root / "results_nudged")
    with open(root / "tum_yolo_nudged.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return root


def _reference_run(workdir, config: str):
    """The reference's command line with `--dynamic` on `config` in the
    working directory; its runner."""
    sys.path.insert(0, ROOT)
    import slam as jslam_cli

    argv = ["--config", str(workdir / config), "--dynamic", "--max-frames", str(N),
            "--capacity", "4096"]
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        mp.setenv("HOME", str(workdir))
        mp.setenv("FOURDGS_NO_COMPILE_CACHE", "1")
        made = _recording(jrunner, mp, raster=JRasterConfig(
            use_oracle=False, tile_cap=512, max_pairs=1 << 15))
        jslam_cli.main(argv)
    (jslam,) = made
    return jslam


@pytest.fixture(scope="module")
def runs(workdir):
    """The reference's command line and the port's, in the working
    directory (where both find pretrained/)."""
    jslam = _reference_run(workdir, "tum_yolo.yaml")
    argv = ["--config", str(workdir / "tum_yolo.yaml"), "--dynamic", "--max-frames", str(N),
            "--capacity", "4096", "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        mp.setenv("HOME", str(workdir))
        mp.setattr(trunner, "TorchDraws", lambda seed, device: JaxDraws(seed))
        t_made = _recording(trunner, mp)
        cli.main(argv)
    (tslam,) = t_made
    return tslam, jslam


def _frames(workdir) -> list:
    """The sequence's N frames as the segmenters see them: (3, H, W) in [0, 1]
    from the 8-bit PNGs."""
    from PIL import Image

    paths = sorted((workdir / "seq" / "rgb").glob("*.png"))
    assert len(paths) == N
    return [np.array(Image.open(p))[..., :3].astype(np.float32).transpose(2, 0, 1) / 255.0
            for p in paths]


def _reference_outputs(model, chw):
    """The reference's letterbox and forward of one frame: (boxes, scores,
    coefficients, prototypes) of the one image as numpy, and (r, dx, dy)."""
    lb, r, (dx, dy) = JY.letterbox(chw, model.imgsz)
    outs = [np.asarray(o[0]) for o in model.forward(model.params, lb[None])]
    return outs, (r, dx, dy)


def test_planted_detections_are_well_conditioned(workdir):
    """On the reference's outputs for every frame, no decision of the
    post-processing lies within rounding of its threshold: fewer candidates
    than max_det (NMS keeps them all in reach), every first-level person
    score at least 1e-4 from conf and, where it is a candidate, from the
    other classes' scores and from every other candidate's score (the NMS
    order), and every kept box's edge in frame pixels at least 1e-3 from an
    integer (where `int()` crops). The two forwards differ by about 1.2e-7
    in scores, so these margins are some thousand times that."""
    params = {k: jnp.asarray(v) for k, v in _params(planted=True).items()}
    model = JY.Yolov9Seg(TINY_FULL, params)
    kept_any = []
    for chw in _frames(workdir):
        (boxes, scores, _, _), (r, dx, dy) = _reference_outputs(model, chw)
        cls_id, cls_sc = scores.argmax(1), scores.max(1)
        cand = np.nonzero((cls_sc >= CONF) & (cls_id == 0))[0]
        assert 0 < len(cand) < MAX_DET
        assert np.abs(scores[:, 0] - CONF).min() >= 1e-4
        others = np.max(scores[cand, 1:], axis=1)
        assert np.all(scores[cand, 0] - others >= 1e-4)
        assert np.diff(np.sort(scores[cand, 0])).min(initial=1.0) >= 1e-4
        keep = cand[JY.nms_numpy(boxes[cand], cls_sc[cand], 0.45)]
        edges = np.concatenate([(boxes[keep][:, [0, 2]] - dx) / r,
                                (boxes[keep][:, [1, 3]] - dy) / r], 1)
        assert np.abs(edges - np.round(edges)).min() >= 1e-3
        kept_any.append(len(keep))
    assert min(kept_any) > 0, kept_any


def test_postprocessing_equals_reference_on_shared_outputs(workdir):
    """The 25,600-candidate tie of a uniform first-level person bias: the
    port's `Yolov9Seg.segment` given the reference's own forward outputs
    (its `outputs` patched here) gives the reference's masks on every pixel
    of every frame. Both sides then sort and suppress the same numbers, so
    the masks are equal bit for bit, ties included."""
    params = _params(planted=False)
    jmodel = JY.Yolov9Seg(TINY_FULL, {k: jnp.asarray(v) for k, v in params.items()})
    tmodel = Y.Yolov9Seg(TINY_FULL, params, device="cpu")
    n_cand = []
    for chw in _frames(workdir):
        outs, _ = _reference_outputs(jmodel, chw)
        n_cand.append(int(((outs[1].max(1) >= CONF) & (outs[1].argmax(1) == 0)).sum()))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmodel, "outputs", lambda lb, o=outs: o)
            got = tmodel.segment(chw, [0], conf=CONF)
        want = jmodel.segment(chw, [0], conf=CONF)
        np.testing.assert_array_equal(got, want)
        assert want.any()
    assert min(n_cand) >= 160 * 160, n_cand


def _centre(T):
    T = np.asarray(T, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def test_both_runners_take_the_yolo_segmenter(runs):
    tslam, jslam = runs
    assert isinstance(tslam.dataset.mask_fn, Yolov9SegSegmenter)
    assert isinstance(jslam.dataset.mask_fn, JYolov9SegSegmenter)
    assert not hasattr(tslam.dataset.mask_fn, "pose_provider")
    assert tslam.dataset.mask_fn.classes == jslam.dataset.mask_fn.classes == [0]
    assert tslam.dataset.mask_fn.model.imgsz == 640


def test_dynamic_masks_equal_reference(runs):
    tslam, jslam = runs
    t_masks, j_masks = tslam.dataset.dynamic_masks, jslam.dataset._mask_cache
    assert sorted(t_masks) == sorted(j_masks) == list(range(N))
    for i in range(N):
        np.testing.assert_array_equal(t_masks[i], j_masks[i])
    shares = [float(t_masks[i].mean()) for i in range(N)]
    assert max(shares) > 0 and min(shares) < 1, shares


def test_cameras_match_reference(runs):
    tslam, jslam = runs
    assert tslam.kf_indices == jslam.kf_indices == [0, 2]
    assert tslam.deform_init and jslam.deform_init
    assert sorted(tslam.poses_est) == sorted(jslam.poses_est) == list(range(N))
    for i in range(N):
        err = np.linalg.norm(_centre(tslam.poses_est[i]) - _centre(jslam.poses_est[i]))
        assert err < 5e-3, (i, err)


def test_reference_is_well_conditioned(workdir, runs):
    """The guard of `test_cameras_match_reference`: the reference's run with
    fx moved by 2 float32 ulps keeps every camera centre within 0.5 mm of
    its run, a tenth of that test's gate. Where this fails, the run's
    verdict lies within the reference's rounding again."""
    _, jslam = runs
    nudged = _reference_run(workdir, "tum_yolo_nudged.yaml")
    assert nudged.kf_indices == jslam.kf_indices
    for i in range(N):
        err = np.linalg.norm(_centre(nudged.poses_est[i]) - _centre(jslam.poses_est[i]))
        assert err < 5e-4, (i, err)


@pytest.mark.parametrize("weights", [True, False], ids=["weights", "no_weights"])
@pytest.mark.parametrize("layout", ["tum", "CoFusion"])
def test_runner_segmenter_on_recorded_layouts(workdir, tmp_path, monkeypatch, layout, weights):
    """SLAM(dynamic=True) as `--dynamic` makes it, on each recorded layout."""
    monkeypatch.chdir(workdir if weights else tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))   # no ~/.cache/fourdgs flow weights
    cfg = _config(str(workdir / ("seq" if layout == "tum" else "seq_cofusion")))
    cfg["Dataset"]["type"] = layout
    slam = trunner.SLAM(ConfigDict.wrap(cfg), dynamic=True, capacity=4096, device="cpu")
    seg = slam.dataset.mask_fn
    if weights:
        assert isinstance(seg, Yolov9SegSegmenter) and not hasattr(seg, "pose_provider")
        assert slam.dataset[1][3].shape == (96, 128)
    else:
        assert isinstance(seg, MotionSegmenter) and seg.pose_provider == slam._predict_pose
