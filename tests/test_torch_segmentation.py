"""The geometric motion segmenter of the port against the JAX package's:
fed the same frames and the same pose sequence, both give identical masks
(the port's runner feeds it deterministically, ROADMAP §3); its region
filter keeps 4-connected regions exactly as fourdgs/native's union-find
does; `make_segmenter` takes the geometric route only without YOLOv9
weights, and with them (a `.npz` beside the configured `.pt`, or the
`.pt` itself) the YOLOv9 segmenter; a corrupt weights file raises."""

import pickle

import numpy as np
import pytest
import torch

from fourdgs.native import region_filter as j_region_filter
from fourdgs.perception.segmentation import MotionSegmenter as JMotionSegmenter
from fourdgs.slam.camera import Intrinsics as JIntrinsics
from fourdgs_torch import convert
from fourdgs_torch.perception import yolov9 as Y
from fourdgs_torch.perception.segmentation import (
    MotionSegmenter,
    NullSegmenter,
    Yolov9SegSegmenter,
    make_segmenter,
    region_filter,
)
from fourdgs_torch.perception.weights_io import save_pytree_npz
from fourdgs_torch.slam.camera import Intrinsics

W, H = 96, 72
J_INTR = JIntrinsics(fx=60.0, fy=60.0, cx=(W - 1) / 2, cy=(H - 1) / 2, width=W, height=H)
T_INTR = Intrinsics(*J_INTR)


def _sequence(n=5):
    """Frames of a textured wall at 2 m seen by a camera sliding 1/30 m
    per frame (1 px at fx 60), with a dark 30x30 square moving 10 px per
    frame; and the poses."""
    v, u = np.mgrid[0:H, 0:W + 2 * n]
    wall = np.stack([128 + 90 * np.sin(u / 5.0), 128 + 90 * np.cos(v / 7.0),
                     128 + 60 * np.sin((u + v) / 9.0)], -1)
    frames, poses = [], []
    for i in range(n):
        img = wall[:, i:i + W].copy()
        img[20:50, 5 + 10 * i:35 + 10 * i] = (20, 20, 40)
        depth = np.full((H, W), 2.0, np.float32)
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -i * 2.0 / 60.0
        frames.append((img.astype(np.uint8), depth))
        poses.append(T)
    return frames, poses


@pytest.mark.parametrize("pose_noise", [0.0, 0.01])
def test_motion_masks_match_jax(pose_noise):
    frames, poses = _sequence()
    rng = np.random.default_rng(0)
    poses = [T + pose_noise * rng.normal(size=(4, 4)).astype(np.float32) * (np.arange(4) < 3)
             for T in poses]
    at = {"i": 0}
    tseg = MotionSegmenter(T_INTR, pose_provider=lambda: poses[at["i"]])
    jseg = JMotionSegmenter(J_INTR, pose_provider=lambda: poses[at["i"]])
    total = 0
    for i, (img, depth) in enumerate(frames):
        at["i"] = i
        tm, jm = tseg(img, depth), jseg(img, depth)
        np.testing.assert_array_equal(tm, jm)
        total += int(tm.sum())
        if i == 0:
            assert not tm.any()        # no previous frame yet
    assert total > 1000                # the moving square is found


def test_no_pose_provider_gives_empty_masks():
    (img, depth), = _sequence(1)[0]
    assert not MotionSegmenter(T_INTR)(img, depth).any()
    assert not NullSegmenter()(img, depth).any()


@pytest.mark.parametrize("density,min_region", [(0.45, 5), (0.55, 20), (0.6, 200)])
def test_region_filter_matches_native(density, min_region):
    mask = np.random.default_rng(int(density * 100)).uniform(size=(H, W)) < density
    got = region_filter(mask, min_region)
    np.testing.assert_array_equal(got, j_region_filter(mask, min_region))
    assert got.any() and (got != mask).any()


def test_region_filter_is_four_connected():
    # two 10x10 squares touching at one corner: two regions of 100
    mask = np.zeros((40, 40), bool)
    mask[0:10, 0:10] = True
    mask[10:20, 10:20] = True
    assert not region_filter(mask, 150).any()
    assert region_filter(mask, 100).sum() == 200
    np.testing.assert_array_equal(region_filter(mask, 150), j_region_filter(mask, 150))


TINY_SEG = {"nc": 2, "backbone": [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                                 [-1, 1, "ADown", [16]]],
            "head": [[[1, 2], 1, "Segment", [2, 4, 16]]]}


class _FakeUltralyticsModel(torch.nn.Module):
    """Stands in for the object an ultralytics `.pt` stores: `.yaml`,
    `.float()` and a state dict under `model.<i>.`, with the batch-norm
    step counts and the DFL's fixed weights such a checkpoint carries."""

    def __init__(self, cfg, net):
        super().__init__()
        self.yaml = cfg
        self.model = net.model

    def state_dict(self, *a, **k):
        sd = super().state_dict(*a, **k)
        sd["model.0.bn.num_batches_tracked"] = torch.tensor(0)
        sd["model.3.dfl.conv.weight"] = torch.arange(16.0).reshape(1, 16, 1, 1)
        return sd


@pytest.mark.parametrize("weights", ["npz", "pt", "corrupt"])
def test_make_segmenter_without_and_with_weights(tmp_path, weights):
    pt = tmp_path / "yolov9e-seg.pt"
    cfg = {"Dataset": {"yolo_weights": str(pt), "seg_chair": True}}
    seg = make_segmenter(cfg, T_INTR, "cpu")
    assert isinstance(seg, MotionSegmenter) and seg.pose_provider is None
    net = Y.init_weights(Y.Yolov9SegNet(TINY_SEG), torch.Generator().manual_seed(0))
    if weights == "corrupt":
        pt.write_bytes(b"weights")
        with pytest.raises(pickle.UnpicklingError):
            make_segmenter(cfg, T_INTR, "cpu")
        return
    if weights == "npz":     # found beside the configured .pt
        save_pytree_npz(str(tmp_path / "yolov9e-seg.npz"), convert.yolo_params(net),
                        meta={"cfg": TINY_SEG})
    else:
        torch.save({"model": _FakeUltralyticsModel(TINY_SEG, net)}, pt)
    seg = make_segmenter(cfg, T_INTR, "cpu")
    assert isinstance(seg, Yolov9SegSegmenter) and not hasattr(seg, "pose_provider")
    assert seg.classes == [0, 56] and seg.conf == 0.25
    assert seg.model.device.type == "cpu"
    for k, v in convert.yolo_params(net).items():
        np.testing.assert_array_equal(seg.model.net.state_dict()[k].numpy(), v)
    mask = seg(np.zeros((48, 60, 3), np.uint8), np.ones((48, 60), np.float32))
    assert mask.shape == (48, 60) and mask.dtype == bool


def test_yolo_segmenter_needs_a_card_or_cpu(tmp_path, monkeypatch):
    path = str(tmp_path / "yolov9e-seg.npz")
    net = Y.init_weights(Y.Yolov9SegNet(TINY_SEG), torch.Generator().manual_seed(0))
    save_pytree_npz(path, convert.yolo_params(net), meta={"cfg": TINY_SEG})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Yolov9SegSegmenter(path)
