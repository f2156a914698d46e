"""YOLOv9-seg of the port (fourdgs_torch/perception/yolov9.py) against the
JAX package's (fourdgs/perception/yolov9.py), on seeded weights carried
by `convert.yolo_params` and inputs made with numpy from a seed.

Held at the reference's own tolerance (`_cmp` of
tests/test_yolov9_parity.py: largest error over largest magnitude, 5e-4
as its head and full-model tests use): each primitive and the Segment
head; both tiny layer lists of the reference's tests and the published
YOLOv9e-seg list at full width (60.5 M parameters, on a 64x64 input,
the reference run without `jax.jit`) through the layer-list builder; a
`.npz` written by the reference's `save_pytree_npz`, with and without
the DFL's fixed weights. Held exactly: `yolo_params`/`yolo_state_dict`
both ways, `letterbox`, `_bilinear_sample` and `nms_numpy`, and
`Yolov9Seg.segment`'s masks on a tiny model, every pixel, at conf 0.0,
at 0.25 and with a planted class bias. With `pretrained/golden_yolov9.npz`
from scripts/convert_weights.py --yolo (real weights) the port matches
its activations; without the file that case skips."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.perception import weights_io as jio
from fourdgs.perception import yolov9 as y9
from fourdgs_torch import convert
from fourdgs_torch.perception import yolov9 as Y

GOLDEN_DIR = "pretrained"


def _cmp(t, j, tol=5e-4):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    err = np.abs(t - j).max() / max(np.abs(t).max(), 1e-6)
    assert err < tol, f"rel err {err}"


def _seeded(module, seed=0):
    return Y.init_weights(module, torch.Generator().manual_seed(seed)).eval()


def _params(module, prefix="model.0"):
    """The reference's flat dict (jnp leaves) of a port module at `prefix`."""
    return {f"{prefix}.{k}": jnp.asarray(v) for k, v in convert.yolo_params(module).items()}


def _x(c, h=16, w=20, seed=1):
    return np.random.default_rng(seed).normal(size=(1, c, h, w)).astype(np.float32)


def _port(module, *xs):
    with torch.no_grad():
        return module(*(torch.from_numpy(x) for x in xs))


PRIMITIVES = {
    "conv": (lambda: Y.Conv(8, 16, 3, 2), 8,
             lambda p, x: y9.conv_bn_act(p, "model.0", x, stride=2)),
    "conv_no_act": (lambda: Y.Conv(8, 16, 1, act=False), 8,
                    lambda p, x: y9.conv_bn_act(p, "model.0", x, act=False)),
    "rep_convn": (lambda: Y.RepConvN(8, 16), 8, lambda p, x: y9.rep_convn(p, "model.0", x)),
    "rep_n_bottleneck": (lambda: Y.RepNBottleneck(16, 16), 16,
                         lambda p, x: y9.rep_n_bottleneck(p, "model.0", x)),
    "rep_ncsp": (lambda: Y.RepNCSP(16, 12, 2), 16,
                 lambda p, x: y9.rep_ncsp(p, "model.0", x, n=2)),
    "rep_ncspelan4": (lambda: Y.RepNCSPELAN4(16, 32, 16, 8, n=2), 16,
                      lambda p, x: y9.rep_ncspelan4(p, "model.0", x, n=2)),
    "adown": (lambda: Y.ADown(16, 24), 16, lambda p, x: y9.adown(p, "model.0", x)),
    "sppelan": (lambda: Y.SPPELAN(16, 24, 8), 16, lambda p, x: y9.sppelan(p, "model.0", x)),
    "proto": (lambda: Y.Proto(16, 12, 8), 16, lambda p, x: y9.proto(p, "model.0", x)),
    "upsample": (Y.Upsample, 4, lambda p, x: y9.upsample2x(x)),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_matches_jax(name):
    make, c, ref = PRIMITIVES[name]
    m = _seeded(make())
    x = _x(c)
    _cmp(_port(m, x), ref(_params(m), jnp.asarray(x)))


def test_cblinear_matches_jax():
    m = _seeded(Y.CBLinear(16, [4, 8]))
    x = _x(16)
    outs = _port(m, x)
    refs = y9.cb_linear(_params(m), "model.0", jnp.asarray(x), [4, 8])
    assert len(outs) == len(refs) == 2
    for t, j in zip(outs, refs):
        _cmp(t, j)


@pytest.mark.parametrize("size", [(16, 20), (13, 7)])
def test_cbfuse_matches_jax(size):
    """Nearest resize by floor index, also at ratios that are not whole."""
    rng = np.random.default_rng(3)
    a = [rng.normal(size=(1, c, 8, 10)).astype(np.float32) for c in (4, 6)]
    b = [rng.normal(size=(1, c, 5, 3)).astype(np.float32) for c in (6, 4)]
    target = rng.normal(size=(1, 4, *size)).astype(np.float32)
    got = Y.CBFuse([0, 1])([[torch.from_numpy(t) for t in a], [torch.from_numpy(t) for t in b],
                            torch.from_numpy(target)])
    want = y9.cb_fuse([[jnp.asarray(t) for t in a], [jnp.asarray(t) for t in b],
                       jnp.asarray(target)], [0, 1])
    _cmp(got, want)


def test_segment_head_matches_jax():
    """Box, class and mask branches, prototypes, DFL decode and anchors on
    three feature levels."""
    chs = (16, 24, 32)
    m = _seeded(Y.Segment(5, 8, 16, list(chs)))
    rng = np.random.default_rng(4)
    feats = [rng.normal(size=(1, c, 16 // 2 ** i, 20 // 2 ** i)).astype(np.float32)
             for i, c in enumerate(chs)]
    with torch.no_grad():
        got = m([torch.from_numpy(f) for f in feats])
    want = y9.segment_head(_params(m, "model.9"), "model.9", [jnp.asarray(f) for f in feats],
                           nc=5, nm=8)
    for t, j in zip(got, want):
        _cmp(t, j)


# the layer lists of tests/test_yolov9_parity.py: test_tiny_full_model_via_cfg
# and _tiny_seg_model
TINY_FULL = {
    "nc": 3,
    "backbone": [
        [-1, 1, "Silence", []], [-1, 1, "Conv", [8, 3, 2]],
        [-1, 1, "RepNCSPELAN4", [16, 8, 4, 1]], [-1, 1, "ADown", [16]],
        [-1, 1, "RepNCSPELAN4", [24, 12, 6, 1]], [-1, 1, "ADown", [24]],
        [-1, 1, "SPPELAN", [24, 8]], [2, 1, "CBLinear", [[8]]], [0, 1, "Conv", [8, 3, 2]],
        [[7, 8], 1, "CBFuse", [[0]]],
    ],
    "head": [
        [6, 1, "nn.Upsample", [None, 2, "nearest"]], [[-1, 4], 1, "Concat", [1]],
        [-1, 1, "RepNCSPELAN4", [24, 12, 6, 1]], [[12, 6], 1, "Segment", [3, 8, 16]],
    ],
}
TINY_SEG = {
    "nc": 2,
    "backbone": [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                 [-1, 1, "ADown", [16]]],
    "head": [[[1, 2], 1, "Segment", [2, 4, 16]]],
}


def _net(cfg, seed=0):
    return _seeded(Y.Yolov9SegNet(cfg), seed)


@pytest.mark.parametrize("cfg,size", [(TINY_FULL, (64, 80)), (TINY_SEG, (48, 64)),
                                      (Y.YOLOV9E_SEG, (64, 64))],
                         ids=["tiny_full", "tiny_seg", "yolov9e_seg"])
def test_layer_list_matches_jax(cfg, size):
    """The builder on both tiny lists and on YOLOv9e-seg at full width; the
    reference's forward runs op by op (no jit), so no long compile."""
    net = _net(cfg)
    if cfg is Y.YOLOV9E_SEG:
        assert sum(p.numel() for p in net.parameters()) == 60_512_784
    x = np.random.default_rng(5).uniform(size=(1, 3, *size)).astype(np.float32)
    got = _port(net, x)
    params = {k: jnp.asarray(v) for k, v in convert.yolo_params(net).items()}
    want = y9.build_model(cfg)(params, jnp.asarray(x))
    for t, j in zip(got, want):
        _cmp(t, j)


def test_builder_refuses_unknown_module_and_repeats():
    bad = {"backbone": [[-1, 1, "C2f", [8]]], "head": []}
    with pytest.raises(ValueError, match="unsupported module C2f"):
        Y.Yolov9SegNet(bad)
    with pytest.raises(ValueError, match="repeats"):
        Y.Yolov9SegNet({"backbone": [[-1, 2, "Conv", [8, 3, 2]]], "head": []})
    with pytest.raises(ValueError, match="no Segment head"):
        Y.Yolov9SegNet({"backbone": [[-1, 1, "Conv", [8, 3, 2]]], "head": []})


def test_params_and_state_dict_exact_both_ways():
    net = _net(TINY_FULL)
    params = convert.yolo_params(net)
    # the reference's own converter of the same state dict gives the same dict
    ref = y9.convert_state_dict(net.state_dict())
    assert set(params) == set(ref)
    for k, v in params.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(ref[k]))
    other = _net(TINY_FULL, seed=1)
    other.load_state_dict(convert.yolo_state_dict(params, "cpu"), strict=True)
    back = convert.yolo_params(other)
    assert set(back) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("dfl", ["absent", "arange", "wrong"])
def test_reference_npz_loads(tmp_path, dfl):
    """A `.npz` as scripts/convert_weights.py --yolo writes it (the
    reference's `save_pytree_npz`, meta `cfg`); an ultralytics checkpoint
    also carries `model.<last>.dfl.conv.weight`, which must be
    arange(16)."""
    net = _net(TINY_SEG)
    params = convert.yolo_params(net)
    if dfl != "absent":
        w = np.arange(16, dtype=np.float32) + (dfl == "wrong")
        params["model.3.dfl.conv.weight"] = w.reshape(1, 16, 1, 1)
    path = str(tmp_path / "yolov9e-seg.npz")
    jio.save_pytree_npz(path, params, meta={"cfg": TINY_SEG})
    if dfl == "wrong":
        with pytest.raises(ValueError, match="arange"):
            Y.load_yolov9(path, imgsz=64, device="cpu")
        return
    model = Y.load_yolov9(path.replace(".npz", ".pt"), imgsz=64, device="cpu")
    ref = y9.load_yolov9(path, imgsz=64)
    lb = np.random.default_rng(6).uniform(size=(3, 64, 64)).astype(np.float32)
    got = model.outputs(lb)
    want = ref.forward(ref.params, lb[None])
    for t, j in zip(got, want):
        _cmp(t, np.asarray(j)[0])


def test_npz_without_layer_list_raises(tmp_path):
    path = str(tmp_path / "w.npz")
    jio.save_pytree_npz(path, convert.yolo_params(_net(TINY_SEG)))
    with pytest.raises(ValueError, match="no layer list"):
        Y.load_yolov9(path, device="cpu")


@pytest.mark.parametrize("shape", [(3, 48, 60), (3, 61, 37)])
def test_letterbox_and_bilinear_match_jax_exactly(shape):
    img = np.random.default_rng(7).uniform(size=shape).astype(np.float32)
    got, want = Y.letterbox(img, 64), y9.letterbox(img, 64)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    ys = np.linspace(-1.3, shape[1] + 0.7, 29)
    xs = np.linspace(-0.4, shape[2] + 1.1, 31)
    np.testing.assert_array_equal(Y._bilinear_sample(img, ys, xs),
                                  y9._bilinear_sample(img, ys, xs))


def test_nms_matches_jax_exactly():
    rng = np.random.default_rng(8)
    xy = rng.uniform(0, 60, (200, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(2, 30, (200, 2)).astype(np.float32)], 1)
    scores = rng.uniform(size=200).astype(np.float32)
    for iou in (0.3, 0.45, 0.7):
        keep = Y.nms_numpy(boxes, scores, iou)
        np.testing.assert_array_equal(keep, y9.nms_numpy(boxes, scores, iou))
        assert 1 < len(keep) < 200


@pytest.fixture(scope="module")
def tiny_models():
    """The port's and the reference's Yolov9Seg of one seeded TINY_SEG net
    at imgsz 64; the reference's jitted forward is reused by swapping its
    params."""
    net = _net(TINY_SEG, seed=2)
    params = convert.yolo_params(net)
    port = Y.Yolov9Seg(TINY_SEG, params, imgsz=64, device="cpu")
    ref = y9.Yolov9Seg(TINY_SEG, {k: jnp.asarray(v) for k, v in params.items()}, imgsz=64)
    return params, port, ref


@pytest.mark.parametrize("case", ["conf_0", "conf_0.25", "planted_bias"])
def test_segment_masks_equal_jax(tiny_models, case):
    """Every pixel equal: the tiny model's outputs agree to about 1e-6, and
    at these seeds no mask value or box edge lies that close to its
    threshold."""
    params, port, ref = tiny_models
    params = dict(params)
    conf = 0.0 if case == "conf_0" else 0.25
    if case == "planted_bias":
        # class 0 made likely at the second level: its 64 anchors pass 0.25
        b = params["model.3.cv3.1.2.bias"].copy()
        b[0] = 1.0
        params["model.3.cv3.1.2.bias"] = b
    port.net.load_state_dict(convert.yolo_state_dict(params, "cpu"))
    ref.params = {k: jnp.asarray(v) for k, v in params.items()}
    img = np.random.default_rng(9).uniform(size=(3, 48, 60)).astype(np.float32)
    got = port.segment(img, [0], conf=conf)
    want = ref.segment(img, [0], conf=conf)
    assert got.shape == (48, 60) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    if case == "conf_0.25":
        assert not got.any()        # seeded scores lie near the prior
    elif case == "conf_0":
        assert got.any()
    else:
        assert 0 < got.sum() < got.size     # mask and box edges inside the frame


def test_golden_activations(tmp_path):
    """The port on real weights against the reference's activations, as
    tests/test_weights_io.py holds the reference (rtol 1e-4, atol 1e-3)."""
    golden = os.path.join(GOLDEN_DIR, "golden_yolov9.npz")
    weights = os.path.join(GOLDEN_DIR, "yolov9e-seg.npz")
    if not (os.path.exists(golden) and os.path.exists(weights)):
        pytest.skip(f"{golden} or {weights} absent (scripts/convert_weights.py --yolo not "
                    "run: the published yolov9e-seg.pt is not in the repository)")
    g = np.load(golden)
    model = Y.load_yolov9(weights, imgsz=320, device="cpu")
    img = np.random.default_rng(0).uniform(0, 1, (1, 3, 320, 320)).astype(np.float32)
    boxes, scores, mcs, protos = model.outputs(img[0])
    for got, key in ((boxes, "boxes"), (scores, "scores"), (mcs, "mask_coefs"),
                     (protos, "protos")):
        np.testing.assert_allclose(got, g[key], rtol=1e-4, atol=1e-3)
