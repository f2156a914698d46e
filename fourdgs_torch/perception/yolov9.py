"""YOLOv9-seg instance segmentation as torch modules (port of
fourdgs/perception/yolov9.py).

The reference system segments people, chairs, clocks and teddy bears in
each recorded frame with ultralytics' YOLOv9e-seg (`slam.py:80`,
`utils/dataset.py:352-373`). Here the network is a set of `nn.Module`s
under ultralytics' own submodule names (`conv`/`bn`, `cv1`...`cv5`,
`m.<i>`, `conv1`/`conv2`, `proto.upsample`), built from the checkpoint's
layer list (`[from, repeats, module, args]`) into `Yolov9SegNet`, whose
layers sit at `model.<i>`: a checkpoint's state dict loads key for key.
Widths are inferred from the list as ultralytics' `parse_model` does.

Only the network's forward runs on the device, in full float32 (no
TF32). Its four outputs (boxes in letterbox pixels, class scores, mask
coefficients, mask prototypes) come back to the host once per frame, and
the post-processing stays there in numpy, as in the reference, so the
masks match it bit for bit: the letterbox (bilinear, 0.447 fill), the
per-class NMS, the sigmoid of coefficients @ prototypes, bilinear to the
frame, the crop to each box and the union.

`YOLOV9E_SEG` is the published YOLOv9e-seg layer list, for seeded runs
(the tests and chip_smoke.py); a real checkpoint brings its own list.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fourdgs_torch.device import resolve_device
from fourdgs_torch.perception.raft import full_float32

BN_EPS = 1e-3      # ultralytics BatchNorm2d(eps=0.001)
REG_MAX = 16
STRIDES = (8, 16, 32)   # of the Segment head's levels, as the reference fixes them

# ultralytics ultralytics/cfg/models/v9/yolov9e-seg.yaml (60.5 M parameters
# at nc 80). Layer 0 is `nn.Identity` there; it is written `Silence`, the
# name the reference's `build_model` knows for it.
YOLOV9E_SEG = {
    "nc": 80,
    "backbone": [
        [-1, 1, "Silence", []],                                   # 0
        [-1, 1, "Conv", [64, 3, 2]],                              # 1-P1/2
        [-1, 1, "Conv", [128, 3, 2]],                             # 2-P2/4
        [-1, 1, "RepNCSPELAN4", [256, 128, 64, 2]],               # 3
        [-1, 1, "ADown", [256]],                                  # 4-P3/8
        [-1, 1, "RepNCSPELAN4", [512, 256, 128, 2]],              # 5
        [-1, 1, "ADown", [512]],                                  # 6-P4/16
        [-1, 1, "RepNCSPELAN4", [1024, 512, 256, 2]],             # 7
        [-1, 1, "ADown", [1024]],                                 # 8-P5/32
        [-1, 1, "RepNCSPELAN4", [1024, 512, 256, 2]],             # 9
        [1, 1, "CBLinear", [[64]]],                               # 10
        [3, 1, "CBLinear", [[64, 128]]],                          # 11
        [5, 1, "CBLinear", [[64, 128, 256]]],                     # 12
        [7, 1, "CBLinear", [[64, 128, 256, 512]]],                # 13
        [9, 1, "CBLinear", [[64, 128, 256, 512, 1024]]],          # 14
        [0, 1, "Conv", [64, 3, 2]],                               # 15-P1/2
        [[10, 11, 12, 13, 14, -1], 1, "CBFuse", [[0, 0, 0, 0, 0]]],  # 16
        [-1, 1, "Conv", [128, 3, 2]],                             # 17-P2/4
        [[11, 12, 13, 14, -1], 1, "CBFuse", [[1, 1, 1, 1]]],      # 18
        [-1, 1, "RepNCSPELAN4", [256, 128, 64, 2]],               # 19
        [-1, 1, "ADown", [256]],                                  # 20-P3/8
        [[12, 13, 14, -1], 1, "CBFuse", [[2, 2, 2]]],             # 21
        [-1, 1, "RepNCSPELAN4", [512, 256, 128, 2]],              # 22
        [-1, 1, "ADown", [512]],                                  # 23-P4/16
        [[13, 14, -1], 1, "CBFuse", [[3, 3]]],                    # 24
        [-1, 1, "RepNCSPELAN4", [1024, 512, 256, 2]],             # 25
        [-1, 1, "ADown", [1024]],                                 # 26-P5/32
        [[14, -1], 1, "CBFuse", [[4]]],                           # 27
        [-1, 1, "RepNCSPELAN4", [1024, 512, 256, 2]],             # 28
        [-1, 1, "SPPELAN", [512, 256]],                           # 29
    ],
    "head": [
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],             # 30
        [[-1, 25], 1, "Concat", [1]],                             # 31
        [-1, 1, "RepNCSPELAN4", [512, 512, 256, 2]],              # 32
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],             # 33
        [[-1, 22], 1, "Concat", [1]],                             # 34
        [-1, 1, "RepNCSPELAN4", [256, 256, 128, 2]],              # 35 (P3/8)
        [-1, 1, "ADown", [256]],                                  # 36
        [[-1, 32], 1, "Concat", [1]],                             # 37
        [-1, 1, "RepNCSPELAN4", [512, 512, 256, 2]],              # 38 (P4/16)
        [-1, 1, "ADown", [512]],                                  # 39
        [[-1, 29], 1, "Concat", [1]],                             # 40
        [-1, 1, "RepNCSPELAN4", [512, 1024, 512, 2]],             # 41 (P5/32)
        [[35, 38, 41], 1, "Segment", ["nc", 32, 256]],            # 42
    ],
}


# ---------------------------------------------------------------------------
# Primitives, under ultralytics' submodule names
# ---------------------------------------------------------------------------


def autopad(k: int, p: int | None = None) -> int:
    return k // 2 if p is None else p


class BatchNorm(nn.Module):
    """Batch norm at its running statistics, eps 1e-3; nothing updates
    them. Its state is `weight`, `bias`, `running_mean`, `running_var`."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, BN_EPS)


class Conv(nn.Module):
    """Conv2d without bias, batch norm, SiLU (none with `act` False)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), bias=False)
        self.bn = BatchNorm(c2)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class RepConvN(nn.Module):
    """A 3x3 and a 1x1 Conv without activation, summed, then SiLU."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv1 = Conv(c1, c2, 3, act=False)
        self.conv2 = Conv(c1, c2, 1, p=0, act=False)

    def forward(self, x):
        return F.silu(self.conv1(x) + self.conv2(x))


class RepNBottleneck(nn.Module):
    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = RepConvN(c1, c2)
        self.cv2 = Conv(c2, c2, 3)
        self.add = c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepNCSP(nn.Module):
    """cv3(cat(n bottlenecks of cv1(x), cv2(x)))."""

    def __init__(self, c1: int, c2: int, n: int):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_)
        self.cv2 = Conv(c1, c_)
        self.cv3 = Conv(2 * c_, c2)
        self.m = nn.Sequential(*(RepNBottleneck(c_, c_) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class RepNCSPELAN4(nn.Module):
    """cv1, split in two halves; two stages of RepNCSP + Conv3 on the last;
    cv4 of all four joined."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1):
        super().__init__()
        self.cv1 = Conv(c1, c3)
        self.cv2 = nn.Sequential(RepNCSP(c3 // 2, c4, n), Conv(c4, c4, 3))
        self.cv3 = nn.Sequential(RepNCSP(c4, c4, n), Conv(c4, c4, 3))
        self.cv4 = Conv(c3 + 2 * c4, c2)

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        y.append(self.cv2(y[-1]))
        y.append(self.cv3(y[-1]))
        return self.cv4(torch.cat(y, 1))


class ADown(nn.Module):
    """2x2 average pool at stride 1, split in two halves: a 3x3/2 Conv of
    one, a 3x3/2 max pool and a 1x1 Conv of the other."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = Conv(c1 // 2, c2 // 2, 3, 2, 1)
        self.cv2 = Conv(c1 // 2, c2 // 2, 1, 1, 0)

    def forward(self, x):
        x1, x2 = F.avg_pool2d(x, 2, 1, 0, False, True).chunk(2, 1)
        return torch.cat([self.cv1(x1), self.cv2(F.max_pool2d(x2, 3, 2, 1))], 1)


class SPPELAN(nn.Module):
    """cv1, three stacked 5x5 max pools, cv5 of all four joined."""

    def __init__(self, c1: int, c2: int, c3: int):
        super().__init__()
        self.cv1 = Conv(c1, c3)
        self.cv5 = Conv(4 * c3, c2)

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], 5, 1, 2))
        return self.cv5(torch.cat(y, 1))


class CBLinear(nn.Module):
    """A biased 1x1 convolution whose output is split into `c2s` chunks."""

    def __init__(self, c1: int, c2s: list[int]):
        super().__init__()
        self.c2s = list(c2s)
        self.conv = nn.Conv2d(c1, sum(self.c2s), 1, 1, 0, bias=True)

    def forward(self, x):
        return self.conv(x).split(self.c2s, 1)


class CBFuse(nn.Module):
    """The `idx[i]`-th chunk of each CBLinear output, resized to the last
    input's size by nearest neighbour (row index floor(i * h0 / h), as the
    reference computes it), summed with the last input."""

    def __init__(self, idx: list[int]):
        super().__init__()
        self.idx = list(idx)

    def forward(self, xs):
        h, w = xs[-1].shape[2:]
        out = xs[-1]
        for i, x in enumerate(xs[:-1]):
            x = x[self.idx[i]]
            h0, w0 = x.shape[2:]
            iy = torch.arange(h, device=x.device) * h0 // h
            ix = torch.arange(w, device=x.device) * w0 // w
            out = x[:, :, iy][:, :, :, ix] + out
        return out


class Silence(nn.Module):
    def forward(self, x):
        return x


class Upsample(nn.Module):
    """Nearest 2x upsampling."""

    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="nearest")


class Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


# ---------------------------------------------------------------------------
# The Segment head
# ---------------------------------------------------------------------------


class Proto(nn.Module):
    """Conv3, 2x2/2 transposed convolution, Conv3, Conv1: the mask
    prototypes at twice the first level's resolution."""

    def __init__(self, c1: int, c_: int, c2: int):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


def _branch(c1: int, c_: int, c2: int) -> nn.Sequential:
    """Conv3, Conv3, a biased 1x1 convolution."""
    return nn.Sequential(Conv(c1, c_, 3), Conv(c_, c_, 3), nn.Conv2d(c_, c2, 1))


def make_anchors(shapes, strides, device):
    """Anchor centres, in cells, of each level's (h, w) grid, and each
    anchor's stride."""
    pts, strs = [], []
    for (h, w), s in zip(shapes, strides):
        sy = torch.arange(h, dtype=torch.float32, device=device) + 0.5
        sx = torch.arange(w, dtype=torch.float32, device=device) + 0.5
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strs.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(pts), torch.cat(strs)


class Segment(nn.Module):
    """The v8-style Detect head (`cv2` box distributions over REG_MAX
    bins, `cv3` class logits) with mask coefficients (`cv4`) and
    prototypes (`proto`). Returns boxes (B, A, 4) as x1y1x2y2 in input
    pixels, class scores (B, A, nc) after the sigmoid, coefficients
    (B, A, nm) and prototypes (B, nm, Hp, Wp). An ultralytics checkpoint
    also carries the DFL decode's fixed weights (`dfl.conv.weight`,
    arange(REG_MAX)); they are not a parameter here (`load_state`)."""

    def __init__(self, nc: int, nm: int, npr: int, ch: list[int]):
        super().__init__()
        self.nc = nc
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        c4 = max(ch[0] // 4, nm)
        self.cv2 = nn.ModuleList(_branch(c, c2, 4 * REG_MAX) for c in ch)
        self.cv3 = nn.ModuleList(_branch(c, c3, nc) for c in ch)
        self.cv4 = nn.ModuleList(_branch(c, c4, nm) for c in ch)
        self.proto = Proto(ch[0], npr, nm)

    def forward(self, feats):
        protos = self.proto(feats[0])
        b = feats[0].shape[0]
        flat = lambda heads: torch.cat([h(f).reshape(b, h[-1].out_channels, -1)  # noqa: E731
                                        for h, f in zip(heads, feats)], 2)
        box, cls, mc = flat(self.cv2), flat(self.cv3), flat(self.cv4)
        a = box.shape[2]
        probs = torch.softmax(box.reshape(b, 4, REG_MAX, a), 2)
        bins = torch.arange(REG_MAX, dtype=probs.dtype, device=probs.device)
        dist = (probs * bins[:, None]).sum(2)                  # (B, 4, A) ltrb in cells
        anchors, strs = make_anchors([f.shape[2:] for f in feats], STRIDES, box.device)
        xy = anchors.T[None]
        boxes = torch.cat([(xy - dist[:, :2]) * strs, (xy + dist[:, 2:]) * strs], 1)
        return (boxes.transpose(1, 2), torch.sigmoid(cls).transpose(1, 2),
                mc.transpose(1, 2), protos)


# ---------------------------------------------------------------------------
# The network of a layer list
# ---------------------------------------------------------------------------

class Yolov9SegNet(nn.Module):
    """The network of an ultralytics model dict (`backbone` + `head`
    lists of [from, repeats, module, args]); layer i sits at `model.<i>`,
    and each layer's input channels are inferred from the list as
    `parse_model` does. The Segment head has the dict's `nc` classes (80
    without it). forward((B, 3, H, W) in [0, 1]) -> (boxes, scores,
    coefficients, prototypes) as `Segment` returns them."""

    def __init__(self, cfg: dict):
        super().__init__()
        layers = list(cfg["backbone"]) + list(cfg["head"])
        nc = int(cfg.get("nc", 80))
        ch = [3]
        mods, self.sources = [], []
        for i, (frm, rep, mod, args) in enumerate(layers):
            if rep != 1:
                raise ValueError(f"layer {i}: repeats {rep}; only 1 is supported")
            c1 = [ch[j] for j in frm] if isinstance(frm, (list, tuple)) else ch[frm]
            if mod == "Silence":
                m, c2 = Silence(), c1
            elif mod == "Conv":
                c2 = args[0]
                m = Conv(c1, c2, args[1] if len(args) > 1 else 1, args[2] if len(args) > 2 else 1)
            elif mod == "RepNCSPELAN4":
                c2 = args[0]
                m = RepNCSPELAN4(c1, c2, args[1], args[2], int(args[3]) if len(args) > 3 else 1)
            elif mod == "ADown":
                c2 = args[0]
                m = ADown(c1, c2)
            elif mod == "SPPELAN":
                c2 = args[0]
                m = SPPELAN(c1, c2, args[1])
            elif mod == "CBLinear":
                c2 = list(args[0])
                m = CBLinear(c1, c2)
            elif mod == "CBFuse":
                m, c2 = CBFuse(args[0]), c1[-1]
            elif mod == "Concat":
                m, c2 = Concat(), sum(c1)
            elif mod in ("nn.Upsample", "Upsample"):
                m, c2 = Upsample(), c1
            elif mod == "Segment":
                m, c2 = Segment(nc, int(args[1]), int(args[2]), c1), None
            else:
                raise ValueError(f"unsupported module {mod} at layer {i}")
            if i == 0:
                ch = []
            ch.append(c2)
            mods.append(m)
            self.sources.append(frm)
            if mod == "Segment":
                break
        else:
            raise ValueError("the layer list has no Segment head")
        self.model = nn.ModuleList(mods)

    def forward(self, x):
        outputs, y = [], x
        for frm, m in zip(self.sources, self.model):
            if isinstance(frm, (list, tuple)):
                src = [y if j == -1 else outputs[j] for j in frm]
            else:
                src = y if frm == -1 else outputs[frm]
            y = m(src)
            outputs.append(y)
        return y


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded weights in place, drawn from `generator`: every convolution
    normal with std sqrt(1 / fan_in) and zero bias (at sqrt(2 / fan_in)
    the activations grow some thousandfold through the 42 layers); every
    batch norm with random statistics as tests/test_yolov9_parity.py draws
    them (mean N(0, 0.5), variance U(0.5, 2), weight N(1, 0.2), bias
    N(0, 0.2)); then the Segment head's last box and class convolutions
    biased as ultralytics' `Detect.bias_init` does (box 1.0, class
    log(5 / nc / (640 / s)^2) at stride s), so that seeded scores lie near
    a trained network's prior instead of marking every anchor."""
    randn = lambda shape: torch.randn(shape, generator=generator)  # noqa: E731
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                # a transposed convolution's kernel equals its stride: each
                # output sums one tap of each input channel
                fan_in = m.weight[0].numel() if isinstance(m, nn.Conv2d) else m.in_channels
                m.weight.copy_(randn(m.weight.shape) / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                c = m.weight.shape
                m.running_mean.copy_(randn(c) * 0.5)
                m.running_var.copy_(torch.rand(c, generator=generator) * 1.5 + 0.5)
                m.weight.copy_(1.0 + 0.2 * randn(c))
                m.bias.copy_(0.2 * randn(c))
        for m in model.modules():
            if isinstance(m, Segment):
                for box, cls, s in zip(m.cv2, m.cv3, STRIDES):
                    box[-1].bias.fill_(1.0)
                    cls[-1].bias.fill_(math.log(5 / m.nc / (640 / s) ** 2))
    return model


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def load_state(model: Yolov9SegNet, sd) -> Yolov9SegNet:
    """Load a flat `model.<i>.…` dict of arrays (or CPU tensors) into
    `model`, strictly. Batch-norm step counts are dropped; so are the DFL's
    fixed weights, which an ultralytics checkpoint carries, after a check
    that they are arange(REG_MAX)."""
    from fourdgs_torch.convert import yolo_state_dict

    dfl = [k for k in sd if k.endswith(".dfl.conv.weight")]
    for k in dfl:
        if not np.array_equal(np.asarray(sd[k]).reshape(-1), np.arange(REG_MAX)):
            raise ValueError(f"{k} is not arange({REG_MAX})")
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked") and k not in dfl}
    model.load_state_dict(yolo_state_dict(sd, next(model.parameters()).device), strict=True)
    return model


def weights_file(path: str) -> str | None:
    """The file a weights path reads: the sibling `.npz` of a `.pt` path
    when it exists, else the path itself when it exists, else None."""
    npz = path[:-3] + ".npz" if path.endswith(".pt") else None
    for p in (npz, path):
        if p and os.path.exists(p):
            return p
    return None


# ---------------------------------------------------------------------------
# Host-side post-processing (numpy, as the reference)
# ---------------------------------------------------------------------------


def nms_numpy(boxes, scores, iou_th=0.45, max_det=100):
    order = np.argsort(-scores)
    keep = []
    while order.size and len(keep) < max_det:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        xx1 = np.maximum(boxes[i, 0], boxes[order[1:], 0])
        yy1 = np.maximum(boxes[i, 1], boxes[order[1:], 1])
        xx2 = np.minimum(boxes[i, 2], boxes[order[1:], 2])
        yy2 = np.minimum(boxes[i, 3], boxes[order[1:], 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        a_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a_o = (boxes[order[1:], 2] - boxes[order[1:], 0]) * (
            boxes[order[1:], 3] - boxes[order[1:], 1])
        iou = inter / np.maximum(a_i + a_o - inter, 1e-9)
        order = order[1:][iou <= iou_th]
    return np.asarray(keep, np.int64)


def _bilinear_sample(img: np.ndarray, ys: np.ndarray, xs: np.ndarray):
    """Separable bilinear sampling of (..., H, W) at row coordinates ys
    (R,) and column coordinates xs (C,) -> (..., R, C), half-pixel
    centres (cv2 INTER_LINEAR, torch align_corners=False)."""
    h, w = img.shape[-2], img.shape[-1]
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)
    fx = np.clip(xs - x0, 0.0, 1.0)
    top = img[..., y0, :] * (1 - fy)[:, None] + img[..., y1, :] * fy[:, None]
    return top[..., :, x0] * (1 - fx)[None, :] + top[..., :, x1] * fx[None, :]


def letterbox(img_chw: np.ndarray, size: int = 640):
    """Bilinear resize to fit (size, size), padded with 0.447; returns
    (image, scale, (dx, dy))."""
    c, h, w = img_chw.shape
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    ys = (np.arange(nh) + 0.5) / r - 0.5
    xs = (np.arange(nw) + 0.5) / r - 0.5
    resized = _bilinear_sample(img_chw, ys, xs).astype(np.float32)
    out = np.full((c, size, size), 0.447, np.float32)
    dy, dx = (size - nh) // 2, (size - nw) // 2
    out[:, dy:dy + nh, dx:dx + nw] = resized
    return out, r, (dx, dy)


class Yolov9Seg:
    """YOLOv9-seg inference: the network on `device`, the post-processing
    on the host. `params` is a flat `model.<i>.…` state dict."""

    def __init__(self, cfg: dict, params, imgsz: int = 640, device=None):
        self.device = resolve_device(device)
        self.net = load_state(Yolov9SegNet(cfg).to(self.device), params).eval()
        self.imgsz = imgsz

    def forward(self, x: torch.Tensor):
        """(B, 3, H, W) in [0, 1] on the device -> the four outputs, on it."""
        with torch.inference_mode(), full_float32():
            return self.net(x)

    def outputs(self, lb: np.ndarray):
        """The four outputs of one letterboxed (3, S, S) image, as numpy,
        brought to the host in one copy."""
        boxes, scores, mcs, protos = self.forward(
            torch.as_tensor(lb, device=self.device)[None])
        parts = (boxes[0], scores[0], mcs[0], protos[0])
        flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        out, o = [], 0
        for p in parts:
            out.append(flat[o:o + p.numel()].reshape(p.shape))
            o += p.numel()
        return out

    def segment(self, image_chw: np.ndarray, classes: list[int],
                conf: float = 0.25) -> np.ndarray:
        """(3, H, W) float image in [0, 1] -> (H, W) bool union of the
        masks of the detections of `classes` at score >= conf."""
        c, h, w = image_chw.shape
        lb, r, (dx, dy) = letterbox(np.asarray(image_chw, np.float32), self.imgsz)
        boxes, scores, mcs, protos_np = self.outputs(lb)
        cls_id = scores.argmax(axis=1)
        cls_sc = scores.max(axis=1)
        mask_out = np.zeros((h, w), bool)
        sel_all = (cls_sc >= conf) & np.isin(cls_id, classes)
        if not sel_all.any():
            return mask_out
        idx = np.nonzero(sel_all)[0]
        # per-class NMS: boxes offset by class id never suppress each other
        off = (cls_id[idx, None] * 4096.0).astype(np.float32)
        keep = nms_numpy(boxes[idx] + off, cls_sc[idx])
        nm, hp, wp = protos_np.shape
        for i in idx[keep]:
            m = 1.0 / (1.0 + np.exp(-(mcs[i] @ protos_np.reshape(nm, -1))))
            m = m.reshape(hp, wp)
            # prototype grid -> letterbox pixels -> frame pixels, bilinear
            sy = self.imgsz / hp
            ys = ((np.arange(h) + 0.5) * r + dy) / sy - 0.5
            xs = ((np.arange(w) + 0.5) * r + dx) / sy - 0.5
            full = _bilinear_sample(m, ys, xs) > 0.5
            # crop to the detection's box in frame pixels
            x1 = int(max((boxes[i, 0] - dx) / r, 0))
            y1 = int(max((boxes[i, 1] - dy) / r, 0))
            x2 = int(min((boxes[i, 2] - dx) / r, w))
            y2 = int(min((boxes[i, 3] - dy) / r, h))
            crop = np.zeros_like(full)
            crop[y1:y2, x1:x2] = full[y1:y2, x1:x2]
            mask_out |= crop
        return mask_out


def load_yolov9(path: str, imgsz: int = 640, device=None) -> Yolov9Seg:
    """The model of a weights file (`weights_file` of `path`) on `device`:
    the `.npz` of `scripts/convert_weights.py --yolo` (its meta `cfg` is
    the layer list), or an ultralytics `.pt`, whose `model` (else `ema`)
    object carries `.yaml` and the weights."""
    found = weights_file(path)
    if found is None:
        raise FileNotFoundError(f"YOLOv9 weights not found: {path}")
    if found.endswith(".npz"):
        from fourdgs_torch.perception.weights_io import load_pytree_npz

        params, meta = load_pytree_npz(found)
        if not meta or "cfg" not in meta:
            raise ValueError(f"{found} has no layer list (meta 'cfg')")
        return Yolov9Seg(meta["cfg"], params, imgsz=imgsz, device=device)
    try:
        ckpt = torch.load(found, map_location="cpu", weights_only=False)
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            f"{found}: unpickling needs the module {e.name}; an ultralytics checkpoint needs "
            "the ultralytics package (convert it once with scripts/convert_weights.py "
            "--yolo where that package is installed)") from e
    model = ckpt.get("model") if ckpt.get("model") is not None else ckpt.get("ema")
    params = {k: v.detach().cpu().numpy() for k, v in model.float().state_dict().items()}
    return Yolov9Seg(dict(model.yaml), params, imgsz=imgsz, device=device)
