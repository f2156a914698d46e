"""RAFT optical flow as a torch module (port of fourdgs/perception/raft.py),
at the width of the public raft-things checkpoint.

Twin residual encoders (`fnet`: 256 channels, instance norm; `cnet`: 128
hidden + 128 context channels, batch norm frozen at its running stats),
an all-pairs correlation pyramid of 4 levels looked up bilinearly within
radius 4, a SepConvGRU update block iterated `iters` times (20 by
default), and convex 8x upsampling. Submodules carry the names of
`raft-things.pth` (`fnet.*`, `cnet.*`, `update_block.encoder.convc1`,
`update_block.gru.convz1`, `update_block.flow_head.conv1`,
`update_block.mask.0`/`.2`), so the `.pth` route is `load_state_dict`;
the `.npz` route reads the JAX package's parameter pytree
(fourdgs_torch/convert.py `flow_state_dict`).

The correlation lookup gathers each bilinear corner directly, zero
outside the level, as the JAX version does: the original torch RAFT's
`grid_sample` normalises by W-1 and gives NaN at a level 1 px wide.
Inference runs in full float32 (`full_float32`): on the H100 cuDNN
convolutions and matmuls would otherwise take TF32, whose error the 20
GRU iterations amplify.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fourdgs_torch.device import resolve_device

HDIM = 128
CDIM = 128
CORR_LEVELS = 4
CORR_RADIUS = 4
COR_PLANES = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2   # 324


@contextlib.contextmanager
def full_float32():
    """While open, matmuls and cuDNN convolutions compute in float32, not
    TF32; the previous settings come back on exit."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class Norm2d(nn.Module):
    """Instance norm with an affine (`kind` 'instance'), or batch norm at
    its frozen running statistics ('batch'), eps 1e-5."""

    def __init__(self, channels: int, kind: str):
        super().__init__()
        self.batch = kind == "batch"
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        if self.batch:
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.batch:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, 1e-5)
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=1e-5)


class ResidualBlock(nn.Module):
    """Two 3x3 convolutions with norms; a strided block has a 1x1 strided
    `downsample` branch whose norm is also registered as `norm3`."""

    def __init__(self, cin: int, cout: int, stride: int, norm: str):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.norm1 = Norm2d(cout, norm)
        self.norm2 = Norm2d(cout, norm)
        self.downsample = None
        if stride != 1:
            self.norm3 = Norm2d(cout, norm)
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """7x7/2 stem, three stages of two residual blocks (64, 96, 128
    channels, the last two at stride 2) and a 1x1 head: 1/8 resolution."""

    def __init__(self, out_dim: int, norm: str):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = Norm2d(64, norm)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, 1, norm), ResidualBlock(64, 64, 1, norm))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2, norm), ResidualBlock(96, 96, 1, norm))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, 2, norm),
                                    ResidualBlock(128, 128, 1, norm))
        self.conv2 = nn.Conv2d(128, out_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class MotionEncoder(nn.Module):
    """Correlation and flow features, joined into 126 channels plus the
    flow: 128."""

    def __init__(self):
        super().__init__()
        self.convc1 = nn.Conv2d(COR_PLANES, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([c, f], dim=1))), flow], dim=1)


class SepConvGRU(nn.Module):
    """A GRU over (1, 5) convolutions, then one over (5, 1)."""

    def __init__(self, input_dim: int):
        super().__init__()
        cin = HDIM + input_dim
        for name, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{name}", nn.Conv2d(cin, HDIM, k, padding=p))

    def forward(self, h, x):
        for name in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{name}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{name}")(hx))
            q = torch.tanh(getattr(self, f"convq{name}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(HDIM, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    """Motion encoder, GRU and flow head; `mask` gives the convex
    upsampling weights. With an `aggregator` (GMA) the GRU also takes the
    globally aggregated motion features."""

    def __init__(self, aggregator: nn.Module | None = None):
        super().__init__()
        self.encoder = MotionEncoder()
        self.gru = SepConvGRU(CDIM + 128 * (2 if aggregator is not None else 1))
        self.flow_head = FlowHead()
        self.mask = nn.Sequential(nn.Conv2d(HDIM, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))
        if aggregator is not None:
            self.aggregator = aggregator

    def forward(self, net, inp, corr, flow, attention=None):
        motion = self.encoder(flow, corr)
        parts = [inp, motion]
        if attention is not None:
            parts.append(self.aggregator(attention, motion))
        net = self.gru(net, torch.cat(parts, dim=1))
        return net, self.flow_head(net)


# ---------------------------------------------------------------------------
# Correlation and upsampling
# ---------------------------------------------------------------------------


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor) -> list[torch.Tensor]:
    """All-pairs correlation of (N, C, H, W) features and its 2x2 average
    pools (odd sizes floor): CORR_LEVELS tensors (N*H*W, 1, Hl, Wl)."""
    n, c, h, w = fmap1.shape
    corr = torch.matmul(fmap1.reshape(n, c, h * w).transpose(1, 2),
                        fmap2.reshape(n, c, h * w)) / math.sqrt(c)
    corr = corr.reshape(n * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(CORR_LEVELS - 1):
        corr = F.avg_pool2d(corr, 2, 2)
        pyramid.append(corr)
    return pyramid


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img (N, C, H, W), coords (N, P, 2) as x, y -> (N, C, P); each of the
    four corners reads zero outside the image."""
    n, c, h, w = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = (x - x0)[:, None, :], (y - y0)[:, None, :]
    flat = img.reshape(n, c, h * w)

    def gather(xi, yi):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        out = torch.gather(flat, 2, idx[:, None, :].expand(n, c, idx.shape[1]))
        return out * valid[:, None, :]

    v00 = gather(x0, y0)
    v01 = gather(x0, y0 + 1)
    v10 = gather(x0 + 1, y0)
    v11 = gather(x0 + 1, y0 + 1)
    return (v00 * (1 - dx) * (1 - dy) + v10 * dx * (1 - dy)
            + v01 * (1 - dx) * dy + v11 * dx * dy)


def corr_lookup(pyramid: list[torch.Tensor], coords: torch.Tensor) -> torch.Tensor:
    """coords (N, 2, H, W) -> (N, 324, H, W): per level the (2r+1)^2
    correlations around coords / 2^level. Channel i*(2r+1)+j samples
    offset (x + i - r, y + j - r): the x offset rides the slow index, the
    order the update block's weights expect."""
    n, _, h, w = coords.shape
    cgrid = coords.permute(0, 2, 3, 1).reshape(n * h * w, 1, 2)
    ar = torch.arange(-CORR_RADIUS, CORR_RADIUS + 1, dtype=coords.dtype, device=coords.device)
    d = torch.stack(torch.meshgrid(ar, ar, indexing="ij"), dim=-1).reshape(1, -1, 2)
    feat = torch.cat([bilinear_sample(corr, cgrid / (2.0 ** lvl) + d)[:, 0, :]
                      for lvl, corr in enumerate(pyramid)], dim=-1)
    return feat.reshape(n, h, w, -1).permute(0, 3, 1, 2).contiguous()


def coords_grid(n: int, h: int, w: int, device) -> torch.Tensor:
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x, y])[None].expand(n, 2, h, w)


def upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex 8x upsampling: each full-resolution pixel is a softmax-weighted
    combination of the 3x3 low-resolution neighbourhood of 8 * flow."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(n, 1, 9, 8, 8, h, w), dim=2)
    patches = F.unfold(8.0 * flow, [3, 3], padding=1).reshape(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * patches, dim=2)               # (N, 2, 8, 8, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


class RAFT(nn.Module):
    def __init__(self, update_block: UpdateBlock | None = None):
        super().__init__()
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(HDIM + CDIM, "batch")
        self.update_block = UpdateBlock() if update_block is None else update_block

    def attention(self, inp):
        """Attention over the context features; RAFT has none (GMA does)."""
        return None

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 20):
        """(N, 3, H, W) images in [0, 255], H and W multiples of 8 ->
        (N, 2, H, W) flow from image1 to image2, in pixels."""
        n = image1.shape[0]
        fmaps = self.fnet(torch.cat([image1, image2]) / 255.0 * 2.0 - 1.0)
        pyramid = corr_pyramid(fmaps[:n], fmaps[n:])
        cnet = self.cnet(image1 / 255.0 * 2.0 - 1.0)
        net, inp = torch.tanh(cnet[:, :HDIM]), F.relu(cnet[:, HDIM:])
        attention = self.attention(inp)
        _, _, h, w = cnet.shape
        coords0 = coords_grid(n, h, w, image1.device)
        coords1 = coords0
        for _ in range(iters):
            corr = corr_lookup(pyramid, coords1)
            net, delta = self.update_block(net, inp, corr, coords1 - coords0, attention)
            coords1 = coords1 + delta
        return upsample_flow(coords1 - coords0, 0.25 * self.update_block.mask(net))


FLOW_HEAD_GAIN = 0.1


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded weights in place, drawn as the JAX package's `make_params`
    draws them (each convolution normal with std sqrt(2 / fan_in) and zero
    bias; norms at their initial weight 1, bias 0, running mean 0 and
    variance 1), except that the flow head's last convolution is scaled
    by FLOW_HEAD_GAIN. At the full gain each iteration steps tens of
    pixels and the iteration is chaotic: the reference's own 20-iteration
    flow moves by about a pixel under a 1e-7 relative change of its input
    (tests/test_torch_raft.py). At 0.1 a step is a few pixels, as a
    trained network's are, and the iteration is stable."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * math.sqrt(2.0 / fan_in))
                if m.bias is not None:
                    m.bias.zero_()
        model.update_block.flow_head.conv2.weight.mul_(FLOW_HEAD_GAIN)
    return model


# ---------------------------------------------------------------------------
# Weights and the provider
# ---------------------------------------------------------------------------


def checkpoint_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The state dict, in the port's names, of a RAFT or GMA weights file:
    the JAX package's `.npz` pytree, or a `.pth` state dict of the original
    networks (`module.` prefixes stripped; batch-norm step counts and GMA's
    unused relative-position embeddings `att.pos_emb.*` left out)."""
    if path.endswith(".npz"):
        from fourdgs_torch.convert import flow_state_dict
        from fourdgs_torch.perception.weights_io import load_pytree_npz

        return flow_state_dict(load_pytree_npz(path)[0])
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked") and not k.startswith("att.pos_emb.")}


def load_state(model: nn.Module, sd: dict[str, torch.Tensor]) -> nn.Module:
    """Load `sd` into `model`. Only the instance norms' affine may be
    missing (the original networks' instance norms have none, which is
    weight 1 and bias 0); any other missing or extra key raises."""
    missing, unexpected = model.load_state_dict(sd, strict=False)
    affine_free = {k for k in model.state_dict()
                   if isinstance(model.get_submodule(k.rsplit(".", 1)[0]), Norm2d)
                   and not model.get_submodule(k.rsplit(".", 1)[0]).batch}
    if unexpected or set(missing) - affine_free:
        raise ValueError(f"weights do not fit {type(model).__name__}: missing "
                         f"{sorted(set(missing) - affine_free)[:6]}, unexpected "
                         f"{sorted(unexpected)[:6]}")
    return model


def pad_to_multiple(img: torch.Tensor, mult: int = 8):
    """Pad (N, C, H, W) at the bottom and right by edge replication to
    multiples of `mult`; returns it and the original (H, W)."""
    h, w = img.shape[-2:]
    return F.pad(img, (0, (-w) % mult, 0, (-h) % mult), mode="replicate"), (h, w)


class RaftFlowProvider:
    """(uid1, uid2, img1, img2) -> (fwd, bwd) pixel flows (H, W, 2) of the
    two frames' colour images (3, H, W) in [0, 1]: fwd = flow(img2 ->
    img1), bwd = flow(img1 -> img2) (perception/flow.py). The network runs
    on `device`; the flows come back to the host."""

    name = "raft"
    default_iters = 20

    def __init__(self, weights_path: str | None = None, iters: int | None = None,
                 device=None):
        from fourdgs_torch.perception.flow import network_weights

        self.device = resolve_device(device)
        path = network_weights(self.name) if weights_path is None else weights_path
        if path is None:
            raise FileNotFoundError(f"{self.name}-things weights not found")
        self.model = self.build(checkpoint_state_dict(path)).to(self.device).eval()
        self.iters = self.default_iters if iters is None else iters

    def build(self, sd) -> nn.Module:
        return load_state(RAFT(), sd)

    def flow(self, a, b) -> torch.Tensor:
        """(H, W, 2) pixel flow from image `a` to image `b`, on the device."""
        t = lambda img: torch.as_tensor(img, dtype=torch.float32,  # noqa: E731
                                        device=self.device)[None] * 255.0
        x1, (h, w) = pad_to_multiple(t(a))
        x2, _ = pad_to_multiple(t(b))
        with torch.inference_mode(), full_float32():
            flow = self.model(x1, x2, iters=self.iters)
        return flow[0, :, :h, :w].permute(1, 2, 0)

    def __call__(self, uid1, uid2, img1, img2):
        return (np.ascontiguousarray(self.flow(img2, img1).cpu().numpy()),
                np.ascontiguousarray(self.flow(img1, img2).cpu().numpy()))
