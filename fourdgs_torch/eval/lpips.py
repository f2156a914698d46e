"""LPIPS (AlexNet) in torch (port of fourdgs/eval/lpips.py).

The five ReLU taps of the AlexNet trunk, each unit-normalised over its
channels, their squared differences weighted by the learned 1x1 linear
heads, averaged over space and summed over the taps (Zhang et al. 2018),
on images in [0, 1] mapped to [-1, 1] and then through the LPIPS scaling
layer: the torchmetrics `normalize=True` convention the reference system
evaluates with.

`load_weights` looks for, in order: the path it is given,
$FOURDGS_LPIPS_WEIGHTS, `pretrained/lpips_alex.npz` and `.pth` under the
working directory, and `pretrained/lpips_alex.npz` at the repository's
root. `.npz` files are those of `save_weights` (either package's);
`.pth` files are state dicts of the public `lpips` package or of
torchmetrics. A file that is found but does not load raises.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from fourdgs_torch.perception.raft import full_float32

# AlexNet trunk: (out channels, kernel, stride, padding, 3x3/2 max pool before)
_ALEX_CONVS = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]
# the LPIPS scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LpipsWeights(NamedTuple):
    conv_w: tuple  # 5x (O, I, k, k)
    conv_b: tuple  # 5x (O,)
    lin_w: tuple   # 5x (1, C, 1, 1)


def random_weights(generator: torch.Generator, device) -> LpipsWeights:
    """Seeded weights drawn as the reference's `random_weights` draws them
    (convolutions normal * 0.05, zero biases, heads uniform in [0, 0.1]):
    for tests and smoke runs, not a perceptual metric."""
    ws, bs, ls = [], [], []
    in_ch = 3
    for out, k, _, _, _ in _ALEX_CONVS:
        ws.append(torch.randn((out, in_ch, k, k), generator=generator) * 0.05)
        bs.append(torch.zeros(out))
        ls.append(torch.rand((1, out, 1, 1), generator=generator) * 0.1)
        in_ch = out
    return LpipsWeights(*(tuple(t.to(device) for t in ts) for ts in (ws, bs, ls)))


def _features(w: LpipsWeights, x: torch.Tensor) -> list[torch.Tensor]:
    taps = []
    for i, (_, _, stride, pad, pool_before) in enumerate(_ALEX_CONVS):
        if pool_before:
            x = F.max_pool2d(x, 3, 2)
        x = F.relu(F.conv2d(x, w.conv_w[i], w.conv_b[i], stride=stride, padding=pad))
        taps.append(x)
    return taps


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


def lpips_pair(w: LpipsWeights, img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
    """LPIPS distance (a 0-d tensor) between two (3, H, W) images in [0, 1]."""
    shift = torch.tensor(_SHIFT, device=img_a.device)[None, :, None, None]
    scale = torch.tensor(_SCALE, device=img_a.device)[None, :, None, None]
    prep = lambda img: (img[None] * 2.0 - 1.0 - shift) / scale  # noqa: E731
    with torch.no_grad(), full_float32():
        fa, fb = _features(w, prep(img_a)), _features(w, prep(img_b))
        total = 0.0
        for a, b, lin in zip(fa, fb, w.lin_w):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            total = total + torch.mean(torch.sum(d * lin, dim=1, keepdim=True), dim=(2, 3))
    return total[0, 0]


def convert_lpips_torch(state_dict, device) -> LpipsWeights:
    """LpipsWeights of an LPIPS(alex) state dict, in the key styles of the
    `lpips` package (net.slice{1..5}.<idx>.*, lin{0..4}.model.1.weight) or
    of torchmetrics (net.features.<idx>.*, lins.<i>.model.1.weight)."""
    conv_idx = [0, 3, 6, 8, 10]   # torchvision alexnet `features` indices

    def find(*cands):
        for c in cands:
            if c in state_dict:
                return torch.as_tensor(state_dict[c], dtype=torch.float32, device=device)
        raise KeyError(f"none of {cands} in the checkpoint ({list(state_dict)[:8]}...)")

    ws, bs, ls = [], [], []
    for i, fi in enumerate(conv_idx):
        for out, leaf in ((ws, "weight"), (bs, "bias")):
            out.append(find(f"net.features.{fi}.{leaf}", f"net.slice{i + 1}.{fi}.{leaf}",
                            f"features.{fi}.{leaf}"))
        ls.append(find(f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight",
                       f"lin.lins.{i}.model.1.weight"))
    return LpipsWeights(tuple(ws), tuple(bs), tuple(ls))


def save_weights(path: str, w: LpipsWeights) -> None:
    arrays = {}
    for i in range(5):
        arrays[f"conv_w.{i}"] = w.conv_w[i].detach().cpu().numpy()
        arrays[f"conv_b.{i}"] = w.conv_b[i].detach().cpu().numpy()
        arrays[f"lin_w.{i}"] = w.lin_w[i].detach().cpu().numpy()
    np.savez(path, **arrays)


def load_weights(path: str | None = None, *, device) -> LpipsWeights | None:
    """The first LPIPS weights file found (see the module's doc) on
    `device`, or None when there is none."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates = [c for c in (path, os.environ.get("FOURDGS_LPIPS_WEIGHTS")) if c] + [
        "pretrained/lpips_alex.npz", "pretrained/lpips_alex.pth",
        os.path.join(root, "pretrained", "lpips_alex.npz")]
    found = next((c for c in candidates if os.path.exists(c)), None)
    if found is None:
        return None
    if found.endswith(".npz"):
        with np.load(found) as data:
            return LpipsWeights(*(tuple(torch.as_tensor(data[f"{f}.{i}"], device=device)
                                        for i in range(5)) for f in LpipsWeights._fields))
    return convert_lpips_torch(torch.load(found, map_location="cpu", weights_only=True), device)
