"""Offline map viewer (counterpart of scripts/view_ply.py): load a saved
PLY (either package's, with its dygs channel) and render an orbit of PNGs
through the port's rasterizer:

    python -m fourdgs_torch.view_ply results/.../point_cloud/final/point_cloud.ply \
        [--out DIR] [--frames 24] [--width 640] [--height 480] [--fx 535.4] \
        [--device cuda|cpu]

Frame i is seen from se3_exp([0.3 sin a, 0, 0, 0, a, 0]), a = 0.2 pi i /
frames - 0.05 pi, with the principal point at the image centre and
colours max(C0 f_dc + 0.5, 0), as the reference renders them. Each frame
is one forward launch of the compositor at 1 view. It runs on the CUDA
card unless `--device cpu` is given; without a card it exits non-zero.
`main(argv)` returns the paths written.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from fourdgs_torch.device import resolve_device


def orbit_tau(i: int, frames: int) -> np.ndarray:
    """The se3 tangent of orbit frame i of `frames`."""
    ang = 2 * np.pi * i / frames * 0.1 - 0.05 * np.pi
    return np.asarray([0.3 * np.sin(ang), 0, 0, 0, ang, 0], np.float32)


def render_orbit(data: dict, frames: int, width: int, height: int, fx: float, device):
    """Yield (i, colour (3, H, W) tensor) for each orbit frame of a loaded
    PLY's arrays (io/ply.py `load_gaussians_ply`)."""
    from fourdgs_torch.geometry import projection_matrix, se3_exp, sh0_to_rgb
    from fourdgs_torch.ops.rasterize import rasterize

    def dev(a):
        return torch.as_tensor(np.array(a), device=device)

    n = data["xyz"].shape[0]
    fy = fx
    proj = projection_matrix(fx, fx, (width - 1) / 2, (height - 1) / 2, width, height,
                             device=device)
    xyz, scales = dev(data["xyz"]), torch.exp(dev(data["scaling"]))
    quats, opac = dev(data["rotation"]), torch.sigmoid(dev(data["opacity"]))[:, 0]
    colors = sh0_to_rgb(dev(data["f_dc"]))
    alive = torch.ones(n, dtype=torch.bool, device=device)
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        for i in range(frames):
            T = se3_exp(dev(orbit_tau(i, frames)))
            out = rasterize(xyz, scales, quats, opac, colors, alive, T, proj, bg, fx=fx, fy=fy,
                            width=width, height=height, tan_fovx=width / (2 * fx),
                            tan_fovy=height / (2 * fy))
            yield i, out.color


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description="orbit renders of a saved map (PyTorch/CUDA port)")
    ap.add_argument("ply")
    ap.add_argument("--out", default="results/orbit")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--fx", type=float, default=535.4)
    ap.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"fourdgs_torch.view_ply: {e}") from e
    from PIL import Image

    from fourdgs_torch.io.ply import load_gaussians_ply

    data = load_gaussians_ply(args.ply)
    print(f"loaded {data['xyz'].shape[0]} gaussians ({int(data['dygs'].sum())} dynamic)")
    os.makedirs(args.out, exist_ok=True)
    paths = []
    for i, color in render_orbit(data, args.frames, args.width, args.height, args.fx, device):
        img = np.clip(color.cpu().numpy(), 0, 1).transpose(1, 2, 0)
        paths.append(os.path.join(args.out, f"orbit_{i:03d}.png"))
        Image.fromarray((img * 255).astype(np.uint8)).save(paths[-1])
    print(f"wrote {args.frames} frames to {args.out}")
    return paths


if __name__ == "__main__":
    main()
