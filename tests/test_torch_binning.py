"""Parity of fourdgs_torch.ops.rasterize.binning with the JAX binner: each
tile's depth-ordered list of Gaussian ids must be identical. On the JAX
side the lists are decoded from the CHUNK-aligned layout (aligned_start,
tile_count, aligned_gid); on the port's from tile_start, tile_count and
pair_gid."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.geometry import projection_matrix as j_proj, se3_exp as j_se3
from fourdgs.ops.rasterize.binning import bin_gaussians as j_bin
from fourdgs_torch.geometry import projection_matrix as t_proj, se3_exp as t_se3
from fourdgs_torch.ops.rasterize.binning import bin_gaussians as t_bin, cat_bins

jpre = importlib.import_module("fourdgs.ops.rasterize.preprocess")
tpre = importlib.import_module("fourdgs_torch.ops.rasterize.preprocess")

W, H = 80, 60
FX = FY = 70.0
KW = dict(fx=FX, fy=FY, width=W, height=H, tan_fovx=W / (2 * FX), tan_fovy=H / (2 * FY))
NUM_TILES = 5 * 4


def _scene(seed, n=150):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.1, 1.1, n),
                      rng.uniform(1.0, 5.0, n)], -1).astype(np.float32)
    means[: n // 10, 2] = means[n // 10: 2 * (n // 10), 2]  # equal depths: ties
    scales = np.exp(rng.uniform(np.log(0.02), np.log(0.4), (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.01, 0.95, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.05
    return means, scales, quats, opac, alive


def _screen(seed, tau):
    means, scales, quats, opac, alive = _scene(seed)
    col = np.zeros_like(means)
    jsg = jpre.preprocess(*map(jnp.asarray, (means, scales, quats, opac, col, alive)),
                          j_se3(jnp.asarray(tau)), j_proj(FX, FY, W / 2, H / 2, W, H),
                          max_radius=24, **KW)
    tsg = tpre.preprocess(*map(torch.tensor, (means, scales, quats, opac, col, alive)),
                          t_se3(torch.tensor(tau)), t_proj(FX, FY, W / 2, H / 2, W, H, device="cpu"),
                          max_radius=24, **KW)
    return jsg, tsg


def _jax_lists(b):
    start, count, gid = (np.asarray(x) for x in (b.aligned_start, b.tile_count, b.aligned_gid))
    return [gid[s:s + c].tolist() for s, c in zip(start, count)]


def _port_lists(b):
    start, count, gid = (x.numpy() for x in (b.tile_start, b.tile_count, b.pair_gid))
    return [gid[s:s + c].tolist() for s, c in zip(start, count)]


TAUS = {"identity": np.zeros(6, np.float32),
        "moved": np.array([0.1, -0.05, 0.2, 0.03, 0.05, -0.02], np.float32)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("pose", sorted(TAUS))
@pytest.mark.parametrize("cull", [True, False])
def test_tile_lists_match(seed, pose, cull):
    jsg, tsg = _screen(seed, TAUS[pose])
    jb = j_bin(jsg.mean2d, jsg.depth, jsg.radius, jsg.visible, width=W, height=H,
               max_pairs=1 << 13, tile_cap=1024,
               opacity=jsg.opacity if cull else None,
               cull_radius=jsg.sigma3 if cull else None)
    tb = t_bin(tsg.mean2d, tsg.depth, tsg.radius, tsg.visible, width=W, height=H,
               max_pairs=1 << 13, opacity=tsg.opacity if cull else None,
               cull_radius=tsg.sigma3 if cull else None)
    assert _port_lists(tb) == _jax_lists(jb)
    assert int(tb.num_pairs[0]) == int(jb.num_pairs)
    assert bool(tb.overflow[0]) == bool(jb.overflow)


def test_overflow_flag_and_multi_view():
    """The port keeps the reference's overflow signal (num_pairs past
    max_pairs) and bins V views into one list with tile ids v*T + t."""
    jsg, tsg = _screen(2, TAUS["moved"])
    tb = t_bin(tsg.mean2d, tsg.depth, tsg.radius, tsg.visible, width=W, height=H,
               max_pairs=8, opacity=tsg.opacity, cull_radius=tsg.sigma3)
    assert int(tb.num_pairs[0]) > 8 and bool(tb.overflow[0])
    _, tsg2 = _screen(3, TAUS["identity"])
    stack = lambda a, b: torch.stack([a, b])  # noqa: E731
    both = t_bin(*(stack(getattr(tsg, f), getattr(tsg2, f))
                   for f in ("mean2d", "depth", "radius", "visible")),
                 width=W, height=H, opacity=stack(tsg.opacity, tsg2.opacity),
                 cull_radius=stack(tsg.sigma3, tsg2.sigma3))
    one = [t_bin(s.mean2d, s.depth, s.radius, s.visible, width=W, height=H,
                 opacity=s.opacity, cull_radius=s.sigma3) for s in (tsg, tsg2)]
    assert _port_lists(both) == _port_lists(one[0]) + _port_lists(one[1])
    assert _port_lists(cat_bins(*one)) == _port_lists(both)
    assert both.num_pairs.tolist() == [int(one[0].num_pairs[0]), int(one[1].num_pairs[0])]
