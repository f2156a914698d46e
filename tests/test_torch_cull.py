"""The compositor kernels' cull (`pair_extent` in
fourdgs_torch/ops/rasterize/csrc/composite_common.cuh, plain version
`compositor.pair_extent`) removes only invalid (pixel, pair) combinations:
over seeded conics, every pixel where `_pair_block` finds a pair valid lies
inside the pair's extent. The kernels skip a pair for a warp whose pixels
all lie outside it, so a pixel outside it must never be valid. Adversarial
cases: thin rotated splats, op at 1/255 and one ulp on either side, op = 1
(alpha clamped), conics that are not positive definite, ill-conditioned
conics, and NaN."""

import numpy as np
import pytest
import torch

from fourdgs_torch.ops.rasterize import compositor as C
from fourdgs_torch.ops.rasterize.binning import TileBins
from fourdgs_torch.ops.rasterize.compositor import TileGrid, pair_extent
from fourdgs_torch.ops.rasterize.preprocess import ALPHA_MIN

GRID = TileGrid(4, 4, 64, 64)
AM = np.float32(ALPHA_MIN)
INF = float("inf")


def _conic(sx, sy, theta):
    """(ca, cb, cc) of the inverse of R diag(sx^2, sy^2) R^T."""
    c, s = np.cos(theta), np.sin(theta)
    r = np.array([[c, -s], [s, c]])
    inv = np.linalg.inv(r @ np.diag([sx * sx, sy * sy]) @ r.T)
    return inv[0, 0], inv[0, 1], inv[1, 1]


def _rows(mx, my, conics, op):
    n = len(mx)
    rows = np.zeros((n, 10), np.float32)
    rows[:, 0], rows[:, 1] = mx, my
    rows[:, 2:5] = np.asarray(conics, np.float32).reshape(n, 3)
    rows[:, 5], rows[:, 6], rows[:, 7:] = 2.0, op, 0.5
    return rows


def _valid_and_inside(rows):
    """valid (T, n, 256) from _pair_block with every tile holding every
    pair, and whether each pixel lies inside each pair's extent."""
    n = rows.shape[0]
    fields = torch.tensor(np.concatenate([rows, np.zeros((1, 10), np.float32)]))[None]
    t = GRID.tiles
    bins = TileBins(
        pair_gid=torch.arange(n, dtype=torch.int32).repeat(t),
        tile_start=torch.arange(t, dtype=torch.int32) * n,
        tile_count=torch.full((t,), n, dtype=torch.int32),
        num_pairs=torch.tensor([n * t]), overflow=torch.tensor([False]),
    )
    px, py, _ = C._pixels(t, GRID, "cpu")
    *_, valid = C._pair_block(fields, bins, 0, n, px, py, GRID)
    box = pair_extent(fields[0, :n])                       # (n, 4)
    x, y = px.double()[:, None], py.double()[:, None]       # (T, 1, 256)
    inside = ((x >= box[None, :, 0, None]) & (x <= box[None, :, 1, None])
              & (y >= box[None, :, 2, None]) & (y <= box[None, :, 3, None]))
    return valid, inside, box


def _assert_sound(rows):
    valid, inside, box = _valid_and_inside(rows)
    bad = valid & ~inside
    assert not bad.any(), f"{int(bad.sum())} valid (pixel, pair) outside the extent"
    return valid, inside, box


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extent_holds_every_valid_pixel_and_culls(seed):
    rng = np.random.default_rng(seed)
    n = 200
    sx = np.exp(rng.uniform(np.log(0.55), np.log(12.0), n))
    sy = np.exp(rng.uniform(np.log(0.55), np.log(12.0), n))
    conics = [_conic(a, b, th) for a, b, th in zip(sx, sy, rng.uniform(0, np.pi, n))]
    rows = _rows(rng.uniform(-10, 74, n), rng.uniform(-10, 74, n), conics,
                 rng.uniform(0.005, 1.0, n))
    valid, inside, box = _assert_sound(rows)
    assert valid.any()
    # the cull has teeth: most (pixel, pair) combinations lie outside, and
    # the box is within a pixel and a hair of the ellipse's own box
    assert inside.float().mean() < 0.5
    ca, cb, cc, op = (rows[:, i].astype(np.float64) for i in (2, 3, 4, 6))
    det = ca * cc - cb * cb
    tau = 2 * np.maximum(np.log(op / np.float64(AM)), 0)
    half = np.sqrt(tau * cc / det)
    np.testing.assert_array_less((box[:, 1] - box[:, 0]).numpy() / 2, half * 1.001 + 1.01)


@pytest.mark.parametrize("long_sigma", [8.0, 40.0, 200.0])
def test_thin_rotated_splats(long_sigma):
    # the 0.3 px^2 low-pass floor makes the short axis ~0.55 px; angles near
    # the diagonal make cb nearly cancel ca cc in det
    rng = np.random.default_rng(int(long_sigma))
    n = 120
    theta = np.concatenate([np.full(n // 2, np.pi / 4) + rng.normal(0, 1e-3, n // 2),
                            rng.uniform(0, np.pi, n - n // 2)])
    conics = [_conic(long_sigma, np.sqrt(0.3), th) for th in theta]
    rows = _rows(rng.uniform(0, 64, n), rng.uniform(0, 64, n), conics,
                 rng.uniform(0.3, 1.0, n))
    valid, _, box = _assert_sound(rows)
    assert valid.any()
    assert torch.isfinite(box).all()   # conditioned well enough to cull


def test_op_at_the_alpha_floor():
    # means on pixel centres so power = 0 there: alpha = op exactly
    ops = np.array([np.nextafter(AM, np.float32(0)), AM, np.nextafter(AM, np.float32(1)),
                    AM * np.float32(1.5)], np.float32)
    rng = np.random.default_rng(3)
    n = 64
    op = np.tile(ops, n // 4)
    conics = [_conic(a, a, 0.0) for a in rng.uniform(0.6, 6.0, n)]
    rows = _rows(rng.integers(0, 64, n).astype(np.float32),
                 rng.integers(0, 64, n).astype(np.float32), conics, op)
    valid, _, box = _assert_sound(rows)
    per_pair = valid.any(dim=(0, 2)).numpy()
    assert not per_pair[op < AM].any()              # below the floor: nowhere valid
    assert per_pair[op >= AM].all()                 # at it: valid at the mean
    # far below the floor the extent is empty
    (empty,) = pair_extent(torch.tensor(_rows([5.0], [5.0], [_conic(2, 2, 0)], AM * 0.9)))
    assert empty[0] > empty[1] and empty[2] > empty[3]


def test_op_one_clamps_alpha():
    rng = np.random.default_rng(4)
    n = 80
    conics = [_conic(a, b, th) for a, b, th in zip(rng.uniform(0.6, 10, n),
                                                  rng.uniform(0.6, 10, n),
                                                  rng.uniform(0, np.pi, n))]
    rows = _rows(rng.uniform(0, 64, n), rng.uniform(0, 64, n), conics, np.ones(n))
    valid, _, _ = _assert_sound(rows)
    assert valid.any()


@pytest.mark.parametrize("case", ["det_zero", "det_negative", "ca_negative", "flat",
                                  "cond_5e5", "cond_3e7"])
def test_no_cull_where_the_conic_is_not_positive_definite(case):
    # cond_5e5: float32 power's rounding could exceed half of tau (shrink);
    # cond_3e7: ca cc - cb^2 is below its own float32 rounding (det)
    conic = {"det_zero": (1.0, 0.5, 0.25), "det_negative": (0.2, 0.5, 0.3),
             "ca_negative": (-1.0, 0.0, 0.5), "flat": (0.0, 0.0, 0.0),
             "cond_5e5": _conic(390.0, 0.55, np.pi / 4),
             "cond_3e7": _conic(3000.0, 0.55, np.pi / 4)}[case]
    rows = _rows([20.3, 40.0], [30.7, 10.0], [conic, conic], [0.8, 0.8])
    valid, _, box = _assert_sound(rows)
    assert valid.any() and torch.equal(box.abs(), torch.full_like(box, INF))


@pytest.mark.parametrize("field", [0, 1, 2, 3, 4, 6])
def test_no_cull_where_a_field_is_nan(field):
    rows = _rows([20.3, 40.0], [30.7, 10.0], [_conic(3, 2, 0.3)] * 2, [0.8, 0.8])
    rows[0, field] = np.nan
    valid, _, box = _assert_sound(rows)
    assert torch.equal(box[0].abs(), torch.full((4,), INF))
    assert not valid[:, 0].any() and valid[:, 1].any()
