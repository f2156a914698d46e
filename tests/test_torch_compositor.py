"""Behaviour of the tile compositor that shows up in results, one test per
rule, on hand-made field tables (CPU: the plain versions of the CUDA
kernels). Field rows are [mx, my, ca, cb, cc, depth, op, r, g, b]; row N
of each view is the zero pad row."""

import numpy as np
import torch

from fourdgs_torch.geometry import projection_matrix
from fourdgs_torch.ops.rasterize.api import rasterize
from fourdgs_torch.ops.rasterize.binning import TileBins
from fourdgs_torch.ops.rasterize.compositor import (
    TileGrid,
    composite,
    composite_backward_plain,
    composite_forward_plain,
)
from fourdgs_torch.ops.rasterize.preprocess import ALPHA_MAX, ALPHA_MIN, T_EPS


def _row(mx=7.5, my=7.5, ca=0.0, cb=0.0, cc=0.0, depth=2.0, op=0.5, rgb=(1.0, 0.5, 0.25)):
    return [mx, my, ca, cb, cc, depth, op, *rgb]


def _one_view(rows, tiles_pairs, grid):
    """fields (1, N+1, 10) with a zero pad row; bins whose tile t holds the
    Gaussian ids tiles_pairs[t] in that order."""
    fields = torch.tensor(rows + [[0.0] * 10], dtype=torch.float32)[None]
    counts = [len(p) for p in tiles_pairs]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    bins = TileBins(
        pair_gid=torch.tensor(sum(tiles_pairs, []), dtype=torch.int32),
        tile_start=torch.tensor(starts), tile_count=torch.tensor(counts, dtype=torch.int32),
        num_pairs=torch.tensor([sum(counts)]), overflow=torch.tensor([False]),
    )
    return fields, bins


GRID1 = TileGrid(1, 1, 16, 16)


def test_alpha_clamped_and_clamp_masked_from_gradient():
    # flat conic -> power = 0 everywhere; op = 1 -> raw 1 clamps to 0.99
    fields, bins = _one_view([_row(op=1.0)], [[0]], GRID1)
    fields.requires_grad_(True)
    out, _ = composite(fields, bins, GRID1)
    np.testing.assert_allclose(out[0, 0].detach().numpy(), ALPHA_MAX * 1.0, rtol=1e-6)
    (g,) = torch.autograd.grad(out[0, :4].sum(), fields)
    # every pixel clamped: no gradient reaches op or the conic/mean ...
    assert torch.all(g[0, 0, [0, 1, 2, 3, 4, 6]] == 0)
    # ... while depth and color still receive alpha * T
    np.testing.assert_allclose(g[0, 0, [5, 7, 8, 9]].numpy(), 256 * ALPHA_MAX, rtol=1e-5)


def test_valid_needs_power_le_0_and_alpha_ge_floor():
    faint = _row(op=ALPHA_MIN * 0.99)
    fields, bins = _one_view([faint], [[0]], GRID1)
    out, nt = composite(fields, bins, GRID1)
    assert torch.all(out[0, 4] == 1.0) and torch.all(out[0, :4] == 0) and nt[0, 0] == 0
    # a non-PSD conic: power > 0 off the mean's row, 0 on it
    fields, bins = _one_view([_row(ca=-1.0, mx=7.0, op=0.5)], [[0]], GRID1)
    out, _ = composite(fields, bins, GRID1)
    t_final = out[0, 4].reshape(16, 16)
    assert torch.all(t_final[:, 7] == 0.5)
    assert torch.all(t_final[:, :7] == 1.0) and torch.all(t_final[:, 8:] == 1.0)


def test_applied_stops_at_transmittance_floor_with_t_before_rule():
    # 20 identical alpha=0.5 pairs: T after k pairs = 0.5^k, and a pair
    # applies while that is >= 1e-4, so exactly 13 apply
    n = 20
    fields, bins = _one_view([_row(op=0.5, depth=1.0 + k) for k in range(n)],
                             [list(range(n))], GRID1)
    out, nt = composite(fields, bins, GRID1)
    _, n_contrib, _ = composite_forward_plain(fields, bins, GRID1)
    applied = int(np.floor(np.log(T_EPS) / np.log(0.5)))
    assert applied == 13 and torch.all(n_contrib == applied)
    t_incl = 0.5 ** np.arange(1, applied + 1)
    w = 0.5 * t_incl / max(1 - 0.5, 1e-6)         # alpha * T_incl / (1 - alpha)
    np.testing.assert_allclose(out[0, 0, 0].item(), w.sum(), rtol=1e-6)
    np.testing.assert_allclose(out[0, 3, 0].item(), (w * (1.0 + np.arange(applied))).sum(),
                               rtol=1e-6)
    np.testing.assert_allclose(out[0, 4, 0].item(), 0.5 ** applied, rtol=1e-5)
    # n_touched: only pair 0 leaves T > 0.5 ... none: T after pair 0 is 0.5
    assert nt[0, :n].sum() == 0


def test_dop_zero_where_op_tiny():
    fields, bins = _one_view([_row(op=0.0), _row(op=0.6, depth=3.0)], [[0, 1]], GRID1)
    fields.requires_grad_(True)
    out, _ = composite(fields, bins, GRID1)
    (g,) = torch.autograd.grad(out[0, :4].sum() + out[0, 4].sum(), fields)
    assert torch.isfinite(g).all()
    assert g[0, 0, 6] == 0 and g[0, 1, 6] != 0


def test_n_touched_counts_in_image_pixels_with_t_above_half():
    # a 20x20 image has 2x2 tiles of 16; the Gaussian covers tile (1, 1)
    # whose in-image part is 4x4 pixels
    grid = TileGrid(2, 2, 20, 20)
    rows = [_row(mx=18.0, my=18.0, op=0.4), _row(mx=18.0, my=18.0, op=0.6)]
    for gid, expect in ((0, 16), (1, 0)):       # T after = 0.6 > 0.5 / 0.4 < 0.5
        fields, bins = _one_view(rows, [[], [], [], [gid]], grid)
        _, nt = composite(fields, bins, grid)
        assert nt[0, gid].item() == expect


def test_empty_tiles_give_unit_transmittance():
    grid = TileGrid(2, 1, 32, 16)
    fields, bins = _one_view([_row(op=0.9)], [[0], []], grid)
    out, _ = composite(fields, bins, grid)
    assert torch.all(out[1, 4] == 1.0) and torch.all(out[1, :4] == 0)
    assert torch.all(out[0, 4] < 1.0)


def test_pad_row_never_contributes():
    # tiles with fewer pairs than the longest tile read the pad row (id N)
    # in the plain version; whatever it holds, it must change nothing
    grid = TileGrid(2, 1, 32, 16)
    rows = [_row(op=0.5), _row(mx=20.0, op=0.7), _row(mx=21.0, op=0.3, depth=4.0)]
    fields, bins = _one_view(rows, [[0], [1, 2]], grid)
    out, nt = composite(fields, bins, grid)
    dirty = fields.clone()
    dirty[0, -1] = torch.tensor(_row(op=0.9))
    out2, nt2 = composite(dirty, bins, grid)
    assert torch.equal(out, out2) and torch.equal(nt[:, :3], nt2[:, :3])
    g = torch.rand_like(out)
    _, n_contrib, _ = composite_forward_plain(fields, bins, grid)
    d1 = composite_backward_plain(fields, bins, grid, out, n_contrib, g)
    d2 = composite_backward_plain(dirty, bins, grid, out2, n_contrib, g)
    assert torch.equal(d1[:, :3], d2[:, :3])


def test_background_added_as_t_final_times_bg():
    rng = np.random.default_rng(0)
    n = 12
    scene = [torch.tensor(a) for a in (
        np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.4, 0.4, n),
                  rng.uniform(2, 4, n)], -1).astype(np.float32),
        np.full((n, 3), 0.1, np.float32), np.tile([[1.0, 0, 0, 0]], (n, 1)).astype(np.float32),
        np.full(n, 0.6, np.float32), rng.uniform(0, 1, (n, 3)).astype(np.float32),
        np.ones(n, bool))]
    kw = dict(fx=40.0, fy=40.0, width=40, height=30, tan_fovx=0.5, tan_fovy=0.375)
    proj = projection_matrix(40.0, 40.0, 19.5, 14.5, 40, 30, device="cpu")
    bg = torch.tensor([0.2, 0.4, 0.6])
    a = rasterize(*scene, torch.eye(4), proj, bg, **kw)
    b = rasterize(*scene, torch.eye(4), proj, torch.zeros(3), **kw)
    np.testing.assert_allclose((a.color - b.color).numpy(),
                               (a.T_final[None] * bg[:, None, None]).numpy(), atol=1e-7)
    assert torch.all(a.alpha == 1.0 - a.T_final)
