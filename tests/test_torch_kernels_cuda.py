"""The hand-written CUDA compositor kernels against their plain torch
versions, on the card. Marked `cuda`; without a CUDA device every test
skips. On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest`: tests/conftest.py configures JAX, which these tests do not
use.) The criterion is `fourdgs_torch.kernel_check.hold`, the one
chip_smoke.py applies: the forward's outputs, each pixel's last applied
pair and n_touched equal to the plain version's exactly (the kernels
repeat its arithmetic operation for operation, and their cull skips only
invalid (pixel, pair) combinations); gradients within 1e-5 of each
field's largest magnitude, since the kernel sums over pixels in another
order and with atomics."""

import numpy as np
import pytest
import torch

from fourdgs_torch import kernel_check as KC
from fourdgs_torch.geometry import projection_matrix, se3_exp
from fourdgs_torch.ops.rasterize import compositor as C
from fourdgs_torch.ops.rasterize import kernels as K
from fourdgs_torch.ops.rasterize.api import screen_fields
from fourdgs_torch.ops.rasterize.binning import TileBins
from fourdgs_torch.ops.rasterize.compositor import TileGrid

pytestmark = pytest.mark.cuda

W, H = 90, 60   # partial edge tiles in both directions
KW = dict(fx=70.0, fy=70.0, width=W, height=H, tan_fovx=W / 140.0, tan_fovy=H / 140.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fields(dev, views, seed=0, n=300, n_flow=0):
    """Field table and bins of `views` views of a random scene with dense
    overlap in the middle (pixels there terminate at T < 1e-4). The last
    `n_flow` views carry 4D mapping's flow payload in their colour
    channels: signed values and a 0/1 dynamic flag."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.1, 1.1, n),
                      rng.uniform(2.0, 6.0, n)], -1)
    means[: n // 3, :2] = rng.normal(0, 0.1, (n // 3, 2))
    scales = np.exp(rng.uniform(np.log(0.03), np.log(0.4), (n, 3)))
    quats = rng.normal(size=(n, 4))
    opac = rng.uniform(0.2, 1.0, n)
    opac[:5] = 1.0                      # alpha clamps at 0.99
    colors = np.repeat(rng.uniform(0, 1, (1, n, 3)), views, 0)
    if n_flow:
        colors[views - n_flow:, :, :2] = rng.uniform(-0.1, 0.1, (n_flow, n, 2))
        colors[views - n_flow:, :, 2] = rng.uniform(size=n) < 0.25
    alive = rng.uniform(size=n) > 0.05
    taus = rng.normal(0, 0.03, (views, 6))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    _, fields, bins, grid = screen_fields(
        t(means), t(scales), t(quats / np.linalg.norm(quats, axis=1, keepdims=True)), t(opac),
        t(colors), torch.tensor(alive, device=dev), se3_exp(t(taus)),
        projection_matrix(70.0, 70.0, (W - 1) / 2, (H - 1) / 2, W, H, device=dev), **KW)
    return fields.detach().contiguous(), bins, grid


def _hand_made(dev, rows_per_view, tiles_pairs, grid):
    """fields (V, N+1, 10) from per-view rows (N, 10) and a zero pad row;
    bins whose tile t of every view holds the ids tiles_pairs[t] in order."""
    rows = np.asarray(rows_per_view, np.float32)
    v, n = rows.shape[:2]
    fields = torch.tensor(np.concatenate([rows, np.zeros((v, 1, 10), np.float32)], 1),
                          device=dev)
    counts = np.tile([len(p) for p in tiles_pairs], v)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)  # noqa: E731
    bins = TileBins(pair_gid=i32(sum(tiles_pairs, []) * v), tile_start=i32(starts),
                    tile_count=i32(counts), num_pairs=torch.tensor([int(counts.sum())]),
                    overflow=torch.tensor([False]))
    return fields, bins, grid


def _conic(sx, sy, theta):
    c, s = np.cos(theta), np.sin(theta)
    r = np.array([[c, -s], [s, c]])
    inv = np.linalg.inv(r @ np.diag([sx * sx, sy * sy]) @ r.T)
    return [inv[0, 0], inv[0, 1], inv[1, 1]]


def _check(fields, bins, grid, seed):
    """Both kernels against their plain versions; returns the plain
    results."""
    args = (fields, bins.pair_gid, bins.tile_start, bins.tile_count)
    kw = dict(tiles_per_view=grid.tiles, tx_n=grid.tx_n)
    ref = KC.reference(fields, bins, grid, seed)
    r = KC.hold(lambda: K.composite_fwd(*args, width=grid.width, height=grid.height, **kw),
                lambda out, nc, g: K.composite_bwd(*args, out, nc, g, **kw), ref)
    assert r["ok"], r["err"]
    return ref


@pytest.mark.parametrize("views", [1, 3, 10])
def test_kernels_match_plain_versions(cuda, views):
    fields, bins, grid = _fields(cuda, views)
    ref = _check(fields, bins, grid, seed=views)
    assert (ref.out[:, 4] < 1e-3).any()          # some pixels terminate
    assert (ref.dfields.abs().amax(dim=(0, 1)) > 0).all()


def test_kernels_match_plain_versions_with_flow_payloads(cuda):
    # the full 4D mapping window: 10 RGB views and 16 flow views
    fields, bins, grid = _fields(cuda, 26, seed=26, n_flow=16)
    assert float(fields[10:, :, 7:9].min()) < 0 < float(fields[10:, :, 7:9].max())
    ref = _check(fields, bins, grid, seed=26)
    assert float(ref.out[10 * grid.tiles:, :2].min()) < 0     # signed composites
    assert (ref.dfields.abs().amax(dim=(0, 1)) > 0).all()


@pytest.mark.parametrize("views", [1, 10])
def test_tile_longer_than_two_batches(cuda, views):
    # 600 faint pairs in tile 0 (no pixel terminates: 0.99^600 > 1e-4), so
    # both kernels walk three shared-memory batches; tile 1 is empty
    rng = np.random.default_rng(views)
    n = 600
    rows = []
    for _ in range(views):
        r = np.zeros((n, 10), np.float32)
        r[:, 0], r[:, 1] = rng.uniform(-4, 20, n), rng.uniform(-4, 20, n)
        r[:, 2:5] = [_conic(a, b, th) for a, b, th in zip(rng.uniform(0.6, 6, n),
                                                         rng.uniform(0.6, 6, n),
                                                         rng.uniform(0, np.pi, n))]
        r[:, 5] = np.sort(rng.uniform(1, 5, n))
        r[:, 6] = rng.uniform(0.005, 0.01, n)
        r[:, 7:] = rng.uniform(0, 1, (n, 3))
        rows.append(r)
    grid = TileGrid(2, 1, 32, 16)
    fields, bins, grid = _hand_made(cuda, rows, [list(range(n)), []], grid)
    ref = _check(fields, bins, grid, seed=views)
    out_p, nc_p = ref.out, ref.n_contrib
    tiles = out_p.shape[0]
    assert int(nc_p[0::2].max()) > 2 * 256       # walked past two batches
    assert torch.all(out_p[1::2, 4] == 1.0) and torch.all(nc_p[1::2] == 0)
    assert tiles == 2 * views


@pytest.mark.parametrize("views", [1, 10])
def test_thin_splats_on_warp_block_edges(cuda, views):
    # splats 0.55 px thin, along x, y and the diagonals, centred on and
    # beside the edges of the warps' 8x4 pixel blocks; a 40x44 image has
    # partial tiles on its right and bottom
    rng = np.random.default_rng(10 + views)
    centres = [(x, y) for x in (7.0, 7.5, 8.0, 15.5, 16.0, 23.9, 24.0, 39.0)
               for y in (3.0, 3.5, 4.0, 7.5, 8.0, 11.9, 12.0, 43.0)]
    n = len(centres)
    grid = TileGrid(3, 3, 40, 44)
    rows = []
    for _ in range(views):
        r = np.zeros((n, 10), np.float32)
        r[:, :2] = np.asarray(centres) + rng.normal(0, 0.01, (n, 2))
        r[:, 2:5] = [_conic(rng.uniform(3, 30), np.sqrt(0.3), th)
                     for th in rng.choice([0, np.pi / 2, np.pi / 4, -np.pi / 4], n)]
        r[:, 5] = rng.uniform(1, 5, n)
        r[:, 6] = rng.uniform(0.3, 1.0, n)
        r[:, 7:] = rng.uniform(0, 1, (n, 3))
        rows.append(r)
    order = list(np.argsort(rows[0][:, 5]))
    fields, bins, grid = _hand_made(cuda, rows, [order] * grid.tiles, grid)
    _check(fields, bins, grid, seed=views)


def test_composite_launches_the_kernels_on_cuda(cuda):
    fields, bins, grid = _fields(cuda, 2, seed=1)
    fields.requires_grad_(True)
    fwd0, bwd0 = (dict(k.launches_by_views) for k in (K.composite_fwd, K.composite_bwd))
    out, _ = C.composite(fields, bins, grid)
    out.sum().backward()
    assert K.composite_fwd.launches_by_views == {**fwd0, 2: fwd0.get(2, 0) + 1}
    assert K.composite_bwd.launches_by_views == {**bwd0, 2: bwd0.get(2, 0) + 1}
    assert torch.isfinite(fields.grad).all()
    with pytest.raises(ValueError):
        K.composite_fwd(fields.detach().double(), bins.pair_gid, bins.tile_start,
                        bins.tile_count, tiles_per_view=grid.tiles, tx_n=grid.tx_n,
                        width=W, height=H)
    assert K.composite_fwd.launches_by_views == {**fwd0, 2: fwd0.get(2, 0) + 1}
