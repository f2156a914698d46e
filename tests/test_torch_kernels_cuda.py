"""The hand-written CUDA compositor kernels against their plain torch
versions, on the card. Marked `cuda`; without a CUDA device every test
skips. On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest`: tests/conftest.py configures JAX, which these tests do not
use.) Tolerances are the rasterizer's (tests/test_rasterizer.py:140-143,
:199-202): color and T_final 2e-5, depth 2e-4, n_touched and each pixel's
last applied pair exact, gradients 3e-3 of each field's largest
magnitude."""

import numpy as np
import pytest
import torch

from fourdgs_torch.geometry import projection_matrix, se3_exp
from fourdgs_torch.ops.rasterize import compositor as C
from fourdgs_torch.ops.rasterize import kernels as K
from fourdgs_torch.ops.rasterize.api import screen_fields

pytestmark = pytest.mark.cuda

W, H = 80, 60
KW = dict(fx=70.0, fy=70.0, width=W, height=H, tan_fovx=W / 140.0, tan_fovy=H / 140.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fields(dev, views, seed=0, n=300):
    """Field table and bins of `views` views of a random scene with dense
    overlap in the middle (pixels there terminate at T < 1e-4)."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.1, 1.1, n),
                      rng.uniform(2.0, 6.0, n)], -1)
    means[: n // 3, :2] = rng.normal(0, 0.1, (n // 3, 2))
    scales = np.exp(rng.uniform(np.log(0.03), np.log(0.4), (n, 3)))
    quats = rng.normal(size=(n, 4))
    opac = rng.uniform(0.2, 1.0, n)
    opac[:5] = 1.0                      # alpha clamps at 0.99
    colors = rng.uniform(0, 1, (n, 3))
    alive = rng.uniform(size=n) > 0.05
    taus = rng.normal(0, 0.03, (views, 6))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    _, fields, bins, grid = screen_fields(
        t(means), t(scales), t(quats / np.linalg.norm(quats, axis=1, keepdims=True)), t(opac),
        t(colors), torch.tensor(alive, device=dev), se3_exp(t(taus)),
        projection_matrix(70.0, 70.0, (W - 1) / 2, (H - 1) / 2, W, H, device=dev), **KW)
    return fields.detach().contiguous(), bins, grid


@pytest.mark.parametrize("views", [1, 3])
def test_kernels_match_plain_versions(cuda, views):
    fields, bins, grid = _fields(cuda, views)
    args = (fields, bins.pair_gid, bins.tile_start, bins.tile_count)
    kw = dict(tiles_per_view=grid.tiles, tx_n=grid.tx_n)
    out_k, nc_k, nt_k = K.composite_fwd(*args, width=W, height=H, **kw)
    out_p, nc_p, nt_p = C.composite_forward_plain(fields, bins, grid)
    torch.cuda.synchronize()
    assert (out_p[:, 4] < 1e-3).any()          # some pixels terminate
    torch.testing.assert_close(out_k[:, :3], out_p[:, :3], atol=2e-5, rtol=0)
    torch.testing.assert_close(out_k[:, 3], out_p[:, 3], atol=2e-4, rtol=0)
    torch.testing.assert_close(out_k[:, 4], out_p[:, 4], atol=2e-5, rtol=0)
    assert torch.equal(nc_k, nc_p) and torch.equal(nt_k, nt_p)

    g = torch.randn(out_k.shape, generator=torch.Generator(cuda).manual_seed(views),
                    device=cuda)
    d_k = K.composite_bwd(*args, out_k, nc_k, g, **kw)
    d_p = C.composite_backward_plain(fields, bins, grid, out_p, nc_p, g)
    torch.cuda.synchronize()
    scale = d_p.abs().amax(dim=(0, 1))
    assert (scale > 0).all()
    assert ((d_k - d_p).abs().amax(dim=(0, 1)) <= 3e-3 * scale).all()


def test_composite_launches_the_kernels_on_cuda(cuda):
    fields, bins, grid = _fields(cuda, 2, seed=1)
    fields.requires_grad_(True)
    fwd0, bwd0 = K.composite_fwd.launches, K.composite_bwd.launches
    out, _ = C.composite(fields, bins, grid)
    out.sum().backward()
    assert K.composite_fwd.launches == fwd0 + 1
    assert K.composite_bwd.launches == bwd0 + 1
    assert torch.isfinite(fields.grad).all()
    with pytest.raises(ValueError):
        K.composite_fwd(fields.detach().double(), bins.pair_gid, bins.tile_start,
                        bins.tile_count, tiles_per_view=grid.tiles, tx_n=grid.tx_n,
                        width=W, height=H)
    assert K.composite_fwd.launches == fwd0 + 1
