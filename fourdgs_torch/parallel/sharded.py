"""Sharded mapping step and batch render over a mesh (port of
fourdgs/parallel/sharded.py).

Two shardings compose, as in the reference:
  - data parallelism over views: each rank renders its block of the
    views and the gradients are summed over the ranks,
  - ZeRO-style sharding of the Gaussian state along the capacity axis:
    each rank owns a block of the parameters and Adam moments; a step
    all-gathers the parameters to render, reduce-scatters the gradients
    (`psum_scatter`) to the blocks, and steps each block with a masked
    Adam at eps 1e-15.

The functions take and return whole (unsharded) tensors on rank 0, as a
JAX caller sees global arrays: a rank keeps its blocks for the step and
the step's end gathers them back. The capacity and the number of views
must be multiples of the mesh's size.
"""

from __future__ import annotations

import torch

from fourdgs_torch.models.gaussian_map import GaussianParams, MapLRs
from fourdgs_torch.ops.rasterize.api import RasterConfig, rasterize_multi
from fourdgs_torch.slam.camera import Intrinsics
from fourdgs_torch.slam import mapping
from fourdgs_torch.slam.losses import mapping_loss_rgbd


def _render(params: GaussianParams, alive, poses, intr: Intrinsics, raster: RasterConfig):
    dev = alive.device
    return rasterize_multi(*mapping._activated(params), alive, poses, intr.proj(device=dev),
                           torch.zeros(3, device=dev), config=raster, **intr.raster_kw())


def _step_rank(comm, params: GaussianParams, mu: GaussianParams, nu: GaussianParams, alive,
               count: int, images, depths, poses, intr: Intrinsics, raster: RasterConfig,
               lrs: MapLRs):
    """One rank of `sharded_map_step`."""
    params_l, mu_l, nu_l = (GaussianParams(*(comm.block(x) for x in t))
                            for t in (params, mu, nu))
    alive_l = comm.block(alive)
    full = GaussianParams(*(comm.all_gather(x).requires_grad_(True) for x in params_l))
    alive_full = comm.all_gather(alive_l)
    images_l, depths_l, poses_l = (comm.block(x) for x in (images, depths, poses))
    out = _render(full, alive_full, poses_l, intr, raster)
    loss = torch.sum(mapping_loss_rgbd(out.color, out.depth, images_l, depths_l))
    grads = torch.autograd.grad(loss, list(full))
    with torch.no_grad():
        loss = comm.psum(loss.detach())
        b1, b2, eps = 0.9, 0.999, 1e-15
        t = count + 1
        new_p, new_mu, new_nu = [], [], []
        for name, p, g_full, m1, m2 in zip(GaussianParams._fields, params_l, grads, mu_l, nu_l):
            g = comm.psum_scatter(g_full)
            m1 = b1 * m1 + (1 - b1) * g
            m2 = b2 * m2 + (1 - b2) * g * g
            step = getattr(lrs, name) * (m1 / (1 - b1**t)) / (
                torch.sqrt(m2 / (1 - b2**t)) + eps)
            m = alive_l.to(p.dtype).reshape((-1,) + (1,) * (p.dim() - 1))
            new_p.append(comm.all_gather(p - step * m))
            new_mu.append(comm.all_gather(m1 * m))
            new_nu.append(comm.all_gather(m2 * m))
    return (GaussianParams(*new_p), GaussianParams(*new_mu), GaussianParams(*new_nu), t,
            float(loss))


def sharded_map_step(mesh, intr: Intrinsics, raster: RasterConfig = RasterConfig(),
                     lrs: MapLRs = MapLRs()):
    """A multi-rank mapping step: step(params, mu, nu, alive, count,
    images, depths, poses) -> (params, mu, nu, count + 1, loss), the
    Gaussian state sharded along its capacity over the ranks and the
    views (images (V, 3, H, W), depths (V, H, W), poses (V, 4, 4)) over
    the ranks; the loss is the sum of the views' RGB-D mapping losses."""

    def step(params, mu, nu, alive, count, images, depths, poses):
        return mesh.run(_step_rank, params, mu, nu, alive, int(count), images, depths, poses,
                        intr, raster, lrs)

    return step


def _render_rank(comm, params: GaussianParams, alive, poses, intr: Intrinsics,
                 raster: RasterConfig):
    """One rank of `batch_render_sharded`."""
    with torch.no_grad():
        out = _render(params, alive, comm.block(poses), intr, raster)
        return tuple(comm.all_gather(x) for x in (out.color, out.depth, out.alpha))


def batch_render_sharded(mesh, intr: Intrinsics, raster: RasterConfig = RasterConfig()):
    """A batch render with the cameras sharded over the ranks:
    render(params, alive, poses (V, 4, 4)) -> (colors (V, 3, H, W),
    depths (V, H, W), alphas (V, H, W))."""

    def render(params: GaussianParams, alive, poses):
        return mesh.run(_render_rank, params, alive, poses, intr, raster)

    return render
