# Frozen copy of fourdgs_torch/ops/rasterize/compositor.py (lines 1-286,
# commit c19f610): the port's plain path, kept as the benchmark's
# reference. Changed: `composite_forward` and `composite_backward` run the
# plain versions on every device, and the kernels module is not imported.
"""Tile compositor: the forward and backward of front-to-back alpha
compositing over binned (tile, Gaussian) pairs (port of
fourdgs/ops/rasterize/tile_kernel.py).

`composite` is a `torch.autograd.Function` over a per-view field table
(V, N+1, 10) with columns [mx, my, ca, cb, cc, depth, op, r, g, b]; row N
of each view is the zero pad row. In this copy its forward and backward
run the plain torch versions below on every device (the port launches
its CUDA kernels on CUDA tensors instead).

The plain versions compute the same function with the same outputs, step
by step in the kernels' order: a loop over each tile's pairs, vectorised
over (tile, pixel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.ops.rasterize.binning import TileBins
from benchmark.reference.ops.rasterize.preprocess import ALPHA_MAX, ALPHA_MIN, T_EPS

F_MX, F_MY, F_CA, F_CB, F_CC, F_DEPTH, F_OP, F_R, F_G, F_B = range(10)
NUM_FIELDS = 10       # fields of a Gaussian row
NOUT = 5              # per-pixel outputs: r, g, b, depth, T_final
TILE = 16             # the kernels are written for 16x16 tiles
NPIX = TILE * TILE


class TileGrid(NamedTuple):
    """The tile geometry of one view."""

    tx_n: int
    ty_n: int
    width: int
    height: int

    @property
    def tiles(self) -> int:
        return self.tx_n * self.ty_n


def _pixels(vt: int, grid: TileGrid, device):
    """(VT, 256) pixel x/y of every tile's pixels, and the in-image mask."""
    t = torch.arange(vt, device=device) % grid.tiles
    lin = torch.arange(NPIX, device=device)
    ix = ((t % grid.tx_n) * TILE)[:, None] + (lin % TILE)[None]
    iy = ((t // grid.tx_n) * TILE)[:, None] + (lin // TILE)[None]
    inside = (ix < grid.width) & (iy < grid.height)
    return ix.to(torch.float32), iy.to(torch.float32), inside


KB = 32  # pairs per vectorised block of the plain versions


def _pair_block(fields, bins, k0, kb, px, py, grid):
    """Pairs k0 .. k0+kb-1 of every tile: field rows f (VT, kb, 10) (the
    pad row where a tile has fewer pairs), flat row ids (VT, kb), and the
    per-pixel dx, dy, raw, alpha, valid (VT, kb, 256). Same expression
    order as composite_common.cuh."""
    dev = fields.device
    n1 = fields.shape[1]
    vt = bins.tile_start.shape[0]
    k = torch.arange(k0, k0 + kb, device=dev)
    has = k[None] < bins.tile_count[:, None]
    idx = torch.clamp(bins.tile_start.long()[:, None] + k[None],
                      max=max(bins.pair_gid.shape[0] - 1, 0))
    gid = torch.where(has, bins.pair_gid[idx].long(), torch.full_like(idx, n1 - 1))
    rows = (torch.arange(vt, device=dev) // grid.tiles)[:, None] * n1 + gid
    f = fields.reshape(-1, NUM_FIELDS)[rows]
    col = lambda i: f[..., i:i + 1]  # noqa: E731
    dx = col(F_MX) - px[:, None]
    dy = col(F_MY) - py[:, None]
    power = -0.5 * (col(F_CA) * dx * dx + col(F_CC) * dy * dy) - col(F_CB) * dx * dy
    raw = col(F_OP) * torch.exp(power)
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    valid = (power <= 0.0) & (alpha >= ALPHA_MIN) & has[..., None]
    return f, rows, dx, dy, raw, alpha, valid


def _inv_one_minus(alpha):
    return 1.0 / torch.clamp(1.0 - alpha, min=1e-6)


# margins of the kernels' cull (composite_common.cuh, which derives them)
EXTENT_COND = 64.0 / 2**24   # float32 rounding of power, per unit of condition number
EXTENT_DET = 8.0 / 2**24     # float32 rounding of ca cc - cb^2, relative to ca cc
EXTENT_LOG = 1e-5            # expf's, logf's and the products' rounding, in log space
EXTENT_REL = 1e-5            # relative widening of the half-widths


def _round_out(x: torch.Tensor, down: bool) -> torch.Tensor:
    """float64 -> float32, rounded toward -inf (down) or +inf."""
    f = x.float()
    inward = f.double() > x if down else f.double() < x
    return torch.where(inward, torch.nextafter(f, torch.full_like(f, -1.0 if down else 1.0)
                                               * float("inf")), f)


def pair_extent(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernels' cull (`pair_extent` in
    composite_common.cuh, the same float32 steps), which the kernels use
    and the CPU path does not. For field rows (..., 10), the box (..., 4)
    [x_lo, x_hi, y_lo, y_hi] in pixel coordinates, float32, outside which
    the pair is invalid at every pixel: ±inf (no cull) where a field is not
    finite or the conic is not positive definite or too ill-conditioned; an
    empty box (lo > hi) where op < 1/255."""
    f = rows.detach().to(torch.float32)
    mx, my, ca, cb, cc, op = (f[..., i] for i in (F_MX, F_MY, F_CA, F_CB, F_CC, F_OP))
    c = lambda v: torch.tensor(v, dtype=torch.float32, device=f.device)  # noqa: E731
    alpha_min = c(ALPHA_MIN)
    cacc = ca * cc
    det = (cacc - cb * cb) - c(EXTENT_DET) * cacc
    shrink = 1.0 - c(EXTENT_COND) * (cacc / det)
    tau = 2.0 * (torch.clamp(torch.log(op / alpha_min), min=0.0) + c(EXTENT_LOG)) / shrink
    hx = (torch.sqrt(tau * cc / det) * (1.0 + c(EXTENT_REL)) + 1.0).double()
    hy = (torch.sqrt(tau * ca / det) * (1.0 + c(EXTENT_REL)) + 1.0).double()
    box = torch.stack([_round_out(mx.double() - hx, True), _round_out(mx.double() + hx, False),
                       _round_out(my.double() - hy, True), _round_out(my.double() + hy, False)],
                      dim=-1)
    inf = c([-1.0, 1.0, -1.0, 1.0]) * float("inf")
    finite = torch.stack([mx, my, ca, cb, cc, op]).isfinite().all(0)
    none = finite & (op * (1.0 + c(EXTENT_REL)) < alpha_min)
    cull = finite & ~none & (ca > 0) & (cc > 0) & (det > 0) & (shrink >= 0.5)
    box = torch.where(cull[..., None], box, inf)
    return torch.where(none[..., None], -inf, box)


def composite_forward_plain(fields: torch.Tensor, bins: TileBins, grid: TileGrid):
    """Plain version of composite_fwd.cu. Returns (out (V*T, 5, 256),
    n_contrib (V*T, 256) int32, n_touched (V, N+1) int32).

    Per-pair quantities are computed a block of pairs at a time; the
    transmittance recurrence runs pair by pair, in the kernel's order."""
    v, n1, _ = fields.shape
    vt = bins.tile_start.shape[0]
    dev = fields.device
    px, py, inside = _pixels(vt, grid, dev)
    zero = torch.zeros((vt, NPIX), dtype=torch.float32, device=dev)
    cum, acc_r, acc_g, acc_b, acc_d = zero, zero, zero, zero, zero
    done = ~inside
    last = torch.zeros((vt, NPIX), dtype=torch.int32, device=dev)
    n_touched = torch.zeros(v * n1, dtype=torch.int32, device=dev)
    kmax = int(bins.tile_count.max()) if vt else 0
    for k0 in range(0, kmax, KB):
        kb = min(KB, kmax - k0)
        f, rows, _, _, _, alpha, valid = _pair_block(fields, bins, k0, kb, px, py, grid)
        la = torch.log1p(-alpha)
        inv = _inv_one_minus(alpha)
        counted = torch.zeros_like(valid)
        for j in range(kb):
            vj = valid[:, j] & ~done
            cum_new = cum + la[:, j]
            t_incl = torch.exp(cum_new)
            applied = vj & (t_incl >= T_EPS)
            done = done | (vj & (t_incl < T_EPS))
            w = torch.where(applied, alpha[:, j] * (t_incl * inv[:, j]), zero)
            acc_r = acc_r + w * f[:, j, F_R:F_R + 1]
            acc_g = acc_g + w * f[:, j, F_G:F_G + 1]
            acc_b = acc_b + w * f[:, j, F_B:F_B + 1]
            acc_d = acc_d + w * f[:, j, F_DEPTH:F_DEPTH + 1]
            cum = torch.where(applied, cum_new, cum)
            last = torch.where(applied, torch.full_like(last, k0 + j + 1), last)
            counted[:, j] = applied & (t_incl > 0.5)
        n_touched.index_add_(0, rows.reshape(-1),
                             counted.sum(dim=-1, dtype=torch.int32).reshape(-1))
    out = torch.stack([acc_r, acc_g, acc_b, acc_d, torch.exp(cum)], dim=1)
    return out, last, n_touched.reshape(v, n1)


def composite_backward_plain(fields: torch.Tensor, bins: TileBins, grid: TileGrid,
                             out: torch.Tensor, n_contrib: torch.Tensor,
                             grad_out: torch.Tensor) -> torch.Tensor:
    """Plain version of composite_bwd.cu. Returns dfields (V, N+1, 10).

    Walks each tile's pairs back to front, recovering T from T_final and
    carrying the suffix term pair by pair; the per-pair gradients are then
    summed over pixels a block at a time."""
    v, n1, _ = fields.shape
    vt = bins.tile_start.shape[0]
    dev = fields.device
    px, py, _ = _pixels(vt, grid, dev)
    g = [c[:, None] for c in grad_out.unbind(1)]   # g_r, g_g, g_b, g_d, g_tf
    zero = torch.zeros((vt, NPIX), dtype=torch.float32, device=dev)
    T = out[:, 4]
    suffix = grad_out[:, 4] * out[:, 4]
    dfields = torch.zeros((v * n1, NUM_FIELDS), dtype=torch.float32, device=dev)
    kmax = int(bins.tile_count.max()) if vt else 0
    for k0 in reversed(range(0, kmax, KB)):
        kb = min(KB, kmax - k0)
        f, rows, dx, dy, raw, alpha, valid = _pair_block(fields, bins, k0, kb, px, py, grid)
        col = lambda i: f[..., i:i + 1]  # noqa: E731
        k = torch.arange(k0, k0 + kb, device=dev)
        valid = valid & (k[None, :, None] < n_contrib[:, None])
        inv = _inv_one_minus(alpha)
        u = g[0] * col(F_R) + g[1] * col(F_G) + g[2] * col(F_B) + g[3] * col(F_DEPTH)
        dalpha = torch.zeros_like(alpha)
        w = torch.zeros_like(alpha)
        for j in reversed(range(kb)):
            vj = valid[:, j]
            t_before = T * inv[:, j]
            wj = alpha[:, j] * t_before
            dalpha[:, j] = torch.where(vj, u[:, j] * t_before - suffix * inv[:, j], zero)
            w[:, j] = torch.where(vj, wj, zero)
            suffix = torch.where(vj, suffix + wj * u[:, j], suffix)
            T = torch.where(vj, t_before, T)
        dalpha = torch.where(raw < ALPHA_MAX, dalpha, torch.zeros_like(dalpha))
        dpower = raw * dalpha
        s0 = dpower.sum(-1)
        op = f[..., F_OP]
        grads = torch.stack([
            (dpower * -(col(F_CA) * dx + col(F_CB) * dy)).sum(-1),
            (dpower * -(col(F_CC) * dy + col(F_CB) * dx)).sum(-1),
            (-0.5 * dpower * dx * dx).sum(-1),
            (-dpower * dx * dy).sum(-1),
            (-0.5 * dpower * dy * dy).sum(-1),
            (g[3] * w).sum(-1),
            torch.where(op > 1e-12, s0 / op, torch.zeros_like(s0)),
            (g[0] * w).sum(-1),
            (g[1] * w).sum(-1),
            (g[2] * w).sum(-1),
        ], dim=-1)
        dfields.index_add_(0, rows.reshape(-1), grads.reshape(-1, NUM_FIELDS))
    return dfields.reshape(v, n1, NUM_FIELDS)


def composite_forward(fields, bins: TileBins, grid: TileGrid):
    """Forward compositor: the plain version on every device."""
    return composite_forward_plain(fields, bins, grid)


def composite_backward(fields, bins: TileBins, grid: TileGrid, out, n_contrib,
                       grad_out):
    """Backward compositor: the plain version on every device."""
    return composite_backward_plain(fields, bins, grid, out, n_contrib, grad_out)


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fields, bins, grid):
        out, n_contrib, n_touched = composite_forward(fields, bins, grid)
        ctx.save_for_backward(fields, out, n_contrib)
        ctx.bins, ctx.grid = bins, grid
        ctx.mark_non_differentiable(n_touched)
        return out, n_touched

    @staticmethod
    def backward(ctx, g_out, _g_nt):
        fields, out, n_contrib = ctx.saved_tensors
        dfields = composite_backward(
            fields, ctx.bins, ctx.grid, out, n_contrib, g_out.contiguous()
        )
        return dfields, None, None


def composite(fields: torch.Tensor, bins: TileBins, grid: TileGrid):
    """fields (V, N+1, 10) + bins of V views -> (per-tile outputs
    (V*T, 5, 256) [r, g, b, depth, T_final], n_touched (V, N+1) int32).
    Differentiable with respect to `fields`."""
    if fields.dim() != 3 or fields.shape[-1] != NUM_FIELDS:
        raise ValueError(f"fields must be (V, N+1, {NUM_FIELDS}), got {tuple(fields.shape)}")
    return _Composite.apply(fields.contiguous(), bins, grid)
