"""Multiresolution hash-grid deformation network, Instant-NGP style (port
of fourdgs/models/hashgrid.py).

L levels of hashed 3D grids, interpolated trilinearly; their features and
a 9-dim time encoding go through a two-layer MLP into (d_xyz, d_rotation,
d_scaling) heads. The lookups are gathers from plain tensors, so Adam
steps the tables like any other parameter.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from fourdgs_torch.models.hexplane import clip01, to_device

PRIMES = (1, 2654435761, 805459861, 3674653429)
_U32 = 0xFFFFFFFF

BASE_RES = 16
GROWTH = 1.45


class HashGridParams(NamedTuple):
    tables: tuple          # L tensors (T, F)
    head_w1: torch.Tensor
    head_b1: torch.Tensor
    head_w2: torch.Tensor
    head_b2: torch.Tensor
    dx_w: torch.Tensor
    dx_b: torch.Tensor
    ds_w: torch.Tensor
    ds_b: torch.Tensor
    dr_w: torch.Tensor
    dr_b: torch.Tensor
    aabb_min: torch.Tensor
    aabb_max: torch.Tensor


def init_hashgrid(generator: torch.Generator, n_levels: int = 12, features: int = 2,
                  log2_table: int = 17, width: int = 64, time_dim: bool = True,
                  aabb_min=(-2.0, -2.0, -2.0), aabb_max=(2.0, 2.0, 2.0),
                  device="cpu") -> HashGridParams:
    """Tables uniform in +-1e-4, the hidden layers He-normal, the heads
    normal at 1e-5 (scaling 1e-8), biases zero. Drawn from `generator` on
    the CPU, then moved. The grid's resolutions are the module's BASE_RES
    and GROWTH, as in the reference, whose `base_res` and `growth`
    arguments `hash_encode` never reads."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    t = 1 << log2_table
    tables = tuple(torch.rand((t, features), generator=generator) * 2e-4 - 1e-4
                   for _ in range(n_levels))
    feat_dim = n_levels * features + (9 if time_dim else 0)
    hp = HashGridParams(
        tables=tables,
        head_w1=normal((feat_dim, width), math.sqrt(2.0 / feat_dim)), head_b1=torch.zeros(width),
        head_w2=normal((width, width), math.sqrt(2.0 / width)), head_b2=torch.zeros(width),
        dx_w=normal((width, 3), 1e-5), dx_b=torch.zeros(3),
        ds_w=normal((width, 3), 1e-8), ds_b=torch.zeros(3),
        dr_w=normal((width, 4), 1e-5), dr_b=torch.zeros(4),
        aabb_min=torch.tensor(aabb_min, dtype=torch.float32),
        aabb_max=torch.tensor(aabb_max, dtype=torch.float32),
    )
    return to_device(hp, device)


def _hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor, table_size: int) -> torch.Tensor:
    """The spatial hash of int32-range cells: (x p0 ^ y p1 ^ z p2) mod 2^32
    mod table_size, as the reference computes it in uint32. Here in
    int64: an int32 coordinate times a prime below 2^32 stays below 2^63,
    and the low 32 bits of the XOR are those of the uint32 products."""
    h = ((ix.to(torch.int64) * PRIMES[0]) ^ (iy.to(torch.int64) * PRIMES[1])
         ^ (iz.to(torch.int64) * PRIMES[2])) & _U32
    return h % table_size


def hash_encode(hp: HashGridParams, xyz: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N, L*F) trilinearly interpolated hashed features. Level
    l has resolution floor(BASE_RES GROWTH^l) from the module constants,
    as in the reference."""
    norm = clip01((xyz - hp.aabb_min) / (hp.aabb_max - hp.aabb_min))
    feats = []
    for lvl, table in enumerate(hp.tables):
        res = int(np.floor(BASE_RES * (GROWTH ** lvl)))
        x = norm * res
        x0 = torch.floor(x).to(torch.int32)
        d = x - x0
        acc = 0.0
        for cx in range(2):
            for cy in range(2):
                for cz in range(2):
                    idx = _hash3(x0[:, 0] + cx, x0[:, 1] + cy, x0[:, 2] + cz, table.shape[0])
                    w = ((d[:, 0] if cx else 1 - d[:, 0]) * (d[:, 1] if cy else 1 - d[:, 1])
                         * (d[:, 2] if cz else 1 - d[:, 2]))
                    acc = acc + table[idx] * w[:, None]
        feats.append(acc)
    return torch.cat(feats, dim=-1)


def _time_enc(t, n: int, device=None) -> torch.Tensor:
    """9-dim time encoding: [t, sin/cos(2^k pi t)]_{k<4}, (n, 9)."""
    tt = torch.as_tensor(t, dtype=torch.float32, device=device).reshape(1, 1).expand(n, 1)
    freqs = (2.0 ** torch.arange(4, dtype=torch.float32, device=tt.device)) * math.pi
    ang = tt * freqs[None, :]
    return torch.cat([tt, torch.sin(ang), torch.cos(ang)], dim=-1)


def hash_deform(hp: HashGridParams, xyz: torch.Tensor, t):
    """(d_xyz, d_rotation, d_scaling) per point at scalar time t."""
    feat = torch.cat([hash_encode(hp, xyz), _time_enc(t, xyz.shape[0], xyz.device)], dim=-1)
    h = torch.relu(feat @ hp.head_w1 + hp.head_b1)
    h = torch.relu(h @ hp.head_w2 + hp.head_b2)
    return h @ hp.dx_w + hp.dx_b, h @ hp.dr_w + hp.dr_b, h @ hp.ds_w + hp.ds_b
