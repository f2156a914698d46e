"""The random source of the SLAM path.

Every random draw the runner makes goes through one object with the
methods below, one method per kind of call site, called in the order the
JAX runner consumes its keys (`_next_key`). The modules themselves take
their random numbers as arguments, so a test can hand the port the very
numbers `jax.random` gave the reference by passing a source of its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class TorchDraws:
    """Default source: `torch.Generator`s seeded from `seed`, one on the
    device for bulk draws and one on the host for the replay picks (host
    integers, so picking views needs no device sync)."""

    def __init__(self, seed: int, device: torch.device | str):
        self.device = torch.device(device)
        self._dev = torch.Generator(device=self.device).manual_seed(seed)
        self._host = torch.Generator().manual_seed(seed)

    def uniform(self, n: int) -> torch.Tensor:
        """(n,) uniform [0, 1) — `candidates_from_rgbd`'s downsampling."""
        return torch.rand(n, generator=self._dev, device=self.device)

    def normal2(self, shape) -> tuple[torch.Tensor, torch.Tensor]:
        """Two standard-normal draws of `shape` — `densify_and_prune`'s
        split samples."""
        return (
            torch.randn(shape, generator=self._dev, device=self.device),
            torch.randn(shape, generator=self._dev, device=self.device),
        )

    def replay_picks(self, num_iters: int, pool_size: int) -> np.ndarray:
        """(num_iters, 2) raw replay draws for one `map_chunk`: column 0
        uniform in [0, max(pool_size, 1)), column 1 in
        [0, max(pool_size - 1, 1)); `map_chunk` makes them distinct."""
        size = max(pool_size, 1)
        r1 = torch.randint(0, size, (num_iters,), generator=self._host)
        r2 = torch.randint(0, max(size - 1, 1), (num_iters,), generator=self._host)
        return torch.stack([r1, r2], dim=1).numpy()

    def refine_chunk(self, num_iters: int, pool_len: int) -> np.ndarray:
        """(num_iters, pool_len) uniform [0, 1) host draws for one
        refine-mode `map_chunk`: per iteration one per pool entry, whose
        order picks the views (`refine_picks`)."""
        return torch.rand((num_iters, pool_len), generator=self._host).numpy()

    def fps_start(self, valid: torch.Tensor) -> torch.Tensor:
        """The first control node: a point index drawn uniformly from the
        valid points, on the device (0-d)."""
        return torch.multinomial(valid.to(torch.float32), 1, generator=self._dev)[0]

    def mlp_init(self, dims, head_dims) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """The deformation MLP's initial draws: per hidden layer (d_in,
        d_out) a weight uniform in +-sqrt(6 / d_in), per head output count
        d a standard-normal (width, d) matrix, width being the last layer's
        d_out."""
        ws = [(torch.rand((d_in, d_out), generator=self._dev, device=self.device) * 2.0 - 1.0)
              * math.sqrt(6.0 / d_in) for d_in, d_out in dims]
        width = dims[-1][1]
        heads = [torch.randn((width, d), generator=self._dev, device=self.device)
                 for d in head_dims]
        return ws, heads

    def warmup(self) -> None:
        """The deformation warmup draws nothing; the call keeps a source
        that replays another key chain in step with it."""

    def dynamic_chunk(self, num_iters: int, pool_size: int, num_views: int):
        """One `map_chunk_dynamic`: its replay picks (as `replay_picks`),
        and per iteration and view the regularizers' uniform draws, ARAP's
        (num_iters, num_views, 3) and the elastic term's (num_iters,
        num_views, 9) on the device: each a centre jitter, then its time
        samples."""
        picks = self.replay_picks(num_iters, pool_size)
        arap = torch.rand((num_iters, num_views, 3), generator=self._dev, device=self.device)
        elastic = torch.rand((num_iters, num_views, 9), generator=self._dev, device=self.device)
        return picks, arap, elastic
