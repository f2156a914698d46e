"""Collectives over one process group, built on `allreduce` and
`broadcast` alone.

Those two are what gloo offers for CUDA tensors as well as for CPU ones,
so the same code runs on gloo (CPU ranks, and ranks that share one card,
which NCCL refuses) and on NCCL (one card per rank). `all_gather` and
`psum_scatter` are tiled along dimension 0, as `jax.lax.all_gather(...,
tiled=True)` and `jax.lax.psum_scatter(..., tiled=True)` are:

  all_gather:   each rank's (n, ...) block, placed at rank * n in a zeros
                buffer of (size * n, ...), summed (x + 0 is exact),
  psum_scatter: the sum of every rank's (size * n, ...) tensor, of which
                each rank keeps block `rank`.

Every collective waits for its result. `Comm.local` is a group of one,
whose collectives return their input: the mapping loops run on one device
through it. `stats` counts, per primitive
(`allreduce`, `broadcast`), the calls, the bytes of their tensors (and
the largest one's) and the seconds spent in them on the host's clock,
the device synchronised before and after on CUDA so that the time is
the collective's own.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


class Comm:
    """One rank's end of a process group: `group` (a gloo or NCCL
    backend), this rank's index and the group's size; `device` is where
    this rank's tensors live."""

    def __init__(self, group, rank: int, size: int, device: torch.device):
        self.group, self.rank, self.size = group, rank, size
        self.device = torch.device(device)
        self.stats = {op: {"calls": 0, "bytes": 0, "largest": 0, "seconds": 0.0}
                      for op in ("allreduce", "broadcast")}

    @classmethod
    def local(cls, device) -> "Comm":
        """A group of one rank and no process group: every collective
        returns its input."""
        return cls(None, 0, 1, device)

    def sync(self):
        """Wait for this rank's device work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, op: str, collective, t: torch.Tensor) -> torch.Tensor:
        # bool travels as uint8, which every backend reduces and sends
        buf = t.contiguous()
        if buf.dtype == torch.bool:
            buf = buf.view(torch.uint8)
        self.sync()
        t0 = time.perf_counter()
        collective(buf).wait()
        self.sync()
        st = self.stats[op]
        st["seconds"] += time.perf_counter() - t0
        st["calls"] += 1
        nbytes = buf.numel() * buf.element_size()
        st["bytes"] += nbytes
        st["largest"] = max(st["largest"], nbytes)
        return buf.view(torch.bool) if t.dtype == torch.bool else buf

    def _allreduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return t
        opts = dist.AllreduceOptions()
        opts.reduceOp = op
        return self._run("allreduce", lambda b: self.group.allreduce([b], opts), t.clone())

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of `t` over the ranks, the same bits on
        every rank."""
        return self._allreduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of `t` over the ranks."""
        if t.dtype == torch.bool:
            return self._allreduce(t.to(torch.uint8), dist.ReduceOp.MAX).to(torch.bool)
        return self._allreduce(t, dist.ReduceOp.MAX)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `t` on every rank (`t` gives the shape and dtype
        elsewhere)."""
        if self.size == 1:
            return t
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        opts.rootTensor = 0
        return self._run("broadcast", lambda b: self.group.broadcast([b], opts), t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's (n, ...) `t` concatenated along dimension 0 in rank
        order: (size * n, ...)."""
        n = t.shape[0]
        full = t.new_zeros((self.size * n,) + tuple(t.shape[1:]))
        full[self.rank * n:(self.rank + 1) * n] = t
        return self.psum(full)

    def block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of `t` along dimension 0, which the ranks split
        evenly."""
        if t.shape[0] % self.size:
            raise ValueError(f"dimension 0 ({t.shape[0]}) is not a multiple of {self.size}")
        n = t.shape[0] // self.size
        return t[self.rank * n:(self.rank + 1) * n]

    def psum_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Block `rank` (along dimension 0) of the sum of every rank's
        (size * n, ...) `t`."""
        return self.block(self.psum(t))


def exercise(comm: Comm, per_rank: torch.Tensor) -> dict:
    """Every collective on rank r's block `per_rank[r]` (per_rank: (size,
    size * n, ...)), each result all-gathered so that every rank returns
    the same: `psum`, `pmax`, `all_gather` and `psum_scatter` of the
    blocks, each against its one-process definition by the caller."""
    mine = per_rank[comm.rank]
    return {"psum": comm.psum(mine), "pmax": comm.pmax(mine),
            "all_gather": comm.all_gather(mine),
            "psum_scatter": comm.all_gather(comm.psum_scatter(mine)),
            "broadcast": comm.broadcast(mine.clone(), src=comm.size - 1)}
