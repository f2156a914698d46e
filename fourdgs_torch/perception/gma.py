"""GMA optical flow, RAFT with global motion aggregation, as a torch module
(port of fourdgs/perception/gma.py), at the width of the public
gma-things checkpoint: one attention head of 128 channels, 12 iterations
by default.

The attention is computed once from the context features (`att.to_qk`,
single head, softmax over all positions); each iteration aggregates the
motion features with it (`update_block.aggregator`: `to_v`, an optional
`project`, and the learned residual weight `gamma`, 0 at initialisation),
and the GRU takes context, motion and aggregated motion (384 channels).
Everything else is RAFT's (perception/raft.py)."""

from __future__ import annotations

import torch
from torch import nn

from fourdgs_torch.perception.raft import CDIM, HDIM, RAFT, RaftFlowProvider, UpdateBlock, load_state

DIM_HEAD = 128


class Attention(nn.Module):
    def __init__(self):
        super().__init__()
        self.to_qk = nn.Conv2d(CDIM, 2 * DIM_HEAD, 1, bias=False)

    def forward(self, context):
        """(N, CDIM, H, W) -> (N, HW, HW) attention of each position over
        all positions."""
        q, k = self.to_qk(context).chunk(2, dim=1)
        n, d, h, w = q.shape
        q = q.reshape(n, d, h * w).transpose(1, 2) * d ** -0.5
        return torch.softmax(torch.matmul(q, k.reshape(n, d, h * w)), dim=-1)


class Aggregate(nn.Module):
    def __init__(self, project: bool = False):
        super().__init__()
        self.to_v = nn.Conv2d(HDIM, DIM_HEAD, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.project = nn.Conv2d(DIM_HEAD, HDIM, 1, bias=False) if project else None

    def forward(self, attention, motion):
        """Motion features plus gamma times their attention-weighted sum."""
        v = self.to_v(motion)
        n, c, h, w = v.shape
        out = torch.matmul(attention, v.reshape(n, c, h * w).transpose(1, 2))
        out = out.transpose(1, 2).reshape(n, c, h, w)
        if self.project is not None:
            out = self.project(out)
        return motion + self.gamma * out


class GMA(RAFT):
    def __init__(self, project: bool = False):
        super().__init__(UpdateBlock(Aggregate(project)))
        self.att = Attention()

    def attention(self, inp):
        return self.att(inp)


class GmaFlowProvider(RaftFlowProvider):
    """The RAFT provider's interface over GMA (12 iterations by default)."""

    name = "gma"
    default_iters = 12

    def build(self, sd) -> nn.Module:
        return load_state(GMA(project="update_block.aggregator.project.weight" in sd), sd)
