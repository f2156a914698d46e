"""Frame iteration onto the device (port of fourdgs/data/prefetch.py).

A plain generator stands in for the reference's prefetch thread: the
synthetic sequence has no file decode to overlap with tracking, only one
host-to-device copy of each frame.
"""

from __future__ import annotations

from typing import Iterator

import torch

from fourdgs_torch.slam.camera import Frame, make_frame


def iter_frames(dataset, edge_threshold: float = 1.1, end: int | None = None, *,
                device: torch.device | str) -> Iterator[tuple[int, Frame]]:
    n = len(dataset) if end is None else min(end, len(dataset))
    denom = max(dataset.num_imgs - 1, 1)
    for idx in range(n):
        image, depth, pose, motion_mask = dataset[idx]
        yield idx, make_frame(idx, image, depth, pose, time=idx / denom,
                              motion_mask=motion_mask, edge_threshold=edge_threshold,
                              device=device)
