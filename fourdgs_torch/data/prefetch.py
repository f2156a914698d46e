"""Frame iteration onto the device (port of fourdgs/data/prefetch.py).

A plain generator stands in for the reference's prefetch thread. Reading
a recorded frame (two PNG decodes) takes milliseconds against the
hundreds of milliseconds that tracking one frame takes on the card, so
there is little to overlap; and reading on the main thread, in order,
segments frame j from the poses tracked up to frame j - 1 in every run,
where the reference's thread, running ahead of tracking, makes the
segmenter's pose depend on timing (ROADMAP §3).
"""

from __future__ import annotations

from typing import Iterator

import torch

from fourdgs_torch.slam.camera import Frame, make_frame
from fourdgs_torch.utils.trace import span


def iter_frames(dataset, edge_threshold: float = 1.1, end: int | None = None, *,
                device: torch.device | str) -> Iterator[tuple[int, Frame]]:
    n = len(dataset) if end is None else min(end, len(dataset))
    denom = max(dataset.num_imgs - 1, 1)
    for idx in range(n):
        with span("fetch"):   # the read (a recording's PNG decode) and the copy to `device`
            image, depth, pose, motion_mask = dataset[idx]
            frame = make_frame(idx, image, depth, pose, time=idx / denom,
                               motion_mask=motion_mask, edge_threshold=edge_threshold,
                               device=device)
        yield idx, frame
