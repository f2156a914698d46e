"""Perception: optical flow for the 4D path (the exact synthetic provider,
RAFT and GMA, forward-backward consistency masks) and dynamic-object
segmentation of recorded frames (the geometric segmenter)."""

from fourdgs_torch.perception.flow import (  # noqa: F401
    FlowCache,
    compute_fwdbwd_mask,
    normalize_flow,
    warp_flow,
)
