"""Perception: optical flow for the 4D path (the exact synthetic provider)
and dynamic-object segmentation of recorded frames (the geometric
segmenter)."""
