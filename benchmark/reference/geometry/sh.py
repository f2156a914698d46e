# Frozen copy of fourdgs_torch/geometry/sh.py (lines 1-16,
# commit c19f610): the port's plain path, kept as the benchmark's
# reference, unchanged but for its imports, which name these copies.
"""Degree-0 spherical harmonics (port of fourdgs/geometry/sh.py)."""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814


def sh0_to_rgb(f_dc: torch.Tensor) -> torch.Tensor:
    """(..., 3) DC SH coefficients -> RGB in [0, inf), clamped >= 0."""
    return torch.clamp(SH_C0 * f_dc + 0.5, min=0.0)


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / SH_C0
