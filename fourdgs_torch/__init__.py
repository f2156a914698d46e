"""fourdgs_torch — the PyTorch/CUDA port of the `fourdgs` SLAM system.

The package mirrors the layout of `fourdgs/` so that each module's
counterpart is found under the same path. It imports torch, numpy and the
standard library only: never JAX, and nothing of `fourdgs`.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`. On a CUDA tensor the tile compositor launches the
hand-written kernels of `ops/rasterize/csrc/` (built with nvcc at first
use into `_build/`); on a CPU tensor it runs their plain torch versions.

Subpackages:
  geometry    SE(3)/SO(3), projection, quaternions, spherical harmonics
  ops         rasterizer (preprocess, binning, compositor), knn, image ops
  models      fixed-capacity Gaussian map with masked Adam, deformation field
  slam        tracking, mapping (and colour refinement), keyframes, cadence,
              losses, runner
  data        synthetic RGB-D sequence; TUM (and Bonn) and CoFusion loaders
  perception  RAFT and GMA optical flow, synthetic optical flow,
              forward-backward masks, .npz weight files, the geometric
              motion segmenter
  eval        ATE with its trajectory artifacts, rendering metrics, LPIPS
  io          PLY export, checkpoints
  utils       config (YAML with inherit_from), logging, random draws
and `cli.py`, the command line (`python -m fourdgs_torch.cli`).
"""

__version__ = "0.1.0"
