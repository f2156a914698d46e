"""fourdgs_torch — the PyTorch/CUDA port of the `fourdgs` SLAM system.

The package mirrors the layout of `fourdgs/` so that each module's
counterpart is found under the same path. It imports torch, numpy and the
standard library only: never JAX, and nothing of `fourdgs`.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`. On a CUDA tensor the tile compositor launches the
hand-written kernels of `ops/rasterize/csrc/` (built with nvcc at first
use into `_build/`); on a CPU tensor it runs their plain torch versions.

Subpackages:
  geometry   SE(3)/SO(3), projection, quaternions, spherical harmonics
  ops        rasterizer (preprocess, binning, compositor), knn, image ops
  models     fixed-capacity Gaussian map with masked Adam
  slam       tracking, mapping, keyframes, cadence, losses, runner
  data       synthetic RGB-D sequence
  eval       ATE and rendering metrics
  utils      config, logging, random draws
"""

__version__ = "0.1.0"
