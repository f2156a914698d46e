from fourdgs_torch.ops.rasterize.api import RasterConfig, rasterize, rasterize_multi  # noqa: F401
from fourdgs_torch.ops.rasterize.oracle import RenderOutputs, composite_oracle  # noqa: F401
from fourdgs_torch.ops.rasterize.preprocess import ScreenGaussians, preprocess  # noqa: F401
from fourdgs_torch.ops.rasterize.binning import TileBins, bin_gaussians  # noqa: F401
