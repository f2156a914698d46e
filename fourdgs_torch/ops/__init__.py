from fourdgs_torch.ops.image import (  # noqa: F401
    image_gradient,
    image_gradient_mask,
    grad_intensity_mask,
    ssim,
    dilate3x3,
)
from fourdgs_torch.ops.knn import knn_mean_sq_dist  # noqa: F401
