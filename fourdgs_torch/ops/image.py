"""Image-space ops: Scharr gradients, gradient masks, SSIM, dilation, PSNR
(port of fourdgs/ops/image.py)."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from fourdgs_torch.utils.trace import sync

# Scharr kernels; the reference names its vertical-edge response (conv with
# the x-kernel) `img_grad_v` — the naming quirk is kept so thresholds
# behave identically
_SCHARR_X = ((3.0, 10.0, 3.0), (0.0, 0.0, 0.0), (-3.0, -10.0, -3.0))
_SCHARR_Y = ((3.0, 0.0, -3.0), (10.0, 0.0, -10.0), (3.0, 0.0, -3.0))
_BOX = ((1.0, 1.0, 1.0),) * 3
_NORMALIZER = 1.0 / 32.0


def _conv3x3(img: torch.Tensor, kernel, pad_mode: str = "reflect") -> torch.Tensor:
    """Depthwise 3x3 cross-correlation on (C, H, W), reflect (or zero)
    padded."""
    c = img.shape[0]
    with sync("image.kernel_h2d"):
        k = torch.tensor(kernel, dtype=img.dtype, device=img.device)
    k = k[None, None].expand(c, 1, 3, 3)
    p = F.pad(img[None], (1, 1, 1, 1), mode=pad_mode)
    return F.conv2d(p, k, groups=c)[0]


def image_gradient(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, H, W) -> (grad_v, grad_h), Scharr filtered, reflect padded."""
    return (
        _NORMALIZER * _conv3x3(image, _SCHARR_X),
        _NORMALIZER * _conv3x3(image, _SCHARR_Y),
    )


def image_gradient_mask(image: torch.Tensor, eps: float = 0.01):
    """Valid-gradient masks: True where the full 3x3 window has |pix|>eps."""
    ind = (torch.abs(image) > eps).to(torch.float32)
    mask = _conv3x3(ind, _BOX) == 9.0
    return mask, mask


def grad_intensity_mask(image: torch.Tensor, edge_threshold: float) -> torch.Tensor:
    """Median-thresholded Scharr edge mask used for tracking-pixel
    selection. image: (C, H, W) in [0,1]. Returns bool (1, H, W)."""
    gray = torch.mean(image, dim=0, keepdim=True)
    gv, gh = image_gradient(gray)
    mv, mh = image_gradient_mask(gray)
    gv = gv * mv
    gh = gh * mh
    intensity = torch.sqrt(gv**2 + gh**2)
    med = torch.quantile(intensity, 0.5)  # the mean of the two middle values, like jnp.median
    return intensity > med * edge_threshold


def dilate3x3(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Binary dilation with a 3x3 structuring element on (H, W) bool."""
    m = mask.to(torch.float32)[None]
    for _ in range(iterations):
        m = torch.clamp(_conv3x3(m, _BOX, pad_mode="constant"), 0.0, 1.0)
    return m[0] > 0.0


@functools.lru_cache(maxsize=4)
def _gaussian_window(window_size: int, sigma: float) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32) - window_size // 2
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over a (C, H, W) pair, or (V,) per pair of (V, C, H, W)
    batches; 11x11 Gaussian window, zero ('SAME') padding."""
    batched = img1.dim() == 4
    x1, x2 = (img1, img2) if batched else (img1[None], img2[None])
    c = x1.shape[1]
    win = _gaussian_window(window_size, sigma).to(img1.device)
    k = win[None, None].expand(c, 1, window_size, window_size)

    def filt(x):
        return F.conv2d(x, k, padding=window_size // 2, groups=c)

    mu1 = filt(x1)
    mu2 = filt(x2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(x1 * x1) - mu1_sq
    sigma2_sq = filt(x2 * x2) - mu2_sq
    sigma12 = filt(x1 * x2) - mu12
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return torch.mean(ssim_map, dim=(1, 2, 3)) if batched else torch.mean(ssim_map)


def psnr(img1: torch.Tensor, img2: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """PSNR over (C, H, W); with a bool pixel mask (H, W) it averages MSE
    over masked pixels only."""
    se = (img1 - img2) ** 2
    if mask is not None:
        m = mask.to(se.dtype)[None]
        mse = torch.sum(se * m) / torch.clamp(torch.sum(m) * img1.shape[0], min=1.0)
    else:
        mse = torch.mean(se)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))
