"""SSIM with the standard 11x11 Gaussian window and the SSIM+L1 photometric
loss (counterpart of ``geosplatting_tpu/ops/ssim.py``).

Images are [..., H, W, C], as in the JAX package. The separable blur runs as
two depthwise ``conv2d`` calls; callers on the card must keep cuDNN out of
TF32 (``torch.backends.cudnn.allow_tf32 = False``) to stay in f32 like the
reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..graphics.gmath import abs_


@functools.lru_cache(maxsize=8)
def _gaussian_window(size: int, sigma: float) -> tuple[float, ...]:
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return tuple((g / g.sum()).astype(np.float32).tolist())


def _blur(img: torch.Tensor, window: tuple[float, ...]) -> torch.Tensor:
    """Separable Gaussian blur of [..., H, W, C] with 'valid' padding."""
    size = len(window)
    batch = img.shape[:-3]
    h, w, c = img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)          # [B, C, H, W]
    k = torch.tensor(window, dtype=img.dtype, device=img.device)
    x = F.conv2d(x, k.view(1, 1, size, 1).expand(c, 1, size, 1), groups=c)
    x = F.conv2d(x, k.view(1, 1, 1, size).expand(c, 1, 1, size), groups=c)
    return x.permute(0, 2, 3, 1).reshape(batch + x.shape[2:] + (c,))


def ssim(pred: torch.Tensor, target: torch.Tensor, *, window_size: int = 11,
         sigma: float = 1.5, data_range: float = 1.0, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over [..., H, W, C] images."""
    window_size = min(window_size, pred.shape[-2], pred.shape[-3])
    window = _gaussian_window(window_size, sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _blur(pred, window)
    mu_y = _blur(target, window)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x = _blur(pred * pred, window) - mu_xx
    sigma_y = _blur(target * target, window) - mu_yy
    sigma_xy = _blur(pred * target, window) - mu_xy
    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return (num / den).mean()


def ssim_l1_loss(pred: torch.Tensor, target: torch.Tensor, *, ssim_lambda: float = 0.2) -> torch.Tensor:
    """lam * (1 - SSIM) + (1 - lam) * L1."""
    l1 = abs_(pred - target).mean()
    return ssim_lambda * (1.0 - ssim(pred, target)) + (1.0 - ssim_lambda) * l1
