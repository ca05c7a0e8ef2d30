"""The loss library: L1 / L2, image PSNR, masked and HDR L1, and the
re-exports of SSIM (+ L1), chamfer and F-score.

Counterpart of ``geosplatting_tpu/train/losses.py``.
"""
from __future__ import annotations

import torch

from ..ops.chamfer import chamfer_distance, f_score  # noqa: F401 (re-export)
from ..ops.ssim import ssim, ssim_l1_loss  # noqa: F401 (re-export)


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = ((pred - target) ** 2).mean()
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean L1 over the pixels where mask > 0, per channel of ``pred``."""
    w = (mask > 0).to(pred.dtype)
    return ((pred - target).abs() * w).sum() / torch.clamp(
        w.sum() * pred.shape[-1] / max(mask.shape[-1], 1), min=1.0)


def hdr_l1(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """L1 of the logs, robust to the large radiance range of HDR targets."""
    return (torch.log(torch.clamp(pred, min=0) + eps)
            - torch.log(torch.clamp(target, min=0) + eps)).abs().mean()
