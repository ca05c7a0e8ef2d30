"""Exact sRGB transfer curve (counterpart of
``geosplatting_tpu/graphics/images.py``: srgb2rgb / rgb2srgb)."""
from __future__ import annotations

import torch


def srgb2rgb(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB-encoded [0,1] -> linear radiance (exact IEC curve)."""
    srgb = srgb.clamp(0.0, 1.0)
    return torch.where(srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4)


def rgb2srgb(rgb: torch.Tensor) -> torch.Tensor:
    """Linear radiance [0,1] -> sRGB encoding (exact IEC curve)."""
    rgb = rgb.clamp(0.0, 1.0)
    return torch.where(
        rgb <= 0.0031308,
        rgb * 12.92,
        1.055 * torch.clamp(rgb, min=1e-8) ** (1.0 / 2.4) - 0.055,
    )
