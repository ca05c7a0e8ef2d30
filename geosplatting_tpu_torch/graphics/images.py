"""Image math: the exact sRGB transfer curve, alpha compositing, tone
mapping, resizing and depth -> pseudo-normals.

Counterpart of ``geosplatting_tpu/graphics/images.py`` (``srgb2rgb``,
``rgb2srgb``, ``blend``, ``blend_random``, ``tonemap_aces``,
``tonemap_naive``, ``resize``, ``depth_to_normals``). Images are
``[..., H, W, C]`` tensors. ``blend_random`` draws its background from a
``torch.Generator`` or takes it injected; ``resize`` is
``F.interpolate``'s antialiased bilinear (``jax.image.resize``'s "linear",
which antialiases when it shrinks) or half-pixel nearest.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def blend(rgba: torch.Tensor, background: torch.Tensor) -> torch.Tensor:
    """Composite premultiplied [..., H, W, 4] over a background colour
    [..., 3] (one a batch entry) or [3]."""
    rgb, a = rgba[..., :3], rgba[..., 3:4]
    if background.dim() > 1:
        background = background[..., None, None, :]
    return rgb + (1.0 - a) * background


def blend_random(rgba: torch.Tensor, generator: torch.Generator | None = None, *,
                 background: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite over a uniform random background colour [..., 3], one a
    batch entry, drawn from ``generator`` unless ``background`` gives it.
    Returns (rgb, background)."""
    if background is None:
        background = torch.rand(rgba.shape[:-3] + (3,), generator=generator,
                                device=rgba.device)
    return blend(rgba, background), background


def tonemap_aces(x: torch.Tensor) -> torch.Tensor:
    """ACES filmic approximation (Narkowicz), clamped to [0, 1]."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tonemap_naive(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def resize(img: torch.Tensor, height: int, width: int, method: str = "linear") -> torch.Tensor:
    """Resize [..., H, W, C] to [..., height, width, C]: "linear" (bilinear,
    antialiased when shrinking) or "nearest" (half-pixel centres)."""
    modes = {"linear": dict(mode="bilinear", antialias=True, align_corners=False),
             "nearest": dict(mode="nearest-exact")}
    if method not in modes:
        raise ValueError(f"resize method {method!r}: one of {sorted(modes)}")
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    x = img.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(height, width), **modes[method])
    return out.permute(0, 2, 3, 1).reshape(lead + (height, width, c))


def depth_to_normals(depth: torch.Tensor, fx, fy) -> torch.Tensor:
    """Pseudo-normals [..., H, W, 3] of a depth map [..., H, W] from central
    differences (wrapping at the borders) in camera space."""
    dzdx = (torch.roll(depth, -1, -1) - torch.roll(depth, 1, -1)) * 0.5
    dzdy = (torch.roll(depth, -1, -2) - torch.roll(depth, 1, -2)) * 0.5
    n = torch.stack((-dzdx * fx, -dzdy * fy, torch.ones_like(depth)), -1)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-8)
