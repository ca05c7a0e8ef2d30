"""Image math: the exact sRGB transfer curve, alpha compositing, tone
mapping, resizing and depth -> pseudo-normals.

Counterpart of ``geosplatting_tpu/graphics/images.py`` (``srgb2rgb``,
``rgb2srgb``, ``blend``, ``blend_random``, ``tonemap_aces``,
``tonemap_naive``, ``resize``, ``depth_to_normals``, ``psnr``). Images are
``[..., H, W, C]`` tensors. ``blend_random`` draws its background from a
``torch.Generator`` or takes it injected. ``resize`` takes every method
``jax.image.resize`` takes and resamples as it does (antialiased when it
shrinks): a separable resample by one [out, in] weight matrix an axis, for
the linear, Keys cubic (a = -0.5, not ``F.interpolate``'s -0.75) and
Lanczos kernels, or a gather at half-pixel centres for "nearest".
"""
from __future__ import annotations

import math

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


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _lanczos(radius: float):
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x * x, 1.0), 1.0)
        return torch.where(x > radius, 0.0, out)
    return kernel


# jax.image.ResizeMethod.from_string's names
RESIZE_KERNELS = {
    **dict.fromkeys(("linear", "bilinear", "trilinear", "triangle"), _triangle),
    **dict.fromkeys(("cubic", "bicubic", "tricubic"), _keys_cubic),
    "lanczos3": _lanczos(3.0),
    "lanczos5": _lanczos(5.0),
}


def _resize_weights(in_size: int, out_size: int, kernel, device=None) -> torch.Tensor:
    """[in, out] weights of one axis, as ``jax.image.scale_and_translate``
    builds them: half-pixel centres, the kernel widened by 1 / scale when
    shrinking (antialiasing), each output's weights normalised, and outputs
    whose sample falls outside the input zeroed."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale
              - 0.5)
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]
         ).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    return torch.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], w, 0.0)


def _nearest_index(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """Source rows of "nearest": floor((i + 0.5) in / out) in float32, with
    in / out folded into one float32 constant, in x (1 / out), as the
    compiled ``jax.image.resize`` folds it (an exact quotient such as 16
    can come out as 15.999999 there)."""
    scale = torch.ones((), dtype=torch.float32, device=device) / out_size * in_size
    pos = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * scale
    return torch.floor(pos).long()


def resize(img: torch.Tensor, height: int, width: int, method: str = "linear") -> torch.Tensor:
    """Resize [..., H, W, C] to [..., height, width, C] as ``jax.image.resize``
    does with its default ``antialias=True``: "nearest", or a separable
    resample by the kernel of any other name in ``RESIZE_KERNELS`` ("linear",
    "cubic", "lanczos3", "lanczos5" and their aliases). An axis whose size
    stays is left as it is."""
    if method != "nearest" and method not in RESIZE_KERNELS:
        raise ValueError(f"resize method {method!r}: 'nearest' or one of "
                         f"{sorted(RESIZE_KERNELS)}")
    h, w = img.shape[-3:-1]
    out = img
    for axis, size, new in ((-3, h, height), (-2, w, width)):
        if size == new:
            continue
        if method == "nearest":
            out = out.index_select(axis, _nearest_index(size, new, img.device))
        else:
            weights = _resize_weights(size, new, RESIZE_KERNELS[method], img.device)
            out = torch.movedim(torch.tensordot(out.movedim(axis, -1).to(weights.dtype), weights,
                                                dims=1), -1, axis)
    return out


def depth_to_normals(depth: torch.Tensor, fx, fy) -> torch.Tensor:
    """Pseudo-normals [..., H, W, 3] of a depth map [..., H, W] from central
    differences (wrapping at the borders) in camera space."""
    dzdx = (torch.roll(depth, -1, -1) - torch.roll(depth, 1, -1)) * 0.5
    dzdy = (torch.roll(depth, -1, -2) - torch.roll(depth, 1, -2)) * 0.5
    n = torch.stack((-dzdx * fx, -dzdy * fy, torch.ones_like(depth)), -1)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-8)


def psnr(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))
