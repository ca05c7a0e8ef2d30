"""Positional, spherical-harmonic and triplane encodings (counterpart of
``geosplatting_tpu/models/encodings.py``): ``PosEncoding`` (NeRF sin / cos
frequencies), ``SHEncoding`` (the real SH basis of a direction, ``degree``
levels) and ``TriplaneEncoding`` (three orthogonal [R, R, C] feature planes
sampled bilinearly with the JAX package's own floor / clamp index math, not
``F.grid_sample``, whose edge handling differs, and reduced by sum, as the
stage-1 field does, or product). The hash encoding is ``ops/hashgrid.py``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..graphics import gmath
from ..ops.segment_rows import gather_rows


class PosEncoding(nn.Module):
    """x [..., D] -> [x,] sin and cos of x * pi * 2^f for ``num_frequencies``
    f from ``min_freq_exp`` to ``max_freq_exp``: [..., D (+) 2 F D]."""

    def __init__(self, num_frequencies: int = 10, min_freq_exp: float = 0.0,
                 max_freq_exp: float = 9.0, include_input: bool = True):
        super().__init__()
        self.num_frequencies = num_frequencies
        self.min_freq_exp = min_freq_exp
        self.max_freq_exp = max_freq_exp
        self.include_input = include_input

    def output_dim(self, input_dim: int) -> int:
        return input_dim * self.num_frequencies * 2 + (input_dim if self.include_input else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        freqs = 2.0 ** torch.linspace(self.min_freq_exp, self.max_freq_exp,
                                      self.num_frequencies, device=x.device)
        scaled = x[..., None, :] * freqs[:, None] * math.pi          # [..., F, D]
        enc = torch.cat((torch.sin(scaled), torch.cos(scaled)), -1).reshape(x.shape[:-1] + (-1,))
        return torch.cat((x, enc), -1) if self.include_input else enc


class SHEncoding(nn.Module):
    """Directions [..., 3] -> the real SH basis of ``degree`` levels (degree
    - 1 at most 3), [..., degree^2]."""

    def __init__(self, degree: int = 4):
        super().__init__()
        self.degree = degree

    def output_dim(self) -> int:
        return self.degree ** 2

    def forward(self, dirs: torch.Tensor) -> torch.Tensor:
        d = gmath.safe_normalize(dirs)
        k = self.output_dim()
        # eval_sh with the identity as coefficients: channel j is basis j
        eye = torch.eye(k, device=d.device).expand(d.shape[:-1] + (k, k))
        return gmath.eval_sh(self.degree - 1, eye, d)


def _sample_plane(plane: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    r = plane.shape[0]
    g = (uv * 0.5 + 0.5) * r - 0.5
    g0 = torch.floor(g).long().clamp(0, r - 1)
    g1 = (g0 + 1).clamp(max=r - 1)
    f = (g - g0).clamp(0, 1)
    texels = plane.reshape(r * r, plane.shape[-1])
    c00 = gather_rows(texels, g0[..., 1] * r + g0[..., 0])
    c01 = gather_rows(texels, g0[..., 1] * r + g1[..., 0])
    c10 = gather_rows(texels, g1[..., 1] * r + g0[..., 0])
    c11 = gather_rows(texels, g1[..., 1] * r + g1[..., 0])
    wx = f[..., 0:1]
    wy = f[..., 1:2]
    return (
        c00 * (1 - wx) * (1 - wy) + c01 * wx * (1 - wy)
        + c10 * (1 - wx) * wy + c11 * wx * wy
    )


def triplane_features(planes: torch.Tensor, x: torch.Tensor, reduce: str = "sum"
                      ) -> torch.Tensor:
    """Planes [3, R, R, C] at x [..., 3] in [-1, 1] -> the three planes'
    features [..., C], summed or multiplied (``reduce``)."""
    fxy = _sample_plane(planes[0], x[..., [0, 1]])
    fxz = _sample_plane(planes[1], x[..., [0, 2]])
    fyz = _sample_plane(planes[2], x[..., [1, 2]])
    return fxy + fxz + fyz if reduce == "sum" else fxy * fxz * fyz


class TriplaneEncoding(nn.Module):
    def __init__(
        self,
        resolution: int = 32,
        num_components: int = 64,
        init_scale: float = 0.1,
        *,
        reduce: str = "sum",
        generator: torch.Generator | None = None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        if reduce not in ("sum", "product"):
            raise ValueError(f"reduce: {reduce!r}")
        self.reduce = reduce
        planes = torch.empty((3, resolution, resolution, num_components), device=device)
        with torch.no_grad():
            planes.normal_(0.0, 1.0, generator=generator).mul_(init_scale)
        self.planes = nn.Parameter(planes)

    @property
    def output_dim(self) -> int:
        return self.planes.shape[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., 3] in [-1, 1] -> features [..., C]."""
        return triplane_features(self.planes, x, self.reduce)
