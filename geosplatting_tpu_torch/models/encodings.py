"""Triplane encoding (counterpart of ``geosplatting_tpu/models/encodings.py``'s
``TriplaneEncoding``): three orthogonal [R, R, C] feature planes sampled
bilinearly with the JAX package's own floor/clamp index math (not
``F.grid_sample``, whose edge handling differs) and summed, as the stage-1
field reduces them."""
from __future__ import annotations

import torch
from torch import nn

from ..ops.segment_rows import gather_rows


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


def triplane_features(planes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Planes [3, R, R, C] at x [..., 3] in [-1, 1] -> summed features
    [..., C]."""
    return (_sample_plane(planes[0], x[..., [0, 1]]) + _sample_plane(planes[1], x[..., [0, 2]])
            + _sample_plane(planes[2], x[..., [1, 2]]))


class TriplaneEncoding(nn.Module):
    def __init__(
        self,
        resolution: int = 32,
        num_components: int = 64,
        init_scale: float = 0.1,
        *,
        generator: torch.Generator | None = None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        planes = torch.empty((3, resolution, resolution, num_components), device=device)
        with torch.no_grad():
            planes.normal_(0.0, 1.0, generator=generator).mul_(init_scale)
        self.planes = nn.Parameter(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., 3] in [-1, 1] -> features [..., C]."""
        return triplane_features(self.planes, x)
