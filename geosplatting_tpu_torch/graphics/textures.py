"""Texture containers over the cubemap and lat-long ops: ``Texture2D``
(bilinear, clamped), ``TextureLatLng`` (light pdf, conversion to a
cubemap), ``TextureCubeMap`` (downsampling, conversion to lat-long and to
split-sum mips, background render) and ``TextureSplitSum``.

Counterpart of ``geosplatting_tpu/graphics/textures.py``, as dataclasses of
tensors. The split-sum prefilter and lookup take the JAX package's
defaults (the sampled GGX filter, bilinear texels, trilinear mips), which
the port's ``ops/cubemap`` functions are given explicitly.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import cubemap as cm
from ..ops import envshade as es
from . import gmath


@dataclasses.dataclass
class Texture2D:
    data: torch.Tensor   # [H, W, C]

    def sample(self, uv: torch.Tensor) -> torch.Tensor:
        """Bilinear samples at uv in [0, 1]^2, clamped at the border. [..., C]."""
        h, w = self.data.shape[:2]
        fu = uv[..., 0].clamp(0, 1) * w - 0.5
        fv = uv[..., 1].clamp(0, 1) * h - 0.5
        x0 = torch.floor(fu).long().clamp(0, w - 1)
        y0 = torch.floor(fv).long().clamp(0, h - 1)
        x1 = (x0 + 1).clamp(max=w - 1)
        y1 = (y0 + 1).clamp(max=h - 1)
        wx = (fu - x0).clamp(0, 1)[..., None]
        wy = (fv - y0).clamp(0, 1)[..., None]
        d = self.data
        return (d[y0, x0] * (1 - wx) * (1 - wy) + d[y0, x1] * wx * (1 - wy)
                + d[y1, x0] * (1 - wx) * wy + d[y1, x1] * wx * wy)


@dataclasses.dataclass
class TextureLatLng:
    data: torch.Tensor   # [H, W, 3]

    def compute_pdf(self) -> es.LightPdf:
        return es.compute_light_pdf(self.data)

    def sample(self, dirs: torch.Tensor) -> torch.Tensor:
        return Texture2D(data=self.data).sample(gmath.dir_to_latlng_uv(dirs))

    def as_cubemap(self, resolution: int = 512) -> "TextureCubeMap":
        return TextureCubeMap(data=self.sample(cm.texel_directions(resolution,
                                                                   self.data.device)))


@dataclasses.dataclass
class TextureCubeMap:
    data: torch.Tensor   # [6, R, R, 3]

    def sample(self, dirs: torch.Tensor) -> torch.Tensor:
        return cm.sample_cubemap(self.data, dirs)

    def downsample(self) -> "TextureCubeMap":
        return TextureCubeMap(data=cm.downsample(self.data))

    def as_latlng(self, width: int = 512, height: int = 256) -> TextureLatLng:
        from ..models.geosplat_mc import cubemap_to_latlng

        return TextureLatLng(data=cubemap_to_latlng(self.data, height, width))

    def as_splitsum(self, **kw) -> "TextureSplitSum":
        base, mips = cm.prefilter_splitsum(self.data, **{"method": "sampled", **kw})
        return TextureSplitSum(base=base, mips=tuple(mips))

    def render(self, camera) -> torch.Tensor:
        """The environment seen along each pixel's ray. [..., H, W, 3]."""
        _, dirs = camera.generate_rays()
        return self.sample(dirs)


@dataclasses.dataclass
class TextureSplitSum:
    base: torch.Tensor          # [6, r, r, 3] diffuse
    mips: tuple = ()            # [6, R_i, R_i, 3] specular mips
    min_roughness: float = 0.08
    max_roughness: float = 0.5

    def sample(self, normals, directions, roughness):
        return cm.sample_splitsum(
            self.base, list(self.mips), normals, directions, roughness,
            min_roughness=self.min_roughness, max_roughness=self.max_roughness,
            filter_mode="bilinear", mip_filter="trilinear")
