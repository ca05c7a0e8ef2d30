"""Vanilla 3DGS model: render heads over a ``Splats`` set.

Counterpart of ``geosplatting_tpu/models/gsplatter.py`` (``GSplatter``):
``render_rgba`` / ``render_rgb`` over the pairs rasterizer (K1-K3 on the
card), the background-colour policy (random while training), the SH degree
cap and the colours-as-SH packing (``_colors_and_degree``). The screen-space
gradient that densification reads comes back through ``means2d_offset``.

The ``classic`` and ``antialiased`` modes are ported. ``2dgs`` waits for
``ops/rasterize_2dgs.py`` and ``render_depth`` (the expected-depth mode) for
the depth render modes (ROADMAP A.8, A.6). The JAX model's
``tile_capacity``, ``tile_chunk``, ``chunk_size``, ``backend`` and
``camera_batching`` have no meaning on the pairs path: the pair budget is
``pairs_per_gaussian`` x N.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _kernels
from ..graphics import gmath
from ..graphics.cameras import Cameras
from ..graphics.splats import Splats
from ..ops.rasterize import rasterize

MODES = ("classic", "antialiased")


@dataclasses.dataclass(frozen=True)
class GSplatter:
    """Static render configuration; the Gaussians live in a ``Splats``. On
    the card unless ``device`` names another device (raises without one)."""

    sh_degree: int = 3
    rasterize_mode: str = "classic"      # 'classic' | 'antialiased'
    block_width: int = 16
    background_color: str = "random"     # 'white' | 'black' | 'random'
    pairs_per_gaussian: int = 8
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.rasterize_mode == "2dgs":
            raise NotImplementedError(
                "rasterize_mode='2dgs' needs ops/rasterize_2dgs.py, which is not ported yet "
                "(ROADMAP A.8)")
        if self.rasterize_mode not in MODES:
            raise ValueError(f"unknown rasterize_mode: {self.rasterize_mode}")
        object.__setattr__(self, "device", _kernels.resolve_device(self.device))

    def get_background_color(self, training: bool,
                             generator: torch.Generator | None = None) -> torch.Tensor:
        if self.background_color == "black":
            return torch.zeros(3, device=self.device)
        if self.background_color == "white":
            return torch.ones(3, device=self.device)
        if training:
            return torch.rand(3, generator=generator, device=self.device)
        return torch.tensor([0.1490, 0.1647, 0.2157], device=self.device)

    def _colors_and_degree(self, splats: Splats, max_sh_degree: int | None
                           ) -> tuple[torch.Tensor, int | None]:
        deg = splats.sh_degree if max_sh_degree is None else min(max_sh_degree,
                                                                  splats.sh_degree)
        if deg == 0:
            return splats.colors, None
        colors = torch.cat((gmath.rgb2sh(splats.colors[:, None, :]), splats.shs), dim=-2)
        return colors[:, :gmath.sh_deg2dim(deg), :], deg

    def render_rgba(self, splats: Splats, camera: Cameras, *,
                    max_sh_degree: int | None = None,
                    means2d_offset: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """One camera -> ([H, W, 4] premultiplied rgba, info)."""
        colors, deg = self._colors_and_degree(splats, max_sh_degree)
        render, alpha, info = rasterize(
            splats.means, gmath.safe_normalize(splats.quats), torch.exp(splats.scales),
            torch.sigmoid(splats.opacities[:, 0]), colors, camera.view_matrix,
            camera.intrinsic_matrix, camera.width, camera.height, sh_degree=deg,
            tile_size=self.block_width, pairs_per_gaussian=self.pairs_per_gaussian,
            rasterize_mode=self.rasterize_mode, means2d_offset=means2d_offset,
        )
        return torch.cat((render[..., :3], alpha), -1), info

    def render_rgb(self, splats: Splats, camera: Cameras, background: torch.Tensor, *,
                   max_sh_degree: int | None = None,
                   means2d_offset: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, dict]:
        rgba, info = self.render_rgba(splats, camera, max_sh_degree=max_sh_degree,
                                      means2d_offset=means2d_offset)
        return rgba[..., :3] + (1.0 - rgba[..., 3:4]) * background, info

    def render_depth(self, splats: Splats, camera: Cameras) -> torch.Tensor:
        raise NotImplementedError(
            "render_depth needs the expected-depth render mode of the dense reference "
            "rasterizer, which is not ported yet (ROADMAP A.6)")
