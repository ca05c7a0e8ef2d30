"""Vanilla 3DGS / 2DGS model: render heads over a ``Splats`` set.

Counterpart of ``geosplatting_tpu/models/gsplatter.py`` (``GSplatter``):
``render_rgba`` / ``render_rgb`` / ``render_depth``, the background-colour
policy (random while training), the SH degree cap and the colours-as-SH
packing (``_colors_and_degree``). The screen-space gradient that
densification reads comes back through ``means2d_offset``.

The ``classic`` and ``antialiased`` modes render on the pairs rasterizer
(K1-K3 on the card), whose pair budget is ``pairs_per_gaussian`` x N;
``2dgs`` renders through ``ops/rasterize_2dgs.py`` on the dense tile table,
whose ``tile_capacity`` cuts each tile to its front Gaussians and whose
``tile_chunk`` (at most 4, as in the JAX model) sizes its chunks on the
CPU. ``camera_batching="vmap"`` renders a batch of cameras through
``rasterize_batched`` (``rasterize_2dgs_batched`` in ``2dgs`` mode: every
camera binned in one pass, then composited camera by camera;
``render_rgba_batched``), "map" (the default) camera by camera; both give
the same images, regularisers and densification statistics. The JAX
model's ``chunk_size`` and ``backend`` have no meaning here.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _kernels
from ..graphics import gmath
from ..graphics.cameras import Cameras
from ..graphics.splats import Splats
from ..ops.rasterize import camera_matrices, rasterize, rasterize_batched, sh_colors
from ..ops.rasterize_2dgs import rasterize_2dgs, rasterize_2dgs_batched

MODES = ("classic", "antialiased", "2dgs")
CAMERA_BATCHING = ("map", "vmap")


@dataclasses.dataclass(frozen=True)
class GSplatter:
    """Static render configuration; the Gaussians live in a ``Splats``. On
    the card unless ``device`` names another device (raises without one)."""

    sh_degree: int = 3
    rasterize_mode: str = "classic"      # 'classic' | 'antialiased' | '2dgs'
    block_width: int = 16
    background_color: str = "random"     # 'white' | 'black' | 'random'
    tile_capacity: int = 1024            # 2dgs: Gaussians kept per tile
    pairs_per_gaussian: int = 8
    tile_chunk: int = 8                  # 2dgs: tiles per chunk on the CPU (capped at 4)
    camera_batching: str = "map"         # 'map' (camera by camera) | 'vmap' (one binning)
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.rasterize_mode not in MODES:
            raise ValueError(f"unknown rasterize_mode: {self.rasterize_mode}")
        if self.camera_batching not in CAMERA_BATCHING:
            raise ValueError(f"unknown camera_batching: {self.camera_batching}")
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

    def _render_2dgs(self, splats: Splats, colors, deg, viewmat, K, width: int, height: int,
                     means2d_offset, batched: bool) -> tuple[torch.Tensor, dict]:
        fn = rasterize_2dgs_batched if batched else rasterize_2dgs
        render, alpha, normal, pseudo_normal, distort, median, info = fn(
            splats.means, gmath.safe_normalize(splats.quats), torch.exp(splats.scales),
            torch.sigmoid(splats.opacities[:, 0]), colors, viewmat, K, width, height,
            sh_degree=deg, render_mode="RGB+ED", offset2d=means2d_offset,
            tile_size=self.block_width, tile_capacity=self.tile_capacity,
            pairs_per_gaussian=self.pairs_per_gaussian, tile_chunk=min(self.tile_chunk, 4),
        )
        info = dict(info, normal=normal, pseudo_normal=pseudo_normal, distort=distort,
                    median_depth=median, depth=render[..., -1:], alpha_map=alpha)
        return torch.cat((render[..., :3], alpha), -1), info

    def render_rgba(self, splats: Splats, camera: Cameras, *,
                    max_sh_degree: int | None = None,
                    means2d_offset: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """One camera -> ([H, W, 4] premultiplied rgba, info). In ``2dgs``
        mode ``info`` also holds the maps the regularisers read:
        ``normal``, ``pseudo_normal``, ``distort``, ``median_depth``,
        ``depth`` (expected) and ``alpha_map``."""
        colors, deg = self._colors_and_degree(splats, max_sh_degree)
        if self.rasterize_mode == "2dgs":
            return self._render_2dgs(splats, colors, deg, camera.view_matrix,
                                     camera.intrinsic_matrix, camera.width, camera.height,
                                     means2d_offset, batched=False)
        render, alpha, info = rasterize(
            splats.means, gmath.safe_normalize(splats.quats), torch.exp(splats.scales),
            torch.sigmoid(splats.opacities[:, 0]), colors, camera.view_matrix,
            camera.intrinsic_matrix, camera.width, camera.height, sh_degree=deg,
            tile_size=self.block_width, pairs_per_gaussian=self.pairs_per_gaussian,
            rasterize_mode=self.rasterize_mode, means2d_offset=means2d_offset,
        )
        return torch.cat((render[..., :3], alpha), -1), info

    def render_rgba_batched(self, splats: Splats, cameras: Cameras, *,
                            max_sh_degree: int | None = None,
                            means2d_offset: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, dict]:
        """A batch of B cameras binned in one pass (``rasterize_batched``,
        or ``rasterize_2dgs_batched`` in ``2dgs`` mode) -> ([B, H, W, 4]
        premultiplied rgba, info with ``radii`` [B, N]; in ``2dgs`` mode
        the regularisers' maps [B, H, W, ...] as ``render_rgba`` names
        them); each camera's image is ``render_rgba``'s. ``means2d_offset``
        is [B, N, 2]."""
        colors, deg = self._colors_and_degree(splats, max_sh_degree)
        viewmats, Ks = camera_matrices(cameras)
        if self.rasterize_mode == "2dgs":
            return self._render_2dgs(splats, colors, deg, viewmats, Ks, cameras.width,
                                     cameras.height, means2d_offset, batched=True)
        if deg is None:
            colors_b = colors.expand(len(cameras), *colors.shape)
        else:
            colors_b = torch.stack([sh_colors(deg, splats.means, colors, v) for v in viewmats])
        opacities = torch.sigmoid(splats.opacities[:, 0])
        render, alpha, info = rasterize_batched(
            splats.means, gmath.safe_normalize(splats.quats), torch.exp(splats.scales),
            opacities.expand(len(cameras), -1), colors_b, viewmats, Ks, cameras.width,
            cameras.height, tile_size=self.block_width, pairs_per_gaussian=self.pairs_per_gaussian,
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
        """Expected depth and alpha, [H, W, 2] (gsplat's 'ED' mode); the
        colours are detached, as only the geometry is rendered."""
        if self.rasterize_mode == "2dgs":
            rgba, info = self.render_rgba(splats, camera)
            return torch.cat((info["depth"], rgba[..., 3:]), -1)
        render, alpha, _ = rasterize(
            splats.means, gmath.safe_normalize(splats.quats), torch.exp(splats.scales),
            torch.sigmoid(splats.opacities[:, 0]), splats.colors.detach(), camera.view_matrix,
            camera.intrinsic_matrix, camera.width, camera.height,
            tile_size=self.block_width, pairs_per_gaussian=self.pairs_per_gaussian,
            rasterize_mode=self.rasterize_mode, render_mode="ED",
        )
        return torch.cat((render, alpha), -1)
