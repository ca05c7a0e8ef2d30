"""Tile-binned differentiable Gaussian rasterization on the pairs path.

Counterpart of ``geosplatting_tpu/ops/rasterize.py`` (``rasterize``,
``rasterize_projected``, ``_tiles_to_image`` and the compositing
constants). The JAX package's dense reference rasterizer is its CPU oracle;
here the CPU path is the plain version beside each kernel, so there is one
rasterizer for both devices.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from .projection import Projected, project
from .rasterize_pairs import (  # noqa: F401  (constants re-exported as in the JAX package)
    MAX_ALPHA, MIN_ALPHA, TRANSMITTANCE_EPS, bin_pairs, composite_pairs, tile_grid,
)


def _tiles_to_image(tiles: torch.Tensor, grid, height: int, width: int) -> torch.Tensor:
    """[T, P, C] per-tile pixels -> [H, W, C] image."""
    tw, th, tsx, tsy = grid
    c = tiles.shape[-1]
    img = tiles.reshape(th, tw, tsy, tsx, c).permute(0, 2, 1, 3, 4)
    return img.reshape(th * tsy, tw * tsx, c)[:height, :width]


def rasterize_projected(
    proj: Projected,
    colors: torch.Tensor,
    width: int,
    height: int,
    *,
    near: float = 0.01,
    far: float = 1e10,
    tile_size=16,
    pairs_per_gaussian: int = 8,
    max_pairs_override: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Binning + compositing of an already-projected Gaussian set. Returns
    (render [H, W, C], alpha [H, W, 1], info)."""
    n = proj.means2d.shape[0]
    # every binning/pack/kernel buffer scales with this static budget
    max_pairs = max(int(pairs_per_gaussian) * n, 1 << 12)
    if max_pairs_override is not None:
        max_pairs = max(min(max_pairs, int(max_pairs_override)), 1 << 12)

    grid = tile_grid(width, height, tile_size)
    with record_function("rasterize.bin_pairs"):
        bins = bin_pairs(proj, width, height, tile_size=(grid.tsx, grid.tsy),
                         max_pairs=max_pairs, near=near, far=far)
    with record_function("rasterize.composite"):
        tiles_c, tiles_a, _ = composite_pairs(
            bins, grid, proj.means2d, proj.conics, proj.opacities, colors, proj.depths
        )
    render = _tiles_to_image(tiles_c, grid, height, width)
    img_a = _tiles_to_image(tiles_a[..., None], grid, height, width)
    info = {
        "means2d": proj.means2d,
        "radii": proj.radii,
        "depths": proj.depths,
        "total_pairs": bins.total_pairs,
        "max_pairs": max_pairs,
    }
    return render, img_a, info


def rasterize(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,      # linear scales
    opacities: torch.Tensor,   # [N] in [0, 1]
    colors: torch.Tensor,      # [N, C]
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    *,
    near: float = 0.01,
    far: float = 1e10,
    tile_size=16,
    pairs_per_gaussian: int = 8,
    rasterize_mode: str = "classic",
    means2d_offset: torch.Tensor | None = None,
    max_pairs_override: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Render one camera. Returns (render [H, W, C], alpha [H, W, 1],
    info). ``means2d_offset`` is a zeros-valued [N, 2] hook whose gradient
    is the screen-space position gradient densification reads."""
    proj = project(
        means, quats, scales, opacities, viewmat, K, width, height,
        near=near, far=far, rasterize_mode=rasterize_mode,
    )
    if means2d_offset is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_offset)
    return rasterize_projected(
        proj, colors, width, height, near=near, far=far, tile_size=tile_size,
        pairs_per_gaussian=pairs_per_gaussian, max_pairs_override=max_pairs_override,
    )
