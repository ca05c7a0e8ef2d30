"""Tile-parallel rasterization: the image split into horizontal bands over
the ranks of a process group.

Counterpart of ``geosplatting_tpu/parallel/tile_sharding.py``. Each rank
projects the Gaussians for the whole camera, moves the projected centres up
by ``band_h * rank`` and bins and composites the rows [rank * band_h,
(rank + 1) * band_h) through ``rasterize_projected`` (the pairs path: K1-K3
on the card); the bands are all-gathered into the image. A band's tiles are
whole tiles of the image, and the move is exact in float32 for the centres
near the band (|y| <= 2 * band_h * rank), so each pixel's offset from each
Gaussian, and so the image, is the single-process render's bit for bit; the
JAX function instead shifts the camera's principal point, which rounds
those offsets differently.

The Gaussians are replicated: every rank passes the same tensors. Their
gradient is the sum of every band's, so each input passes through
``sum_grad_over_ranks`` (identity forward, all-reduce backward); the
gathered image's backward keeps the rank's own band (every rank holds the
same loss of the whole image).
"""
from __future__ import annotations

import torch

from ..ops.projection import Projected, project
from ..ops.rasterize import rasterize_projected, sh_colors
from ..ops.rasterize_pairs import tile_wh
from .sharding import gather_rows, rank_and_world, sum_grad_over_ranks


def band_height(height: int, world: int, tile_size) -> int:
    """Rows of each rank's band: the image's rows split evenly, rounded up
    to whole tiles (the last band may reach below the image)."""
    tile_h = tile_wh(tile_size)[1]
    return -(-height // (world * tile_h)) * tile_h


def render_bands(proj: Projected, colors: torch.Tensor, width: int, height: int, group=None,
                 **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's band of an image projected for the whole camera,
    composited by ``rasterize_projected`` (``kw``), and every rank's bands
    gathered: (render [H, W, C], alpha [H, W, 1])."""
    rank, world = rank_and_world(group)
    band_h = band_height(height, world, kw.get("tile_size", 16))
    shift = proj.means2d.new_tensor([0.0, float(band_h * rank)])
    render, alpha, _ = rasterize_projected(proj._replace(means2d=proj.means2d - shift), colors,
                                           width, band_h, **kw)
    return gather_rows(render, group)[:height], gather_rows(alpha, group)[:height]


def rasterize_tile_sharded(
    means, quats, scales, opacities, colors, viewmat, K,
    width: int, height: int, *, group=None, sh_degree: int | None = None,
    rasterize_mode: str = "classic", near: float = 0.01, far: float = 1e10, **kw,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Band-sharded ``ops.rasterize.rasterize`` (its contract minus the info
    dict). Every rank of ``group`` passes the same inputs and gets the whole
    (render [H, W, C], alpha [H, W, 1]). ``kw`` goes to
    ``rasterize_projected`` (tile_size, pairs_per_gaussian, render_mode,
    max_pairs_override)."""
    means, quats, scales, opacities, colors = (
        sum_grad_over_ranks(x, group) for x in (means, quats, scales, opacities, colors))
    proj = project(means, quats, scales, opacities, viewmat, K, width, height, near=near,
                   far=far, rasterize_mode=rasterize_mode)
    if sh_degree is not None:
        colors = sh_colors(sh_degree, means, colors, viewmat)
    return render_bands(proj, colors, width, height, group, near=near, far=far, **kw)
