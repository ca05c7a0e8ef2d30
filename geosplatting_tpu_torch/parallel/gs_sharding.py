"""Gaussian-sharded rasterization for multi-million-Gaussian scenes.

Counterpart of ``geosplatting_tpu/parallel/gs_sharding.py``. The Gaussian
axis N is split over the ranks of a process group:

1. each rank holds N / D Gaussians and projects them and evaluates their
   SH colours: the N-heavy work splits evenly, and the parameters can live
   sharded;
2. one all-gather brings every rank the compact projected records, packed
   into one float row a Gaussian (means2d, depth, conic, opacity, radius,
   the binning's extents and circular bound, colour: 11 + C floats);
3. each rank bins and composites one horizontal band of the image over
   the whole set (``tile_sharding.render_bands``: K1-K3 on the card), and
   the bands are all-gathered into the image.

The result is the single-process render: projection is elementwise in N
and compositing per pixel. Backward, the image's gather keeps the rank's
band; the records' gather sums every band's gradient of the rank's own
records (a reduce-scatter, written as an all-reduce and a slice, which
gloo and NCCL both have), which then flows back through the rank's
projection to its Gaussians.
"""
from __future__ import annotations

import torch

from ..ops.projection import Projected, project
from ..ops.rasterize import sh_colors
from .sharding import gather_rows
from .tile_sharding import render_bands

# per-Gaussian columns of a packed record ahead of the colour
_FIELDS = (("means2d", 2), ("depths", 1), ("conics", 3), ("opacities", 1), ("radii", 1),
           ("extents", 2), ("prune_r", 1))


def _pack(proj: Projected, colors: torch.Tensor) -> torch.Tensor:
    cols = []
    for name, width in _FIELDS:
        x = getattr(proj, name)
        if name == "radii":
            x = x.to(colors.dtype)    # small integers: exact in float32
        cols.append(x.reshape(-1, width))
    return torch.cat((*cols, colors), -1)


def _unpack(rows: torch.Tensor) -> tuple[Projected, torch.Tensor]:
    fields, at = {}, 0
    for name, width in _FIELDS:
        x = rows[:, at:at + width]
        at += width
        if name == "radii":
            x = x.detach().round().to(torch.int32)
        fields[name] = x if width > 1 else x[:, 0]
    return Projected(**fields), rows[:, at:]


def rasterize_gs_sharded(
    means, quats, scales, opacities, colors, viewmat, K,
    width: int, height: int, *, group=None, sh_degree: int | None = None,
    rasterize_mode: str = "classic", near: float = 0.01, far: float = 1e10, **kw,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian-sharded ``ops.rasterize.rasterize`` (its contract minus the
    info dict). Each rank of ``group`` passes its own N / D Gaussians (every
    rank the same count: pad with zero-opacity Gaussians) and the same
    camera; every rank gets the whole (render [H, W, C], alpha [H, W, 1]).
    ``kw`` goes to ``rasterize_projected`` (tile_size, pairs_per_gaussian,
    render_mode, max_pairs_override)."""
    proj = project(means, quats, scales, opacities, viewmat, K, width, height, near=near,
                   far=far, rasterize_mode=rasterize_mode)
    if sh_degree is not None:
        colors = sh_colors(sh_degree, means, colors, viewmat)
    proj_all, colors_all = _unpack(gather_rows(_pack(proj, colors), group, summed=True))
    return render_bands(proj_all, colors_all, width, height, group, near=near, far=far, **kw)
