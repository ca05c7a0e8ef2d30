"""Soft shadow visibility by sphere-tracing the FlexiCubes SDF grid.

Counterpart of ``geosplatting_tpu/ops/sdf_visibility.py`` (``_pack_cells``,
``_trilerp_w8``, ``sample_sdf_grid``, ``make_sdf_visibility``): a fixed
number of sphere-tracing steps through the trilinearly interpolated SDF, one
row-gather of a cell's 8 corners per step, with the distance to the grid's
box added outside it. The trace is gradient-free (the SDF is detached): stage
2 runs it under ``torch.no_grad``. The mesh-occupancy variant of the prior
model (``mesh_occupancy_grid``, ``make_mesh_visibility``) is not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch


def _pack_cells(grid3d: torch.Tensor) -> torch.Tensor:
    """[Z+1, Y+1, X+1] vertex grid -> [Z*Y*X, 8] per-cell corner rows;
    corner index (dz*2 + dy)*2 + dx."""
    z1, y1, x1 = grid3d.shape
    z, y, x = z1 - 1, y1 - 1, x1 - 1
    cs = [
        grid3d[dz:dz + z, dy:dy + y, dx:dx + x]
        for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)
    ]
    return torch.stack(cs, -1).reshape(z * y * x, 8)


def _trilerp_w8(frac: torch.Tensor) -> torch.Tensor:
    """[..., 3] fractional coords -> [..., 8] trilinear corner weights (the
    corner order of ``_pack_cells``)."""
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    wx = torch.stack([1 - fx, fx], -1)
    wy = torch.stack([1 - fy, fy], -1)
    wz = torch.stack([1 - fz, fz], -1)
    w = wz[..., :, None, None] * wy[..., None, :, None] * wx[..., None, None, :]
    return w.reshape(frac.shape[:-1] + (8,))


def _box_distance(points: torch.Tensor, scale: float) -> torch.Tensor:
    outside = torch.clamp(points.abs() - scale, min=0.0)
    return torch.sqrt((outside * outside).sum(-1) + 1e-12)


def sample_sdf_grid(
    sdf: torch.Tensor,                    # [V] flat grid values
    resolution: tuple[int, int, int],
    scale: float,
    points: torch.Tensor,                 # [..., 3] world positions
) -> torch.Tensor:
    """Trilinear SDF lookup; outside the grid's box the distance to the box
    is added (a positive lower bound)."""
    rx, ry, rz = resolution
    res = points.new_tensor([rx, ry, rz])
    g = (points / scale * 0.5 + 0.5) * res
    g0 = torch.floor(g).long()
    frac = g - g0
    g0c = torch.minimum(g0.clamp(min=0), torch.tensor([rx - 1, ry - 1, rz - 1], device=g0.device))

    def vid(x, y, z):
        return (z * (ry + 1) + y) * (rx + 1) + x

    x0, y0, z0 = g0c[..., 0], g0c[..., 1], g0c[..., 2]
    vals = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (frac[..., 0] if dx else 1 - frac[..., 0])
                    * (frac[..., 1] if dy else 1 - frac[..., 1])
                    * (frac[..., 2] if dz else 1 - frac[..., 2])
                )
                vals = vals + w * sdf[vid(x0 + dx, y0 + dy, z0 + dz)]
    d_box = _box_distance(points, scale)
    return torch.where(d_box > 0, vals + d_box, vals)


def make_sdf_visibility(
    sdf: torch.Tensor,
    resolution: tuple[int, int, int],
    scale: float,
    *,
    num_steps: int = 24,
    softness: float = 8.0,
    t_start: float = 0.02,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Returns ``vis(origins [M, 3], dirs [M, 3]) -> [M]``, the soft
    visibility in [0, 1] (1 = unoccluded) after ``num_steps`` sphere-tracing
    steps from ``t_start`` up to ``t_max`` = 4 scale, each at least
    scale / num_steps / 2 long."""
    t_max = 4.0 * scale
    min_step = scale / num_steps * 0.5
    sdf = sdf.detach()
    rx, ry, rz = resolution
    corners = _pack_cells(sdf.reshape(rz + 1, ry + 1, rx + 1))
    res = sdf.new_tensor([rx, ry, rz])
    res_hi = torch.tensor([rx - 1, ry - 1, rz - 1], device=sdf.device)

    def sample_packed(p: torch.Tensor) -> torch.Tensor:
        g = (p / scale * 0.5 + 0.5) * res
        g0 = torch.floor(g).long()
        frac = g - g0
        g0c = torch.minimum(g0.clamp(min=0), res_hi)
        cell = (g0c[..., 2] * ry + g0c[..., 1]) * rx + g0c[..., 0]
        vals = (corners[cell] * _trilerp_w8(frac)).sum(-1)
        d_box = _box_distance(p, scale)
        return torch.where(d_box > 0, vals + d_box, vals)

    def vis(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        t = torch.full(origins.shape[:-1], t_start, device=origins.device)
        v = torch.ones(origins.shape[:-1], device=origins.device)
        for _ in range(num_steps):
            d = sample_packed(origins + dirs * t[..., None])
            v = torch.minimum(v, torch.clamp(softness * d / torch.clamp(t, min=1e-4), 0.0, 1.0))
            t = torch.clamp(t + torch.clamp(d, min=min_step), max=t_max)
        return torch.clamp(v, 0.0, 1.0)

    return vis
