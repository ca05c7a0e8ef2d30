"""Soft shadow visibility by sphere-tracing the FlexiCubes SDF grid.

Counterpart of ``geosplatting_tpu/ops/sdf_visibility.py`` (``_pack_cells``,
``_trilerp_w8``, ``sample_sdf_grid``, ``make_sdf_visibility``): a fixed
number of sphere-tracing steps through the trilinearly interpolated SDF, one
row-gather of a cell's 8 corners per step, with the distance to the grid's
box added outside it. The trace is gradient-free (the SDF is detached): stage
2 runs it under ``torch.no_grad``. For an SDF on the card the march is the
hand-written CUDA kernel K4 (``csrc/sdf_trace.cu``, one thread a ray, each
ray stopped once its result can no longer change);
``make_sdf_visibility_plain``, the plain PyTorch march, serves an SDF on the
CPU and is the card's check.

The mesh prior has no SDF: ``mesh_occupancy_grid`` deposits area-weighted
surface samples into the nearest cells of an R^3 grid (a count, clipped to
1; the sum counts whole samples, so it is exact in any order), dilates it
by a 3^3 max, and ``make_mesh_visibility`` marches a fixed number of
evenly spaced steps through it, the transmittance exp(-density dt sum occ)
of the trilinear occupancy looked up in the edge-padded grid, one packed
row a step. Its surface samples are drawn from a ``torch.Generator`` or
injected (``TriangleMesh.draw_surface``).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .. import _kernels, counters


# the plain march counts the live ray-steps on every 64th ray: counting all
# of them cost 1.3-1.6 % of its device time on an H100
LIVE_STRIDE = 64


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


def make_sdf_visibility_plain(
    sdf: torch.Tensor,
    resolution: tuple[int, int, int],
    scale: float,
    *,
    num_steps: int = 24,
    softness: float = 8.0,
    t_start: float = 0.02,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Plain version of K4 (``make_sdf_visibility``): every ray takes every
    step. While a profiler records, ``vis`` counts them
    (``sdf_trace.ray_steps``) and those taken by a ray not yet settled
    (``sdf_trace.live_ray_steps``, see ``counters``), the latter on every
    ``LIVE_STRIDE``-th ray, scaled to all of them."""
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
        live = [] if counters.recording() else None
        for _ in range(num_steps):
            if live is not None:
                # t <= t_max and v >= 0: the minimum is 0 once the ray is settled
                tk, vk = t.reshape(-1)[::LIVE_STRIDE], v.reshape(-1)[::LIVE_STRIDE]
                live.append(torch.count_nonzero(torch.minimum(t_max - tk, vk)))
            d = sample_packed(origins + dirs * t[..., None])
            v = torch.minimum(v, torch.clamp(softness * d / torch.clamp(t, min=1e-4), 0.0, 1.0))
            t = torch.clamp(t + torch.clamp(d, min=min_step), max=t_max)
        if live is not None:
            m = t.numel()
            counters.count("sdf_trace.ray_steps", m * num_steps)
            counters.count("sdf_trace.live_ray_steps",
                           torch.stack(live).sum() * m // len(range(0, m, LIVE_STRIDE)))
        return torch.clamp(v, 0.0, 1.0)

    return vis


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
    scale / num_steps / 2 long.

    K4 (``csrc/sdf_trace.cu``) for an SDF on the card: one launch a call,
    each ray stopped once its result is settled, with the same result as
    every step taken; the plain version (``make_sdf_visibility_plain``) only
    for an SDF on the CPU. While a profiler records, the kernel counts
    ``sdf_trace.ray_steps``, ``sdf_trace.live_ray_steps`` on every ray and
    ``sdf_trace.issued_ray_steps`` (``counters``)."""
    if sdf.device.type == "cpu":
        return make_sdf_visibility_plain(sdf, resolution, scale, num_steps=num_steps,
                                         softness=softness, t_start=t_start)
    rx, ry, rz = resolution
    cells = _pack_cells(sdf.detach().reshape(rz + 1, ry + 1, rx + 1))
    _kernels.check_cuda_tensor(cells, "sdf_trace.sdf", torch.float32)
    t_max = 4.0 * scale
    min_step = scale / num_steps * 0.5
    # the plain march's p / scale is p * (1 / scale) on the card, 1 / scale
    # taken in float64 and rounded to float32 (as ctypes passes it)
    inv_scale = 1.0 / scale

    def vis(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        _kernels.check_cuda_tensor(origins, "sdf_trace.origins", torch.float32)
        _kernels.check_cuda_tensor(dirs, "sdf_trace.dirs", torch.float32, tuple(origins.shape))
        if origins.shape[-1:] != (3,) or origins.device != cells.device:
            raise ValueError(f"sdf_trace: expected [..., 3] rays on {cells.device}, got "
                             f"{tuple(origins.shape)} on {origins.device}")
        out = torch.empty(origins.shape[:-1], device=origins.device)
        m = out.numel()
        counts = (torch.zeros(2, dtype=torch.int64, device=origins.device)
                  if counters.recording() else None)
        if m:
            _kernels.launch(
                "sdf_trace", origins.data_ptr(), dirs.data_ptr(), cells.data_ptr(),
                out.data_ptr(), None if counts is None else counts.data_ptr(), m, rx, ry, rz,
                scale, inv_scale, t_start, t_max, min_step, softness, num_steps,
                _kernels.stream_of(origins),
            )
        if counts is not None:
            counters.count("sdf_trace.ray_steps", m * num_steps)
            counters.count("sdf_trace.live_ray_steps", counts[0])
            counters.count("sdf_trace.issued_ray_steps", counts[1])
        return out

    return vis


@torch.no_grad()
def mesh_occupancy_grid(mesh, *, resolution: int = 64, scale: float = 1.0,
                        num_samples: int = 1 << 17, draws=None,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """Soft occupancy [R, R, R] ([z, y, x]) of a (masked) triangle mesh in
    the box [-scale, scale]^3: ``num_samples`` area-weighted surface
    samples, each counted in its nearest cell, clipped to 1 and dilated by a
    3^3 max. ``draws`` are ``sample_surface``'s (face ids, uniforms)."""
    r = resolution
    pts, _ = mesh.sample_surface(num_samples, draws=draws, generator=generator)
    g = torch.clamp((pts / scale * 0.5 + 0.5) * r, 0, r - 1).long()
    flat = (g[:, 2] * r + g[:, 1]) * r + g[:, 0]
    occ = torch.bincount(flat, minlength=r ** 3).to(pts.dtype)
    occ = torch.clamp(occ, 0.0, 1.0).reshape(1, 1, r, r, r)
    # padding is -inf in max_pool3d: the window shrinks at the border, as
    # the JAX package's reduce_window(-inf, max, "SAME")
    return F.max_pool3d(occ, kernel_size=3, stride=1, padding=1)[0, 0]


def make_mesh_visibility(
    mesh,
    *,
    resolution: int = 64,
    scale: float = 1.0,
    num_steps: int = 32,
    density: float = 24.0,
    t_start: float = 0.05,
    num_samples: int = 1 << 17,
    draws=None,
    generator: torch.Generator | None = None,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Returns ``vis(origins [M, 3], dirs [M, 3]) -> [M]``, the
    transmittance exp(-density dt sum occ) of ``num_steps`` evenly spaced
    samples from ``t_start`` to 3 scale through ``mesh_occupancy_grid``
    (trilinear, clamped to the grid's edge, 0 outside the box)."""
    occ = mesh_occupancy_grid(mesh, resolution=resolution, scale=scale,
                              num_samples=num_samples, draws=draws, generator=generator)
    r = resolution
    t_max = 3.0 * scale
    dt = (t_max - t_start) / num_steps
    # edge-pad by one cell: the packed-cell row of a padded cell holds the
    # clamp-to-edge lookups of its eight corners
    occ_pad = F.pad(occ[None, None], (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]
    corners = _pack_cells(occ_pad)                  # (r + 1)^3 cells
    hi = torch.full((3,), r - 1, device=occ.device, dtype=torch.long)

    def sample_occ(p: torch.Tensor) -> torch.Tensor:
        g = (p / scale * 0.5 + 0.5) * r - 0.5
        g0 = torch.floor(g)
        frac = g - g0
        b = torch.minimum(g0.long().clamp(min=-1), hi) + 1     # padded-cell base, [0, r]
        cell = (b[..., 2] * (r + 1) + b[..., 1]) * (r + 1) + b[..., 0]
        out = (corners[cell] * _trilerp_w8(frac)).sum(-1)
        inside = (p.abs() < scale).all(-1)
        return torch.where(inside, out, 0.0)

    def vis(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        tau = torch.zeros(origins.shape[:-1], device=origins.device)
        for i in range(num_steps):
            tau = tau + sample_occ(origins + dirs * (t_start + dt * (i + 0.5)))
        return torch.exp(-density * dt * tau)

    return vis
