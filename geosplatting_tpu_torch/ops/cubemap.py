"""Cubemap mip chains, the split-sum prefilter and split-sum sampling used
by stage-1 training.

Counterpart of ``geosplatting_tpu/ops/cubemap.py``: ``build_mip_chain``,
``downsample``, ``diffuse_prefilter``, ``specular_prefilter_conv``,
``prefilter_splitsum`` (the JAX package's ``method="conv"``, the one
training uses), ``sample_cubemap``,
``sample_splitsum`` with the nearest filters over the mip atlas, and
``fg_analytic``. Cubemaps are [6, R, R, C], faces +x, -x, +y, -y, +z, -z.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..graphics import gmath
from .segment_rows import gather_rows


def cube_dir(face: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(face, u, v) with u, v in [-1, 1] -> unnormalized direction [..., 3]."""
    one = torch.ones_like(u)
    return [
        lambda: torch.stack((one, -v, -u), -1),
        lambda: torch.stack((-one, -v, u), -1),
        lambda: torch.stack((u, one, v), -1),
        lambda: torch.stack((u, -one, -v), -1),
        lambda: torch.stack((u, -v, one), -1),
        lambda: torch.stack((-u, -v, -one), -1),
    ][face]()


def dir_to_cube_uv(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Direction [..., 3] -> (face, u, v) with u, v in [-1, 1]."""
    x, y, z = d.unbind(-1)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x, torch.where(x > 0, 0, 1),
        torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)),
    )
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az)).clamp(min=1e-3)
    u = torch.where(
        is_x, torch.where(x > 0, -z, z),
        torch.where(is_y, x, torch.where(z > 0, x, -x)),
    ) / ma
    v = torch.where(is_y, torch.where(y > 0, z, -z) / ma, -y / ma)
    return face, u, v


def texel_directions(resolution: int, device=None) -> torch.Tensor:
    """[6, R, R, 3] unit direction at each texel center."""
    t = (torch.arange(resolution, device=device, dtype=torch.float32) + 0.5) / resolution * 2.0 - 1.0
    v, u = torch.meshgrid(t, t, indexing="ij")
    return gmath.safe_normalize(torch.stack([cube_dir(f, u, v) for f in range(6)], 0))


def texel_solid_angles(resolution: int, device=None) -> torch.Tensor:
    """[6, R, R] solid angle of each texel (exact corner integral)."""
    edges = torch.arange(resolution + 1, device=device, dtype=torch.float32) / resolution * 2.0 - 1.0
    gy, gx = torch.meshgrid(edges, edges, indexing="ij")
    a = torch.atan2(gx * gy, torch.sqrt(gx * gx + gy * gy + 1.0))
    sa = a[1:, 1:] - a[:-1, 1:] - a[1:, :-1] + a[:-1, :-1]
    return sa[None].expand(6, resolution, resolution)


def sample_cubemap(data: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear clamp-to-face lookup: data [6, R, R, C], dirs [..., 3] -> [..., C]."""
    r = data.shape[1]
    face, u, v = dir_to_cube_uv(gmath.safe_normalize(dirs))
    fu = (u * 0.5 + 0.5) * r - 0.5
    fv = (v * 0.5 + 0.5) * r - 0.5
    x0 = torch.floor(fu).long().clamp(0, r - 1)
    y0 = torch.floor(fv).long().clamp(0, r - 1)
    x1 = (x0 + 1).clamp(max=r - 1)
    y1 = (y0 + 1).clamp(max=r - 1)
    wx = (fu - x0).clamp(0.0, 1.0)[..., None]
    wy = (fv - y0).clamp(0.0, 1.0)[..., None]
    flat = data.reshape(-1, data.shape[-1])

    def tex(x, y):
        return gather_rows(flat, (face * r + y) * r + x)

    return (
        tex(x0, y0) * (1 - wx) * (1 - wy)
        + tex(x1, y0) * wx * (1 - wy)
        + tex(x0, y1) * (1 - wx) * wy
        + tex(x1, y1) * wx * wy
    )


def downsample(data: torch.Tensor) -> torch.Tensor:
    """2x average-pool mip."""
    f, r, _, c = data.shape
    return data.reshape(f, r // 2, 2, r // 2, 2, c).mean(dim=(2, 4))


def build_mip_chain(data: torch.Tensor, min_resolution: int = 16) -> list[torch.Tensor]:
    chain = [data]
    while chain[-1].shape[1] > min_resolution:
        chain.append(downsample(chain[-1]))
    return chain


def diffuse_prefilter(cube: torch.Tensor) -> torch.Tensor:
    """[6, R, R, 3] -> cosine-hemisphere prefiltered irradiance (dense
    [6R^2, 6R^2] quadrature; R is the small end of the mip chain)."""
    r = cube.shape[1]
    dirs = texel_directions(r, cube.device).reshape(-1, 3)
    areas = texel_solid_angles(r, cube.device).reshape(-1)
    w = torch.clamp(dirs @ dirs.T, min=0.0) * (areas[None, :] / math.pi)
    out = w @ cube.reshape(-1, 3)
    norm = w.sum(1, keepdim=True)
    return (out / norm.clamp(min=1e-8)).reshape(cube.shape)


def _upsample2x(data: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample per face (half-pixel centers, edge clamp):
    [6, R, R, C] -> [6, 2R, 2R, C]."""
    x = data.permute(0, 3, 1, 2)
    x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1)


def _conv1d_last(x: torch.Tensor, k: list[float]) -> torch.Tensor:
    """Valid 1-D convolution along the last axis (symmetric kernel)."""
    n = len(k)
    length = x.shape[-1] - n + 1
    out = x[..., :length] * k[0]
    for i in range(1, n):
        out = out + x[..., i: i + length] * k[i]
    return out


def _face_blur(data: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable per-face Gaussian blur with edge-replicate padding."""
    if sigma <= 0.05:
        return data
    radius = min(int(np.ceil(3.0 * sigma)), data.shape[1] - 1)
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32).tolist()
    # rows (axis 1), then columns (axis 2), each padded by edge replication
    x = data.permute(0, 3, 2, 1)                                   # [6, C, W, H]
    x = torch.cat([x[..., :1].expand(*x.shape[:-1], radius), x,
                   x[..., -1:].expand(*x.shape[:-1], radius)], -1)
    x = _conv1d_last(x, k).permute(0, 1, 3, 2)                     # [6, C, H, W]
    x = torch.cat([x[..., :1].expand(*x.shape[:-1], radius), x,
                   x[..., -1:].expand(*x.shape[:-1], radius)], -1)
    return _conv1d_last(x, k).permute(0, 2, 3, 1)                  # [6, H, W, C]


def specular_prefilter_conv(chain: list[torch.Tensor], roughness: float) -> torch.Tensor:
    """Gaussian-lobe GGX prefilter approximation: blur at the mip whose texel
    pitch matches the lobe, then upsample to chain[0]'s resolution."""
    res = chain[0].shape[1]
    alpha = max(float(roughness), 1e-3)

    def sigma_at(r):
        return 2.0 * alpha * r / np.pi

    level = 0
    while level < len(chain) - 1 and sigma_at(chain[level].shape[1]) > 3.0:
        level += 1
    src = chain[level]
    out = _face_blur(src, sigma_at(src.shape[1]))
    while out.shape[1] < res:
        out = _upsample2x(out)
    return out


def prefilter_splitsum(
    cube: torch.Tensor,
    *,
    min_resolution: int = 16,
    min_roughness: float = 0.08,
    max_roughness: float = 0.5,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """(diffuse base [6, r, r, 3] at the min resolution, specular mip list
    from full resolution down to the min resolution), with the blur
    approximation of the specular lobes."""
    chain = build_mip_chain(cube, min_resolution)
    n = len(chain)
    base = diffuse_prefilter(chain[-1])
    mips = []
    for idx in range(n - 1):
        rough = idx / max(n - 2, 1) * (max_roughness - min_roughness) + min_roughness
        mips.append(specular_prefilter_conv(chain[idx:], rough))
    mips.append(specular_prefilter_conv(chain[-1:], 1.0))
    return base, mips


def sample_splitsum(
    base: torch.Tensor,
    mips: list[torch.Tensor],
    normals: torch.Tensor,     # [..., 3]
    directions: torch.Tensor,  # [..., 3]
    roughness: torch.Tensor,   # [..., 1]
    *,
    min_roughness: float = 0.08,
    max_roughness: float = 0.5,
    with_diffuse: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """(l_diffuse, l_specular) with nearest texel and nearest mip filters:
    each element gathers one texel of its own level from the flattened mip
    atlas."""
    n = len(mips)
    miplevel = torch.where(
        roughness < max_roughness,
        ((roughness - min_roughness) / (max_roughness - min_roughness)).clamp(0, 1) * (n - 2),
        ((roughness - max_roughness) / (1.0 - max_roughness)).clamp(0, 1) + n - 2,
    )[..., 0]

    l_diff = sample_cubemap(base, normals) if with_diffuse else None

    face, u, v = dir_to_cube_uv(gmath.safe_normalize(directions))
    atlas = torch.cat([m.reshape(-1, m.shape[-1]) for m in mips])
    res_np = np.asarray([m.shape[1] for m in mips], np.int64)
    offs_np = np.concatenate([[0], np.cumsum(6 * res_np ** 2)[:-1]])
    dev = base.device
    lvl = torch.round(miplevel).long().clamp(0, n - 1)
    r = torch.as_tensor(res_np, device=dev)[lvl]
    off = torch.as_tensor(offs_np, device=dev)[lvl]
    rf = r.to(torch.float32)
    fu = (u * 0.5 + 0.5) * rf - 0.5
    fv = (v * 0.5 + 0.5) * rf - 0.5
    x0 = torch.minimum(torch.round(fu).long().clamp(min=0), r - 1)
    y0 = torch.minimum(torch.round(fv).long().clamp(min=0), r - 1)
    l_spec = gather_rows(atlas, off + (face * r + y0) * r + x0)
    return l_diff, l_spec


def fg_analytic(n_dot_v: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Karis' analytic environment-BRDF approximation: [..., 1] each ->
    [..., 2] (scale, bias)."""
    x = n_dot_v.clamp(0.0, 1.0)
    r = roughness.clamp(0.0, 1.0)
    c0 = torch.tensor([-1.0, -0.0275, -0.572, 0.022], device=x.device)
    c1 = torch.tensor([1.0, 0.0425, 1.04, -0.04], device=x.device)
    t = r * c0 + c1
    a004 = torch.minimum(t[..., 0:1] * t[..., 0:1], torch.exp2(-9.28 * x)) * t[..., 0:1] + t[..., 1:2]
    return torch.cat((a004 * -1.04 + t[..., 2:3], a004 * 1.04 + t[..., 3:4]), -1)
