"""Mesh shaders over the triangle rasterizer: normal, depth, flat, pure,
pretty, wireframe, pbr (split-sum GGX under prefiltered environment mips),
shadow (sphere-traced against an SDF grid) and ssao, each a function of
(mesh, camera, materials) to an image.

Counterpart of ``geosplatting_tpu/graphics/shaders.py``. The tile capacity
is the JAX package's 256 triangles a tile by default; where a view needs
more, or more (triangle, tile) pairs than the budget, the JAX rasterizer
drops triangles without a word, and these shaders raise instead, naming
the fill, so a caller passes a larger ``tile_capacity`` (or
``pairs_per_triangle``). The rasterizer is called through its module, so a
caller can record its ``MeshRasterInfo``. ``render_ssao`` draws its
hemisphere samples from a ``torch.Generator`` (or takes them) where the JAX
function splits a key.
"""
from __future__ import annotations

import torch

from ..ops import cubemap as cm
from ..ops import mesh_raster as mr
from ..ops.sdf_visibility import make_sdf_visibility
from . import gmath
from .cameras import Cameras
from .mesh import TriangleMesh

TILE_CAPACITY = 256


def rasterize(mesh: TriangleMesh, camera: Cameras, *, tile_capacity: int = TILE_CAPACITY,
              **kw) -> mr.RasterOut:
    """``mesh_raster.rasterize_mesh`` that raises where it would drop a
    triangle (a tile or pair fill above 1)."""
    out, info = mr.rasterize_mesh(mesh, camera, tile_capacity=tile_capacity, **kw)
    if info.tile_fill > 1.0 or info.pair_fill > 1.0:
        raise ValueError(
            f"the mesh raster overflows: tile_fill={info.tile_fill:.3f} "
            f"({info.max_tile_triangles} triangles in one tile, capacity {info.tile_capacity}), "
            f"pair_fill={info.pair_fill:.3f}; pass a larger tile_capacity or "
            "pairs_per_triangle")
    return out


def _raster(mesh: TriangleMesh, camera: Cameras, **kw):
    out = rasterize(mesh, camera, **kw)
    hit = out.tri_id >= 0
    normals = gmath.safe_normalize(mr.interpolate(mesh.vertex_normals(), mesh, out))
    pos = mr.interpolate(mesh.vertices, mesh, out)
    return out, hit, normals, pos


def _with_alpha(rgb: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    return torch.cat((rgb, hit[..., None].float()), -1)


def _color(color, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(color, dtype=torch.float32, device=like.device)


def render_normal(mesh: TriangleMesh, camera: Cameras, **kw) -> torch.Tensor:
    """World normals mapped to [0, 1], and alpha. [H, W, 4]."""
    _, hit, normals, _ = _raster(mesh, camera, **kw)
    return _with_alpha(torch.where(hit[..., None], normals * 0.5 + 0.5, 0.0), hit)


def render_depth(mesh: TriangleMesh, camera: Cameras, **kw) -> torch.Tensor:
    """Camera-space z and alpha. [H, W, 2]."""
    out = rasterize(mesh, camera, **kw)
    return torch.stack((out.depth, (out.tri_id >= 0).float()), -1)


def render_flat(mesh: TriangleMesh, camera: Cameras, color=(0.8, 0.8, 0.8), **kw
                ) -> torch.Tensor:
    """An unlit constant colour."""
    out = rasterize(mesh, camera, **kw)
    hit = (out.tri_id >= 0)[..., None].float()
    return torch.cat((hit * _color(color, hit), hit), -1)


def render_pure(mesh: TriangleMesh, camera: Cameras, color=(0.8, 0.8, 0.8), **kw
                ) -> torch.Tensor:
    """One colour shaded by |N.V| (a headlight)."""
    _, hit, normals, pos = _raster(mesh, camera, **kw)
    view = gmath.safe_normalize(camera.c2w[:3, 3] - pos)
    ndv = (normals * view).sum(-1, keepdim=True).abs()
    return _with_alpha(torch.where(hit[..., None], ndv * _color(color, ndv), 0.0), hit)


def render_pretty(mesh: TriangleMesh, camera: Cameras, base_color=(0.85, 0.82, 0.78), **kw
                  ) -> torch.Tensor:
    """A daylight studio: a warm key light, a cool fill and a hemisphere
    ambient term."""
    _, hit, normals, _ = _raster(mesh, camera, **kw)
    dev = normals.device
    key_dir = gmath.safe_normalize(torch.tensor([0.5, 0.4, 0.8], device=dev))
    fill_dir = gmath.safe_normalize(torch.tensor([-0.6, -0.2, 0.3], device=dev))
    key = torch.clamp((normals * key_dir).sum(-1, keepdim=True), min=0.0)
    fill = torch.clamp((normals * fill_dir).sum(-1, keepdim=True), min=0.0)
    ambient = 0.5 * (normals[..., 2:3] + 1.0)
    rgb = (key * torch.tensor([1.0, 0.96, 0.9], device=dev) * 0.9
           + fill * torch.tensor([0.55, 0.62, 0.75], device=dev) * 0.35
           + ambient * torch.tensor([0.25, 0.27, 0.3], device=dev)) * _color(base_color, key)
    rgb = torch.where(hit[..., None], rgb, 0.0)
    return _with_alpha(rgb.clamp(0, 1), hit)


def render_wireframe(mesh: TriangleMesh, camera: Cameras, thickness: float = 0.04, **kw
                     ) -> torch.Tensor:
    """Dark where the barycentric distance to an edge is below ``thickness``."""
    out = rasterize(mesh, camera, **kw)
    hit = out.tri_id >= 0
    u, v = out.bary[..., 0], out.bary[..., 1]
    edge = torch.minimum(torch.minimum(u, v), 1.0 - u - v) < thickness
    grey = torch.where(hit & edge, 0.05, torch.where(hit, 0.9, 0.0))
    return _with_alpha(grey[..., None].expand(*grey.shape, 3), hit)


def render_pbr(
    mesh: TriangleMesh,
    camera: Cameras,
    *,
    kd: torch.Tensor,          # [V, 3] vertex albedo
    ks: torch.Tensor,          # [V, 2] vertex (roughness, metallic)
    env_base: torch.Tensor,
    env_mips: list,
    min_roughness: float = 0.08,
    **kw,
) -> torch.Tensor:
    """Split-sum GGX with the FG LUT over interpolated vertex materials,
    the environment looked up bilinearly with trilinear mips."""
    out, hit, normals, pos = _raster(mesh, camera, **kw)
    kd_px = mr.interpolate(kd, mesh, out)
    ks_px = mr.interpolate(ks, mesh, out)
    rough = ks_px[..., 0:1].clamp(min_roughness, 1.0)
    metal = ks_px[..., 1:2].clamp(0.0, 1.0)
    wo = gmath.safe_normalize(camera.c2w[:3, 3] - pos)
    n_dot_v = torch.clamp((normals * wo).sum(-1, keepdim=True), min=1e-6)
    fg = cm.sample_fg_lut(n_dot_v, rough)
    refl = 2 * (wo * normals).sum(-1, keepdim=True) * normals - wo
    l_diff, l_spec = cm.sample_splitsum(env_base, env_mips, normals, refl, rough,
                                        filter_mode="bilinear", mip_filter="trilinear")
    spec_col = 0.04 * (1 - metal) + kd_px * metal
    rgb = l_diff * kd_px * (1 - metal) + l_spec * (spec_col * fg[..., 0:1] + fg[..., 1:2])
    return _with_alpha(torch.where(hit[..., None], rgb, 0.0), hit)


def render_shadow(
    mesh: TriangleMesh,
    camera: Cameras,
    *,
    sdf: torch.Tensor,
    resolution: tuple[int, int, int],
    scale: float,
    light_dir=(0.5, 0.3, 0.8),
    **kw,
) -> torch.Tensor:
    """Lambert under one directional light with soft shadows sphere-traced
    through the SDF grid, plus a constant 0.15."""
    _, hit, normals, pos = _raster(mesh, camera, **kw)
    ld = gmath.safe_normalize(_color(light_dir, pos))
    vis = make_sdf_visibility(sdf, resolution, scale)
    flat_pos = pos.reshape(-1, 3)
    v = vis(flat_pos + normals.reshape(-1, 3) * 1e-3,
            ld.expand(flat_pos.shape).contiguous()).reshape(pos.shape[:2] + (1,))
    lambert = torch.clamp((normals * ld).sum(-1, keepdim=True), min=0.0)
    rgb = (lambert * v * 0.85 + 0.15) * torch.where(hit[..., None], 1.0, 0.0)
    return _with_alpha(rgb.expand(*rgb.shape[:2], 3), hit)


def render_ssao(
    mesh: TriangleMesh,
    camera: Cameras,
    *,
    generator: torch.Generator | None = None,
    samples: torch.Tensor | None = None,
    num_samples: int = 16,
    radius: float = 0.1,
    **kw,
) -> torch.Tensor:
    """Screen-space ambient occlusion: the share of ``num_samples``
    cosine-hemisphere offsets (``gmath.sample_hemisphere_cosine`` from
    ``generator``, or the unit ``samples`` [num_samples, 3] given) about
    each pixel's normal that land behind the depth buffer."""
    out, hit, normals, pos = _raster(mesh, camera, **kw)
    if samples is None:
        samples = gmath.sample_hemisphere_cosine((num_samples,), generator=generator,
                                                 device=pos.device)
    samples = samples.to(pos.device) * radius
    t, b = gmath.build_tangent_frame(normals)
    vm = camera.view_matrix
    k = camera.intrinsic_matrix
    occ = torch.zeros(pos.shape[:2], device=pos.device)
    for i in range(samples.shape[0]):
        sp = pos + t * samples[i, 0] + b * samples[i, 1] + normals * samples[i, 2]
        p_cam = sp @ vm[:3, :3].T + vm[:3, 3]
        z = torch.clamp(p_cam[..., 2], min=1e-6)
        # float -> int truncates toward zero, as jnp's astype does
        px = (k[0, 0] * p_cam[..., 0] / z + k[0, 2]).to(torch.int32).long().clamp(
            0, camera.width - 1)
        py = (k[1, 1] * p_cam[..., 1] / z + k[1, 2]).to(torch.int32).long().clamp(
            0, camera.height - 1)
        scene_z = out.depth[py, px]
        occ = occ + ((scene_z > 0) & (scene_z < z - 1e-3)).float()
    ao = 1.0 - occ / samples.shape[0]
    rgb = torch.where(hit[..., None], ao[..., None], 0.0)
    return _with_alpha(rgb.expand(*rgb.shape[:2], 3), hit)
