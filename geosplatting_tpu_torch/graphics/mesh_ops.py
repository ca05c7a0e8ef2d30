"""Mesh utilities: Loop subdivision, TSDF fusion of depth maps, and
per-face ambient occlusion.

Counterpart of ``geosplatting_tpu/graphics/mesh_ops.py`` (``subdivide``,
``tsdf_fusion``, ``ambient_occlusion``). Subdivision runs on the host in
numpy (its edge deduplication depends on the data), as there. The fusion's
``lax.scan`` over views and the occlusion's over samples are Python loops.
``ambient_occlusion`` draws its surface samples and hemisphere directions
from a ``torch.Generator`` where the JAX function splits a key, or takes
them as tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .cameras import Cameras
from .marching import marching_cubes
from .mesh import TriangleMesh


def subdivide(mesh: TriangleMesh) -> TriangleMesh:
    """One Loop step, F -> 4F faces: each old vertex moved to w v + (1 - w)
    x the mean of its neighbours (w = 7/16 with three neighbours, else
    5/8), a vertex on each edge at 3/8 of its ends and 1/8 of the opposite
    corners (the midpoint on an edge of one face)."""
    v = mesh.vertices.detach().cpu().numpy()
    f = mesh.indices.detach().cpu().numpy()
    nv, nf = v.shape[0], f.shape[0]
    edges = f[:, [1, 2, 2, 0, 0, 1]].reshape(nf * 3, 2)
    sum_nb = np.zeros_like(v)
    np.add.at(sum_nb, edges[:, 0], v[edges[:, 1]])
    cnt_nb = np.zeros((nv, 1))
    np.add.at(cnt_nb, f.reshape(-1), 1.0)
    cnt_nb = np.maximum(cnt_nb, 1.0)
    w = np.where(cnt_nb == 3, 7 / 16, 5 / 8)
    updated = w * v + (1 - w) * (sum_nb / cnt_nb)

    edge_code = np.stack((edges.min(1), edges.max(1)), axis=-1)
    unique_edges, inverse = np.unique(edge_code, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    ne = unique_edges.shape[0]
    tri = v[f.reshape(-1)].reshape(nf, 3, 3)
    wing = 3.0 * tri.sum(-2, keepdims=True) - tri
    inserted = np.zeros((ne, 3))
    np.add.at(inserted, inverse, wing.reshape(nf * 3, 3) / 16.0)
    faces_of_edge = np.zeros(ne)
    np.add.at(faces_of_edge, inverse, 1.0)
    mid = (v[unique_edges[:, 0]] + v[unique_edges[:, 1]]) / 2.0
    inserted = np.where((faces_of_edge == 2)[:, None], inserted, mid)

    expanded = np.concatenate((f, inverse.reshape(nf, 3) + nv), axis=-1)
    new_f = expanded[:, [0, 5, 4, 4, 3, 2, 3, 4, 5, 5, 1, 3]].reshape(nf * 4, 3)
    dev = mesh.vertices.device
    return TriangleMesh(
        vertices=torch.as_tensor(np.concatenate((updated, inserted)).astype(np.float32),
                                 device=dev),
        indices=torch.as_tensor(new_f, device=dev).long(),
    )


def tsdf_fusion(
    depths: torch.Tensor,        # [N, H, W] or [N, H, W, 2] (depth, alpha)
    cameras: Cameras,            # [N]
    *,
    resolution: int = 128,
    scale: float = 1.0,
    sdf_trunc: float | None = None,
    depth_trunc: float = 1e6,
    alpha_trunc: float = 0.5,
) -> TriangleMesh:
    """Depth maps fused into a mesh: each vertex of the (R + 1)^3 lattice
    over [-scale, scale]^3, projected into every view, averages the
    truncated (sampled depth - its depth) over the views that see it on a
    valid pixel no farther than ``sdf_trunc`` behind the surface; vertices
    no view sees count as outside; marching cubes takes the zero level."""
    depths = torch.as_tensor(depths)
    if depths.ndim == 3:
        depths = torch.stack((depths, torch.ones_like(depths)), -1)
    h, w_img = depths.shape[1:3]
    trunc = sdf_trunc if sdf_trunc is not None else 4.0 * scale / resolution
    r = resolution
    dev = depths.device
    xs = (torch.arange(r + 1, device=dev) / r * 2.0 - 1.0) * scale
    gx, gy, gz = torch.meshgrid(xs, xs, xs, indexing="ij")
    pts = torch.stack((gx, gy, gz), -1).reshape(-1, 3)
    tsdf = torch.zeros(pts.shape[0], device=dev)
    weight = torch.zeros(pts.shape[0], device=dev)
    viewmats = cameras.view_matrix
    for i in range(depths.shape[0]):
        vm = viewmats[i]
        p_cam = pts @ vm[:3, :3].T + vm[:3, 3]
        z = p_cam[:, 2]
        px = cameras.fx[i] * p_cam[:, 0] / torch.clamp(z, min=1e-6) + cameras.cx[i]
        py = cameras.fy[i] * p_cam[:, 1] / torch.clamp(z, min=1e-6) + cameras.cy[i]
        # float -> int truncates toward zero, as jnp's astype does
        ix = px.to(torch.int32).long().clamp(0, w_img - 1)
        iy = py.to(torch.int32).long().clamp(0, h - 1)
        samp = depths[i][iy, ix]
        d_s, a_s = samp[:, 0], samp[:, 1]
        valid = ((z > 1e-4) & (px >= 0) & (px < w_img) & (py >= 0) & (py < h)
                 & (a_s > alpha_trunc) & (d_s > 0) & (d_s < depth_trunc))
        sdf = torch.clamp(d_s - z, -trunc, trunc) / trunc
        wgt = (valid & (d_s - z > -trunc)).float()
        tsdf = tsdf + sdf * wgt
        weight = weight + wgt
    sdf_grid = torch.where(weight > 0, tsdf / torch.clamp(weight, min=1e-6), 1.0)
    return marching_cubes(sdf_grid.reshape(r + 1, r + 1, r + 1), r, scale)


def ambient_occlusion(
    mesh: TriangleMesh,
    *,
    generator: torch.Generator | None = None,
    surface_draws=None,
    hemisphere: torch.Tensor | None = None,
    num_samples: int = 64,
    resolution: int = 96,
    scale: float = 1.0,
) -> torch.Tensor:
    """Per-face openness in [0, 1] (1 = unoccluded): the mean transmittance
    through ``make_mesh_visibility``'s occupancy grid along ``num_samples``
    cosine-weighted directions about each face normal, from the face centre
    lifted by two grid cells. ``surface_draws`` (the grid's surface
    samples, as ``TriangleMesh.draw_surface`` gives them) and
    ``hemisphere`` (local directions [num_samples, F, 3]) are drawn from
    ``generator`` where not given."""
    from ..ops.sdf_visibility import make_mesh_visibility
    from . import gmath

    vis = make_mesh_visibility(mesh, resolution=resolution, scale=scale, draws=surface_draws,
                               generator=generator)
    normals, _ = mesh.face_normals_and_areas()
    centers = mesh.face_vertices().mean(-2)
    origins = centers + normals * (2.0 * scale / resolution)
    t, bt = gmath.build_tangent_frame(normals)
    acc = torch.zeros(centers.shape[0], device=centers.device)
    for i in range(num_samples):
        local = (hemisphere[i].to(centers.device) if hemisphere is not None else
                 gmath.sample_hemisphere_cosine((centers.shape[0],), generator=generator,
                                                device=centers.device))
        dirs = local[:, 0:1] * t + local[:, 1:2] * bt + local[:, 2:3] * normals
        acc = acc + vis(origins, dirs)
    return acc / num_samples
