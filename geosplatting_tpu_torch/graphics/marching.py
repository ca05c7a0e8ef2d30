"""Marching tetrahedra and marching cubes, differentiable through autograd.

Counterpart of ``geosplatting_tpu/graphics/marching.py`` (``TET_EDGES``,
``_tet_table``, ``marching_tets``, ``TetGrid``, ``kuhn_tet_grid``,
``marching_cubes``). One marching-tets core over a 16-case table generated
at first use; a cube grid is split into the six Kuhn tetrahedra of each
cube, so no 256-case table is written out. The output is a padded mesh:
every tetrahedron owns two triangle slots and their six crossing vertices,
with ``face_mask`` marking the real triangles (no vertex is shared between
triangles). The crossings move with the SDF values and the grid vertices,
so gradients reach both; each triangle is oriented against the
tetrahedron's linear SDF gradient, which carries no gradient.
"""
from __future__ import annotations

import functools
from itertools import permutations
from typing import NamedTuple

import numpy as np
import torch

from .mesh import TriangleMesh

# the six edges of a tetrahedron (local corner ids 0..3)
TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)


@functools.lru_cache(maxsize=1)
def _tet_table() -> tuple[np.ndarray, np.ndarray]:
    """The 16-case table: tri_table [16, 2, 3] of local edge ids (-1 for
    none) and num_tris [16]; bit v of a case is corner v inside (sdf < 0)."""
    edge_of = {tuple(sorted(e)): i for i, e in enumerate(TET_EDGES.tolist())}
    table = np.full((16, 2, 3), -1, np.int64)
    num = np.zeros(16, np.int64)
    for case in range(16):
        inside = [v for v in range(4) if (case >> v) & 1]
        outside = [v for v in range(4) if not (case >> v) & 1]
        if len(inside) in (0, 4):
            continue
        if len(inside) in (1, 3):
            flip = len(inside) == 3
            v = outside[0] if flip else inside[0]
            e = [edge_of[tuple(sorted((v, u)))] for u in range(4) if u != v]
            table[case, 0] = [e[0], e[2], e[1]] if flip else e
            num[case] = 1
        else:
            (a, b), (c, d) = inside, outside
            e_ac, e_ad = edge_of[tuple(sorted((a, c)))], edge_of[tuple(sorted((a, d)))]
            e_bc, e_bd = edge_of[tuple(sorted((b, c)))], edge_of[tuple(sorted((b, d)))]
            table[case, 0] = [e_ac, e_ad, e_bd]
            table[case, 1] = [e_ac, e_bd, e_bc]
            num[case] = 2
    return table, num


def marching_tets(vertices: torch.Tensor, sdf: torch.Tensor, tets: torch.Tensor
                  ) -> TriangleMesh:
    """The zero level set of ``sdf`` [V] over the tetrahedra ``tets`` [T, 4]
    of ``vertices`` [V, 3]: a padded mesh of T * 6 vertices and T * 2
    faces, ``face_mask`` marking the triangles that exist (and have area)."""
    dev = vertices.device
    table_np, num_np = _tet_table()
    occ = (sdf < 0).long()[tets]                                          # [T, 4]
    case = occ[:, 0] + 2 * occ[:, 1] + 4 * occ[:, 2] + 8 * occ[:, 3]
    tri_e = torch.as_tensor(table_np, device=dev)[case]                   # [T, 2, 3]
    n_tris = torch.as_tensor(num_np, device=dev)[case]                    # [T]

    edges = torch.as_tensor(TET_EDGES, device=dev)
    ea, eb = tets[:, edges[:, 0]], tets[:, edges[:, 1]]                   # [T, 6]
    sa, sb = sdf[ea], sdf[eb]
    denom = sa - sb
    denom = torch.where(denom.abs() < 1e-12, torch.ones_like(denom), denom)
    w = (sa / denom).clamp(0.0, 1.0)[..., None]
    crossing = vertices[ea] * (1 - w) + vertices[eb] * w                  # [T, 6, 3]

    t = tets.shape[0]
    e_idx = tri_e.clamp(min=0).reshape(t, 6)
    tri_pts = torch.gather(crossing, 1, e_idx[..., None].expand(t, 6, 3)).reshape(t, 2, 3, 3)
    # orient each triangle at run time (Kuhn tetrahedra have both parities,
    # so no winding is fixed per case): flip where its normal opposes the
    # tetrahedron's linear SDF gradient, which points outside
    tet_pos = vertices[tets]                                              # [T, 4, 3]
    tet_sdf = sdf[tets]
    e_mat = tet_pos[:, 1:] - tet_pos[:, 0:1]
    ds = tet_sdf[:, 1:] - tet_sdf[:, 0:1]
    grad = torch.linalg.solve(e_mat, ds[..., None])[..., 0]               # [T, 3]
    n = torch.cross(tri_pts[:, :, 1] - tri_pts[:, :, 0], tri_pts[:, :, 2] - tri_pts[:, :, 0],
                    dim=-1)                                               # [T, 2, 3]
    flip = (n * grad.detach()[:, None, :]).sum(-1) < 0
    tri_pts = torch.where(flip[..., None, None], tri_pts[:, :, [0, 2, 1], :], tri_pts)
    valid = torch.arange(2, device=dev)[None, :] < n_tris[:, None]
    valid = valid & ((n * n).sum(-1) > 1e-20)   # no zero-area slivers
    verts = tri_pts.reshape(t * 6, 3)
    mask = valid.reshape(t * 2)
    return TriangleMesh(
        vertices=torch.where(mask.repeat_interleave(3)[:, None], verts, 0.0),
        indices=torch.arange(t * 6, device=dev).reshape(t * 2, 3),
        face_mask=mask,
    )


class TetGrid(NamedTuple):
    vertices: torch.Tensor   # [V, 3]
    tets: torch.Tensor       # [T, 4] int64


def kuhn_tet_grid(resolution: int, scale: float = 1.0, device=None) -> TetGrid:
    """The (R + 1)^3 lattice over [-scale, scale]^3 (x fastest), each cube
    split into the six tetrahedra of its main diagonal."""
    r = resolution
    idx = np.arange((r + 1) ** 3)
    x, y, z = idx % (r + 1), (idx // (r + 1)) % (r + 1), idx // (r + 1) ** 2
    verts = (np.stack([x, y, z], -1) / r * 2.0 - 1.0) * scale
    cube = np.arange(r ** 3)
    cx, cy, cz = cube % r, (cube // r) % r, cube // (r * r)
    tets = []
    for p in permutations(range(3)):
        corners = [np.zeros(3, np.int64)]
        for axis in p:
            nxt = corners[-1].copy()
            nxt[axis] = 1
            corners.append(nxt)
        tets.append(np.stack([((cz + c[2]) * (r + 1) + cy + c[1]) * (r + 1) + cx + c[0]
                              for c in corners], -1))
    return TetGrid(vertices=torch.as_tensor(verts, dtype=torch.float32, device=device),
                   tets=torch.as_tensor(np.concatenate(tets, 0), device=device))


def marching_cubes(sdf_grid: torch.Tensor, resolution: int, scale: float = 1.0) -> TriangleMesh:
    """The zero level set of a dense grid [R + 1, R + 1, R + 1] (or flat,
    x fastest) by marching tetrahedra over the Kuhn split."""
    grid = kuhn_tet_grid(resolution, scale, sdf_grid.device)
    return marching_tets(grid.vertices, sdf_grid.reshape(-1), grid.tets)
