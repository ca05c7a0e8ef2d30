"""Triangle mesh with padded static buffers and masked-face semantics.

Counterpart of ``geosplatting_tpu/graphics/mesh.py``: ``TriangleMesh`` with
``face_mask``, ``face_vertices``, ``face_normals_and_areas``,
``vertex_normals`` and area-weighted ``sample_surface``, and the mesh
regularizers of the prior variant (``mesh_edge_loss``,
``uniform_laplacian_smoothing``, ``mesh_normal_consistency``). Masked faces
contribute nothing. ``sample_surface`` takes its draws (face ids and
barycentric uniforms) as tensors or from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.segment_rows import gather_rows
from . import gmath


@dataclasses.dataclass
class TriangleMesh:
    vertices: torch.Tensor                   # [V, 3]
    indices: torch.Tensor                    # [F, 3] int64
    face_mask: torch.Tensor | None = None    # [F] bool; None = all valid

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_faces(self) -> int:
        return self.indices.shape[0]

    def face_mask_or_ones(self) -> torch.Tensor:
        if self.face_mask is None:
            return torch.ones(self.num_faces, dtype=torch.bool, device=self.vertices.device)
        return self.face_mask

    def face_vertices(self) -> torch.Tensor:
        """[F, 3, 3] corner positions (padded faces give garbage — combine
        with the mask)."""
        return gather_rows(self.vertices, self.indices)

    def face_normals_and_areas(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Unit face normals [F, 3] and areas [F]; masked faces give 0. The
        norm is guarded: a zero cross product has a finite gradient."""
        fv = self.face_vertices()
        cross = torch.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0], dim=-1)
        area2 = torch.sqrt((cross * cross).sum(-1) + 1e-20)
        mask = self.face_mask_or_ones()
        return (torch.where(mask[:, None], cross / area2[:, None], 0.0),
                torch.where(mask, 0.5 * area2, 0.0))

    def draw_surface(self, num_samples: int, generator: torch.Generator | None = None):
        """``sample_surface``'s draws: face ids [S] with probability
        proportional to the face areas (+1e-20, as the JAX package's log
        weights) and uniforms [S, 2]."""
        with torch.no_grad():
            _, areas = self.face_normals_and_areas()
            fid = torch.multinomial(areas + 1e-20, num_samples, replacement=True,
                                    generator=generator)
        uv = torch.rand((num_samples, 2), generator=generator, device=self.vertices.device)
        return fid, uv

    def sample_surface(self, num_samples: int, *, draws=None,
                       generator: torch.Generator | None = None):
        """Area-weighted surface samples: (positions [S, 3], face ids [S]).
        ``draws`` = (face ids [S], uniforms [S, 2]) as ``draw_surface``
        makes them; without them they are drawn from ``generator``."""
        fid, uv = draws if draws is not None else self.draw_surface(num_samples, generator)
        fid = fid.long()
        su = torch.sqrt(uv[:, 0:1])
        b0 = 1 - su
        b1 = uv[:, 1:2] * su
        b2 = 1 - b0 - b1
        fv = gather_rows(self.vertices, self.indices[fid])
        return b0 * fv[:, 0] + b1 * fv[:, 1] + b2 * fv[:, 2], fid

    def vertex_normals(self) -> torch.Tensor:
        """Area-weighted vertex normals [V, 3]; vertices no valid face
        touches get +z."""
        fv = self.face_vertices()
        cross = torch.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0], dim=-1)
        contrib = torch.where(self.face_mask_or_ones()[:, None], cross, 0.0)
        acc = torch.zeros_like(self.vertices)
        for k in range(3):
            acc = acc.index_add(0, self.indices[:, k], contrib)
        degenerate = (acc * acc).sum(-1, keepdim=True) < 1e-16
        up = torch.tensor([0.0, 0.0, 1.0], device=acc.device, dtype=acc.dtype)
        return gmath.safe_normalize(torch.where(degenerate, up, acc))


def mesh_edge_loss(mesh: TriangleMesh, target_length: float = 0.0) -> torch.Tensor:
    """Mean squared deviation of the valid faces' edge lengths from
    ``target_length`` (each face's three edges)."""
    fv = mesh.face_vertices()
    mask = mesh.face_mask_or_ones().to(fv.dtype)
    e = torch.stack((fv[:, 0] - fv[:, 1], fv[:, 1] - fv[:, 2], fv[:, 2] - fv[:, 0]), 1)
    length = torch.sqrt((e * e).sum(-1) + 1e-20)    # guarded: zero-length edges
    per = (length - target_length) ** 2 * mask[:, None]
    return per.sum() / torch.clamp(mask.sum() * 3, min=1.0)


def uniform_laplacian_smoothing(mesh: TriangleMesh) -> torch.Tensor:
    """Mean |L x| over the vertices a valid face touches, L the uniform
    Laplacian (the mean of a vertex's edge neighbours, each edge of each
    face counted once a direction, minus the vertex)."""
    idx = mesh.indices
    v = mesh.vertices
    mask = mesh.face_mask_or_ones().to(v.dtype)
    acc = torch.zeros_like(v)
    deg = v.new_zeros(mesh.num_vertices)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        va, vb = idx[:, a], idx[:, b]
        acc = acc.index_add(0, va, gather_rows(v, vb) * mask[:, None])
        acc = acc.index_add(0, vb, gather_rows(v, va) * mask[:, None])
        deg = deg.index_add(0, va, mask).index_add(0, vb, mask)
    touched = deg > 0
    lap = acc / torch.clamp(deg, min=1.0)[:, None] - torch.where(touched[:, None], v, 0.0)
    # guarded: an untouched vertex has lap == 0 exactly
    lap_norm = torch.where(touched, torch.sqrt((lap * lap).sum(-1) + 1e-20), 0.0)
    return lap_norm.sum() / torch.clamp(touched.sum(), min=1)


def mesh_normal_consistency(mesh: TriangleMesh) -> torch.Tensor:
    """Mean of 1 - cos between the normals of the faces that share an
    edge. The half-edges are sorted (stably) by the one int64 key lo * V +
    hi of their undirected edge; neighbours in that order with equal keys
    pair up, so on a manifold mesh each interior edge counts once (where
    three or more faces share an edge, which pairs count follows the face
    order)."""
    f = mesh.indices
    normals, _ = mesh.face_normals_and_areas()
    ea = f.reshape(-1)
    eb = f[:, [1, 2, 0]].reshape(-1)
    key = torch.minimum(ea, eb).long() * mesh.num_vertices + torch.maximum(ea, eb).long()
    big = torch.iinfo(torch.int64).max
    key = torch.where(mesh.face_mask_or_ones().repeat_interleave(3), key, big)
    key_s, order = torch.sort(key, stable=True)
    fid = torch.div(order, 3, rounding_mode="floor")
    same = (key_s[1:] == key_s[:-1]) & (key_s[1:] < big)
    cos = (gather_rows(normals, fid[:-1]) * gather_rows(normals, fid[1:])).sum(-1)
    loss = torch.where(same, 1.0 - cos, 0.0)
    return loss.sum() / torch.clamp(same.sum(), min=1)
