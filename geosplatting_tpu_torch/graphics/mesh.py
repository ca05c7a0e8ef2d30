"""Triangle mesh with padded static buffers and masked-face semantics.

Counterpart of ``geosplatting_tpu/graphics/mesh.py`` (``TriangleMesh`` with
``face_mask``, ``face_vertices`` and ``vertex_normals``).
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
