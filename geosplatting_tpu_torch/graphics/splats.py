"""3D Gaussian splat container (counterpart of
``geosplatting_tpu/graphics/splats.py``'s ``Splats``). ``scales`` are
log-scales and ``opacities`` are logits."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Splats:
    means: torch.Tensor      # [N, 3]
    scales: torch.Tensor     # [N, 3] (log)
    quats: torch.Tensor      # [N, 4] (wxyz)
    colors: torch.Tensor     # [N, 3] (stage 1: shading normals)
    opacities: torch.Tensor  # [N, 1] (logit)

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    def replace(self, **kw) -> "Splats":
        return dataclasses.replace(self, **kw)
