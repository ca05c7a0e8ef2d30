"""Chamfer distance and F-score between point sets.

Counterpart of ``geosplatting_tpu/ops/chamfer.py``: the all-pairs nearest
squared distance by the expansion |a|^2 - 2 a.b + |b|^2, over chunks of
4096 rows of ``a``, clamped at 0. The product is a plain matrix product
(``torch.matmul``), as it is a plain ``jnp`` product in the JAX package.
"""
from __future__ import annotations

import torch


def _nearest_sqdist(a: torch.Tensor, b: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """min_j |a_i - b_j|^2 for each a_i. a [N, 3], b [M, 3] -> [N]."""
    b_sq = (b * b).sum(-1)                                     # [M]
    out = torch.cat([
        ((ac * ac).sum(-1)[:, None] - 2.0 * ac @ b.T + b_sq[None, :]).amin(-1)
        for ac in torch.split(a, chunk)
    ])
    return torch.clamp(out, min=0.0)


def chamfer_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric mean chamfer distance between point sets [N, 3], [M, 3]."""
    return 0.5 * (torch.sqrt(_nearest_sqdist(a, b) + 1e-20).mean()
                  + torch.sqrt(_nearest_sqdist(b, a) + 1e-20).mean())


def f_score(a: torch.Tensor, b: torch.Tensor, threshold: float = 0.01) -> torch.Tensor:
    """F-score of the two sets at a distance threshold."""
    precision = (torch.sqrt(_nearest_sqdist(a, b) + 1e-20) < threshold).float().mean()
    recall = (torch.sqrt(_nearest_sqdist(b, a) + 1e-20) < threshold).float().mean()
    return 2 * precision * recall / torch.clamp(precision + recall, min=1e-8)
