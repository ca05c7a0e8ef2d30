"""A learnable monotone curve mapping [0, 1] -> [0, 1], one per channel.

Counterpart of ``geosplatting_tpu/utils/curve_mapping.py``: a piecewise-
linear curve whose control-point gaps are exp(params), so it is monotone by
construction, normalised to end at exactly 1 (a learnable tone or response
curve). The parameters are a plain ``{"log_gaps": [K, C]}`` dict of
tensors (leaf tensors with ``requires_grad`` to learn them).
"""
from __future__ import annotations

import torch


def init_curve(generator: torch.Generator | None, num_control_points: int, feature_dim: int,
               device: str | torch.device | None = None) -> dict:
    """``{"log_gaps": N(0, 0.1^2) [K, C]}`` drawn from ``generator``."""
    return {"log_gaps": torch.randn((num_control_points, feature_dim), generator=generator,
                                    device=device) * 0.1}


def curve_bins(params: dict) -> torch.Tensor:
    """Normalised cumulative control points [K, C]."""
    cp = torch.cumsum(torch.exp(params["log_gaps"]), 0)
    return cp / cp[-1:]


def apply_curve(params: dict, inputs: torch.Tensor, *,
                point_distribution: str = "uniform") -> torch.Tensor:
    """The curve of each channel at ``inputs`` [..., C] in [0, 1]: linear
    between the normalised cumulative control points, placed uniformly or
    on a log / exp scale ('uniform' | 'log' | 'exp'). No gradient reaches
    ``inputs``."""
    log_gaps = params["log_gaps"]
    k = log_gaps.shape[0]
    curve = torch.cumsum(torch.exp(log_gaps), 0)                   # [K, C]
    curve = torch.cat((torch.zeros_like(curve[:1]), curve))
    curve = curve / curve[-1:]                                     # [K + 1, C]

    x = inputs.detach() * (1 - 1e-6)
    if point_distribution == "log":
        x = torch.log2(x + 1.0)
    elif point_distribution == "exp":
        x = 2.0 ** x - 1.0
    elif point_distribution != "uniform":
        raise ValueError(point_distribution)

    t = torch.clamp(x, 0.0, 1.0 - 1e-6) * k
    idx = torch.floor(t).long()                                    # [..., C]
    w = t - idx
    ch = torch.arange(curve.shape[1], device=curve.device)
    lo = curve[idx, ch]
    hi = curve[idx + 1, ch]
    return lo * (1 - w) + hi * w

