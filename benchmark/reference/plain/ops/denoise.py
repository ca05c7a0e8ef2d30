"""Cross-bilateral denoiser over (normal, depth) guides.

Counterpart of ``geosplatting_tpu/ops/denoise.py``: the weight of a tap at
offset d is exp(-|d|^2 / 2 sigma^2) * clip(n . n', 1e-4, 1)^128 *
exp(-|z - z'| / max(dz |d|, 1e-4)), out-of-bounds taps weigh 0, and the sum
is normalised by the accumulated weight. The guides are detached: gradients
reach the colour only. Stage 2 calls it on [1, N, C], so the window runs
along the Gaussian axis.
"""
from __future__ import annotations

import math

import torch


def bilateral_denoise(
    color: torch.Tensor,                      # [H, W, C]
    normal: torch.Tensor,                     # [H, W, 3]
    depth: torch.Tensor,                      # [H, W, 1]
    depth_grad: torch.Tensor | None = None,   # [H, W, 1] dz scale; default 1
    *,
    sigma: float = 2.0,
) -> torch.Tensor:
    variance = sigma * sigma
    rad = int(2 * -(-sigma * 2.5 // 1) + 1)
    if depth_grad is None:
        depth_grad = torch.ones_like(depth)
    normal = normal.detach()
    depth = depth.detach()
    depth_grad = depth_grad.detach()

    h, w = color.shape[:2]
    yy = torch.arange(h, device=color.device)[:, None, None]
    xx = torch.arange(w, device=color.device)[None, :, None]
    acc = torch.zeros_like(color)
    acc_w = color.new_zeros(color.shape[:2] + (1,))
    for fy in range(-rad, rad + 1):
        if abs(fy) >= h:
            continue  # the whole row is out of bounds (the [1, N] use)
        for fx in range(-rad, rad + 1):
            if abs(fx) >= w:
                continue
            t_col = torch.roll(color, (-fy, -fx), dims=(0, 1))
            t_nrm = torch.roll(normal, (-fy, -fx), dims=(0, 1))
            t_z = torch.roll(depth, (-fy, -fx), dims=(0, 1))
            dist_sqr = fx * fx + fy * fy
            w_xy = math.exp(-dist_sqr / (2.0 * variance))
            w_n = torch.clamp((t_nrm * normal).sum(-1, keepdim=True), 1e-4, 1.0) ** 128.0
            w_z = torch.exp(
                -(t_z - depth).abs() / torch.clamp(depth_grad * math.sqrt(dist_sqr), min=1e-4)
            )
            in_b = (yy + fy >= 0) & (yy + fy < h) & (xx + fx >= 0) & (xx + fx < w)
            wgt = torch.where(in_b, w_xy * w_n * w_z, 0.0)
            acc = acc + t_col * wgt
            acc_w = acc_w + wgt
    return acc / torch.clamp(acc_w, min=1e-4)
