"""Quaternion and rotation math for the stage-1 path.

Counterpart of ``geosplatting_tpu/graphics/gmath.py`` (only what stage-1
training calls). Quaternions are wxyz throughout.
"""
from __future__ import annotations

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


def abs_(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient at x == 0 is +1, as ``jnp.abs``'s is (torch's is 0).
    Parameters start at exact zeros (the FlexiCubes weights, a constant
    cubemap's white balance), so the tie decides the first update."""
    return torch.where(x >= 0, x, -x)


def quat2rot(quats: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion(s) -> rotation matrix [..., 3, 3]."""
    r, i, j, k = quats.unbind(-1)
    two_s = 2.0 / (quats * quats).sum(-1)
    o = torch.stack(
        (
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ),
        dim=-1,
    )
    return o.reshape(quats.shape[:-1] + (3, 3))


def rot2quat(rots: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> wxyz quaternion, best-conditioned branch."""
    m = rots.reshape(rots.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.unbind(-1)
    q = torch.stack(
        (
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ),
        dim=-1,
    )
    # floor keeps sqrt's backward finite for degenerate (padded) inputs
    q_abs = torch.sqrt(torch.clamp(q, min=1e-12))
    cand = torch.stack(
        (
            torch.stack((q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01), -1),
            torch.stack((m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20), -1),
            torch.stack((m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21), -1),
            torch.stack((m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2), -1),
        ),
        dim=-2,
    )
    cand = cand / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return torch.gather(cand, -2, idx)[..., 0, :]


def rotation_from_relative_vectors(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Minimal rotation matrix taking unit vector(s) src to dst. [..., 3, 3]."""
    src = safe_normalize(src)
    dst = safe_normalize(dst)
    v = torch.cross(src, dst, dim=-1)
    c = (src * dst).sum(-1)
    vx, vy, vz = v.unbind(-1)
    zero = torch.zeros_like(vx)
    k = torch.stack(
        (zero, -vz, vy, vz, zero, -vx, -vy, vx, zero), dim=-1
    ).reshape(v.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=src.dtype, device=src.device).expand(k.shape)
    scale = (1.0 / torch.clamp(1.0 + c, min=1e-8))[..., None, None]
    r = eye + k + (k @ k) * scale
    # antiparallel fallback: 180-degree flip
    return torch.where((c < -1.0 + 1e-8)[..., None, None], -eye, r)
