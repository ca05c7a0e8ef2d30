"""3D Gaussian -> 2D screen-space projection (EWA splatting).

Counterpart of ``geosplatting_tpu/ops/projection.py``: world->camera
transform, perspective projection of means, EWA 2D covariance with a 0.3 px
low-pass, antialiased opacity compensation, eigenvalue screen radius, the
opacity-aware tight bounds (``extents`` / ``prune_r``) and frustum culling,
which with ``radius_clip`` also culls Gaussians of a screen radius at most
that many pixels. Gradients come from autograd.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..graphics import gmath

LOWPASS = 0.3
MIN_ALPHA = 1.0 / 255.0


class Projected(NamedTuple):
    means2d: torch.Tensor    # [N, 2] pixel coords
    depths: torch.Tensor     # [N]
    conics: torch.Tensor     # [N, 3] inverse cov2d (a, b, c)
    opacities: torch.Tensor  # [N] post-compensation opacities
    radii: torch.Tensor      # [N] int32 screen radius (0 = culled)
    # the opacity-aware bounds that ``bin_pairs`` reads; None where the
    # caller has only a circular radius (2DGS: ``bin_gaussians`` then bins
    # by ``radii``)
    extents: torch.Tensor | None = None  # [N, 2] half-widths of the alpha >= 1/255 region
    prune_r: torch.Tensor | None = None  # [N] circular bound of the same region


def project(
    means: torch.Tensor,      # [N, 3]
    quats: torch.Tensor,      # [N, 4] wxyz
    scales: torch.Tensor,     # [N, 3] linear
    opacities: torch.Tensor,  # [N]
    viewmat: torch.Tensor,    # [4, 4] world->camera (+z forward)
    K: torch.Tensor,          # [3, 3]
    width: int,
    height: int,
    *,
    near: float = 0.01,
    far: float = 1e10,
    rasterize_mode: str = "antialiased",
    radius_clip: float = 0.0,
) -> Projected:
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    p_cam = means @ R.T + t
    z = p_cam[:, 2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    rz = 1.0 / torch.clamp(z.abs(), min=1e-8) * torch.sign(z + 1e-30)
    mean2d = torch.stack((fx * p_cam[:, 0] * rz + cx, fy * p_cam[:, 1] * rz + cy), -1)

    q = gmath.safe_normalize(quats)
    qw, qx, qy, qz = q.unbind(-1)
    rot = (
        (1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)),
        (2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)),
        (2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)),
    )
    B = tuple(
        tuple(R[i, 0] * rot[0][j] + R[i, 1] * rot[1][j] + R[i, 2] * rot[2][j] for j in range(3))
        for i in range(3)
    )
    s2 = (scales[:, 0] ** 2, scales[:, 1] ** 2, scales[:, 2] ** 2)

    def sig(i, k):  # cam-space covariance entry
        return sum(B[i][j] * B[k][j] * s2[j] for j in range(3))

    lim_x = 1.3 * (0.5 * width / fx + torch.abs(cx / fx - 0.5 * width / fx))
    lim_y = 1.3 * (0.5 * height / fy + torch.abs(cy / fy - 0.5 * height / fy))
    tx = z * torch.clamp(p_cam[:, 0] * rz, -lim_x, lim_x)
    ty = z * torch.clamp(p_cam[:, 1] * rz, -lim_y, lim_y)

    u = fx * rz
    v = fy * rz
    pu = -fx * tx * rz * rz
    pv = -fy * ty * rz * rz
    a = u * u * sig(0, 0) + 2 * u * pu * sig(0, 2) + pu * pu * sig(2, 2)
    b = u * v * sig(0, 1) + u * pv * sig(0, 2) + pu * v * sig(1, 2) + pu * pv * sig(2, 2)
    c = v * v * sig(1, 1) + 2 * v * pv * sig(1, 2) + pv * pv * sig(2, 2)
    det_orig = a * c - b * b
    a_b = a + LOWPASS
    c_b = c + LOWPASS
    det = a_b * c_b - b * b

    if rasterize_mode == "antialiased":
        # clamp: sqrt's backward at 0 would turn flat Gaussians into NaNs
        ratio = torch.clamp(det_orig / torch.clamp(det, min=1e-12), 1e-10, 1.0)
        op = opacities * torch.sqrt(ratio)
    elif rasterize_mode == "classic":
        op = opacities
    else:
        raise ValueError(f"unknown rasterize_mode: {rasterize_mode}")

    inv_det = 1.0 / torch.clamp(det, min=1e-12)
    conic = torch.stack((c_b * inv_det, -b * inv_det, a_b * inv_det), -1)

    mid = 0.5 * (a_b + c_b)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    # alpha = op e^-sigma clears MIN_ALPHA only where sigma <= log(op / MIN_ALPHA)
    t2 = 2.0 * torch.log(torch.clamp(op, min=1e-8) * (1.0 / MIN_ALPHA))
    t2 = torch.clamp(t2, min=0.0)
    ext_x = torch.minimum(torch.sqrt(t2 * a_b) + 0.01, radius)
    ext_y = torch.minimum(torch.sqrt(t2 * c_b) + 0.01, radius)
    prune_r = torch.sqrt(t2 * lam) + 0.01

    valid = (
        (z > near) & (z < far) & (det > 1e-12) & (op > MIN_ALPHA)
        & (mean2d[:, 0] + ext_x > 0) & (mean2d[:, 0] - ext_x < width)
        & (mean2d[:, 1] + ext_y > 0) & (mean2d[:, 1] - ext_y < height)
        & (radius > radius_clip)
    )
    radii = torch.where(valid, radius, 0.0).to(torch.int32)
    keep = valid.to(means.dtype)
    return Projected(
        means2d=mean2d, depths=z, conics=conic, opacities=op, radii=radii,
        extents=torch.stack((ext_x * keep, ext_y * keep), -1),
        prune_r=prune_r * keep,
    )
