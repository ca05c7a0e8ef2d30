"""Quaternion, rotation, spherical-harmonics and sampling math.

Counterpart of ``geosplatting_tpu/graphics/gmath.py`` (what the three
stages, their exact-quality validation, vanilla 3DGS, the shaders and the
rendered layouts call). Quaternions are wxyz throughout. The samplers draw
from a ``torch.Generator`` where the JAX package splits a key.
"""
from __future__ import annotations

import math

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return (a * b).sum(-1, keepdim=keepdim)


def reflect(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x mirrored about n: 2 (n . x) n - x."""
    return 2.0 * dot(n, x) * n - x


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


def build_tangent_frame(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless orthonormal tangent/bitangent for normal(s) n (Frisvad)."""
    sign = torch.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t = torch.cat((1.0 + sign * n[..., 0:1] ** 2 * a, sign * b, -sign * n[..., 0:1]), -1)
    bt = torch.cat((b, sign + n[..., 1:2] ** 2 * a, -n[..., 1:2]), -1)
    return t, bt


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


# --- spherical harmonics (the vanilla 3DGS colours) --------------------------------

SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435)


def rgb2sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / SH_C0


def sh2rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * SH_C0 + 0.5


def sh_deg2dim(deg: int) -> int:
    return (deg + 1) ** 2


def sh_dim2deg(dim: int) -> int:
    deg = int(round(dim ** 0.5)) - 1
    if sh_deg2dim(deg) != dim:
        raise ValueError(f"invalid sh dim {dim}")
    return deg


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH of degree ``deg`` (0-3) with coefficients sh [..., (deg+1)^2, C]
    at unit directions [..., 3] -> [..., C], term by term in the JAX
    package's order."""
    result = SH_C0 * sh[..., 0, :]
    if deg >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - _SH_C1 * y * sh[..., 1, :] + _SH_C1 * z * sh[..., 2, :]
                  - _SH_C1 * x * sh[..., 3, :])
        if deg >= 2:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + _SH_C2[0] * xy * sh[..., 4, :]
                      + _SH_C2[1] * yz * sh[..., 5, :]
                      + _SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                      + _SH_C2[3] * xz * sh[..., 7, :]
                      + _SH_C2[4] * (xx - yy) * sh[..., 8, :])
            if deg >= 3:
                result = (result
                          + _SH_C3[0] * y * (3 * xx - yy) * sh[..., 9, :]
                          + _SH_C3[1] * xy * z * sh[..., 10, :]
                          + _SH_C3[2] * y * (4 * zz - xx - yy) * sh[..., 11, :]
                          + _SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12, :]
                          + _SH_C3[4] * x * (4 * zz - xx - yy) * sh[..., 13, :]
                          + _SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                          + _SH_C3[6] * x * (xx - 3 * yy) * sh[..., 15, :])
    return result


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions [..., 4]."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack((
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ), -1)


def slerp_quat(qa: torch.Tensor, qb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation from qa (w = 0) to qb (w = 1) along the
    shorter arc."""
    cos = (qa * qb).sum(-1)
    neg = cos < 0
    cos = torch.where(neg, -cos, cos)
    qa = torch.where(neg[..., None], -qa, qa)
    angle = torch.clamp(torch.arccos(torch.clamp(cos, -1.0, 1.0 - 1e-7)), min=1e-8)
    isin = 1.0 / torch.sin(angle)
    return (qa * (torch.sin((1 - w) * angle) * isin)[..., None]
            + qb * (torch.sin(w * angle) * isin)[..., None])


def random_quaternion(shape: tuple[int, ...], *, generator: torch.Generator | None = None,
                      device=None, normal: torch.Tensor | None = None) -> torch.Tensor:
    """Uniform random unit quaternions: normalised standard-normal draws
    [*shape, 4], from ``generator`` or injected as ``normal``."""
    if normal is None:
        normal = torch.randn(tuple(shape) + (4,), generator=generator, device=device)
    return safe_normalize(normal)


def sample_sphere(shape: tuple[int, ...], *, generator: torch.Generator | None = None,
                  device=None) -> torch.Tensor:
    """Uniform unit directions [*shape, 3]: normalised standard normals."""
    return safe_normalize(torch.randn(tuple(shape) + (3,), generator=generator, device=device))


def sample_hemisphere_cosine(shape: tuple[int, ...], *, generator: torch.Generator | None = None,
                             device=None) -> torch.Tensor:
    """Cosine-weighted directions about +z [*shape, 3] from two uniforms."""
    u1 = torch.rand(tuple(shape), generator=generator, device=device)
    u2 = torch.rand(tuple(shape), generator=generator, device=device)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    return torch.stack((r * torch.cos(phi), r * torch.sin(phi),
                        torch.sqrt(torch.clamp(1.0 - u1, min=0.0))), -1)


def dir_to_latlng_uv(d: torch.Tensor) -> torch.Tensor:
    """Unit direction -> equirectangular uv in [0, 1]^2 (u: azimuth with -z
    at u = 0.5; v: polar angle from +y)."""
    d = safe_normalize(d)
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    u = torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * math.pi) + 0.5
    return torch.stack((u, theta / math.pi), -1)


def latlng_dir(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """(theta in [0, pi] from the +y pole, phi in [-pi, pi) with 0 at -z)
    -> unit direction, y up: the inverse of ``dir_to_latlng_uv`` with phi
    = (u - 0.5) 2 pi."""
    sin_t = torch.sin(theta)
    return torch.stack((sin_t * torch.sin(phi), torch.cos(theta), -sin_t * torch.cos(phi)), -1)
