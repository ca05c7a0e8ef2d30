"""Cubemap mip chains, the split-sum prefilter and split-sum sampling.

Counterpart of ``geosplatting_tpu/ops/cubemap.py``: ``build_mip_chain``,
``downsample``, ``diffuse_prefilter``, the two specular prefilters
(``specular_prefilter_conv``, the blur training uses, and
``specular_prefilter``, the sampled GGX filter of exact-quality renders),
``prefilter_splitsum``, ``sample_cubemap``, ``sample_splitsum`` over the mip
atlas with nearest or bilinear texels and nearest or trilinear mips, and the
environment BRDF: ``fg_analytic`` for training, ``fg_lut`` /
``sample_fg_lut`` for exact renders. Cubemaps are [6, R, R, C], faces +x,
-x, +y, -y, +z, -z.

Defaults differ from the JAX package's where the port's callers rely on
them: ``prefilter_splitsum`` defaults to ``method="conv"`` and
``sample_splitsum`` to the nearest filters (the training path); an
exact-quality render passes ``"sampled"``, ``"bilinear"`` and
``"trilinear"`` explicitly.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..graphics import gmath
from .segment_rows import gather_rows


def cube_dir(face: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(face, u, v) with u, v in [-1, 1] -> unnormalized direction [..., 3]."""
    one = torch.ones_like(u)
    return [
        lambda: torch.stack((one, -v, -u), -1),
        lambda: torch.stack((-one, -v, u), -1),
        lambda: torch.stack((u, one, v), -1),
        lambda: torch.stack((u, -one, -v), -1),
        lambda: torch.stack((u, -v, one), -1),
        lambda: torch.stack((-u, -v, -one), -1),
    ][face]()


def dir_to_cube_uv(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Direction [..., 3] -> (face, u, v) with u, v in [-1, 1]."""
    x, y, z = d.unbind(-1)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x, torch.where(x > 0, 0, 1),
        torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)),
    )
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az)).clamp(min=1e-3)
    u = torch.where(
        is_x, torch.where(x > 0, -z, z),
        torch.where(is_y, x, torch.where(z > 0, x, -x)),
    ) / ma
    v = torch.where(is_y, torch.where(y > 0, z, -z) / ma, -y / ma)
    return face, u, v


def texel_directions(resolution: int, device=None) -> torch.Tensor:
    """[6, R, R, 3] unit direction at each texel center."""
    t = (torch.arange(resolution, device=device, dtype=torch.float32) + 0.5) / resolution * 2.0 - 1.0
    v, u = torch.meshgrid(t, t, indexing="ij")
    return gmath.safe_normalize(torch.stack([cube_dir(f, u, v) for f in range(6)], 0))


def texel_solid_angles(resolution: int, device=None) -> torch.Tensor:
    """[6, R, R] solid angle of each texel (exact corner integral)."""
    edges = torch.arange(resolution + 1, device=device, dtype=torch.float32) / resolution * 2.0 - 1.0
    gy, gx = torch.meshgrid(edges, edges, indexing="ij")
    a = torch.atan2(gx * gy, torch.sqrt(gx * gx + gy * gy + 1.0))
    sa = a[1:, 1:] - a[:-1, 1:] - a[1:, :-1] + a[:-1, :-1]
    return sa[None].expand(6, resolution, resolution)


def sample_cubemap(data: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear clamp-to-face lookup: data [6, R, R, C], dirs [..., 3] -> [..., C]."""
    r = data.shape[1]
    face, u, v = dir_to_cube_uv(gmath.safe_normalize(dirs))
    fu = (u * 0.5 + 0.5) * r - 0.5
    fv = (v * 0.5 + 0.5) * r - 0.5
    x0 = torch.floor(fu).long().clamp(0, r - 1)
    y0 = torch.floor(fv).long().clamp(0, r - 1)
    x1 = (x0 + 1).clamp(max=r - 1)
    y1 = (y0 + 1).clamp(max=r - 1)
    wx = (fu - x0).clamp(0.0, 1.0)[..., None]
    wy = (fv - y0).clamp(0.0, 1.0)[..., None]
    flat = data.reshape(-1, data.shape[-1])

    def tex(x, y):
        return gather_rows(flat, (face * r + y) * r + x)

    return (
        tex(x0, y0) * (1 - wx) * (1 - wy)
        + tex(x1, y0) * wx * (1 - wy)
        + tex(x0, y1) * (1 - wx) * wy
        + tex(x1, y1) * wx * wy
    )


def downsample(data: torch.Tensor) -> torch.Tensor:
    """2x average-pool mip."""
    f, r, _, c = data.shape
    return data.reshape(f, r // 2, 2, r // 2, 2, c).mean(dim=(2, 4))


def build_mip_chain(data: torch.Tensor, min_resolution: int = 16) -> list[torch.Tensor]:
    chain = [data]
    while chain[-1].shape[1] > min_resolution:
        chain.append(downsample(chain[-1]))
    return chain


def diffuse_prefilter(cube: torch.Tensor) -> torch.Tensor:
    """[6, R, R, 3] -> cosine-hemisphere prefiltered irradiance (dense
    [6R^2, 6R^2] quadrature; R is the small end of the mip chain)."""
    r = cube.shape[1]
    dirs = texel_directions(r, cube.device).reshape(-1, 3)
    areas = texel_solid_angles(r, cube.device).reshape(-1)
    w = torch.clamp(dirs @ dirs.T, min=0.0) * (areas[None, :] / math.pi)
    out = w @ cube.reshape(-1, 3)
    norm = w.sum(1, keepdim=True)
    return (out / norm.clamp(min=1e-8)).reshape(cube.shape)


def _upsample2x(data: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample per face (half-pixel centers, edge clamp):
    [6, R, R, C] -> [6, 2R, 2R, C]."""
    x = data.permute(0, 3, 1, 2)
    x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1)


def _conv1d_last(x: torch.Tensor, k: list[float]) -> torch.Tensor:
    """Valid 1-D convolution along the last axis (symmetric kernel)."""
    n = len(k)
    length = x.shape[-1] - n + 1
    out = x[..., :length] * k[0]
    for i in range(1, n):
        out = out + x[..., i: i + length] * k[i]
    return out


def _face_blur(data: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable per-face Gaussian blur with edge-replicate padding."""
    if sigma <= 0.05:
        return data
    radius = min(int(np.ceil(3.0 * sigma)), data.shape[1] - 1)
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32).tolist()
    # rows (axis 1), then columns (axis 2), each padded by edge replication
    x = data.permute(0, 3, 2, 1)                                   # [6, C, W, H]
    x = torch.cat([x[..., :1].expand(*x.shape[:-1], radius), x,
                   x[..., -1:].expand(*x.shape[:-1], radius)], -1)
    x = _conv1d_last(x, k).permute(0, 1, 3, 2)                     # [6, C, H, W]
    x = torch.cat([x[..., :1].expand(*x.shape[:-1], radius), x,
                   x[..., -1:].expand(*x.shape[:-1], radius)], -1)
    return _conv1d_last(x, k).permute(0, 2, 3, 1)                  # [6, H, W, C]


def specular_prefilter_conv(chain: list[torch.Tensor], roughness: float) -> torch.Tensor:
    """Gaussian-lobe GGX prefilter approximation: blur at the mip whose texel
    pitch matches the lobe, then upsample to chain[0]'s resolution."""
    res = chain[0].shape[1]
    alpha = max(float(roughness), 1e-3)

    def sigma_at(r):
        return 2.0 * alpha * r / np.pi

    level = 0
    while level < len(chain) - 1 and sigma_at(chain[level].shape[1]) > 3.0:
        level += 1
    src = chain[level]
    out = _face_blur(src, sigma_at(src.shape[1]))
    while out.shape[1] < res:
        out = _upsample2x(out)
    return out


@functools.lru_cache(maxsize=32)
def _ggx_sample_pattern(roughness: float, num_samples: int) -> tuple:
    """Hammersley GGX half-vector pattern around +z: numpy arrays
    (local_dirs [S, 3] reflected sample directions for n = v = +z,
    weights [S] = n.l, pdf [S])."""
    alpha = max(roughness, 1e-3) ** 2
    i = np.arange(num_samples)
    u1 = (i + 0.5) / num_samples
    u2 = _radical_inverse(i)
    cos_theta = np.sqrt((1.0 - u1) / (1.0 + (alpha * alpha - 1.0) * u1))
    sin_theta = np.sqrt(np.maximum(1.0 - cos_theta**2, 0.0))
    phi = 2.0 * np.pi * u2
    h = np.stack((sin_theta * np.cos(phi), sin_theta * np.sin(phi), cos_theta), -1)
    v = np.array([0.0, 0.0, 1.0])
    l = 2 * (h @ v)[:, None] * h - v  # noqa: E741  (reflect v about h)
    nl = np.maximum(l[:, 2], 0.0)
    d = _ndf_ggx(alpha * alpha, cos_theta)
    pdf = d * cos_theta / np.maximum(4.0 * (h @ v), 1e-8)
    keep = nl > 1e-4
    return l[keep], nl[keep], np.maximum(pdf[keep], 1e-8)


def _radical_inverse(i: np.ndarray) -> np.ndarray:
    """Van der Corput radical inverse in base 2 (bit reversal of uint32)."""
    bits = i.astype(np.uint32)
    bits = (bits << np.uint32(16)) | (bits >> np.uint32(16))
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF)):
        lo, hi = np.uint32(mask), np.uint32(~mask & 0xFFFFFFFF)
        bits = ((bits & lo) << np.uint32(shift)) | ((bits & hi) >> np.uint32(shift))
    return bits.astype(np.float64) * 2.3283064365386963e-10


def _ndf_ggx(alpha_sqr, cos_theta):
    c = np.clip(cos_theta, 0.0, 1.0)
    d = (c * alpha_sqr - c) * c + 1.0
    return alpha_sqr / (d * d * np.pi)


# bounds the [6, R, R, samples, 3] directions and lookups held at once
_PREFILTER_CHUNK_ELEMS = 1 << 24


def specular_prefilter(chain: list[torch.Tensor], roughness: float, *,
                       num_samples: int = 64) -> torch.Tensor:
    """Prefilter the environment for one roughness at chain[0]'s resolution:
    a fixed GGX sample pattern rotated into each output texel's frame, each
    sample read from the mip whose texel solid angle matches its pdf
    footprint. Samples are taken in chunks so that at most
    ``_PREFILTER_CHUNK_ELEMS`` (texel, sample) lookups are live at once."""
    res = chain[0].shape[1]
    local, w, pdf = _ggx_sample_pattern(float(roughness), num_samples)
    omega_p = 4.0 * np.pi / (6 * res * res)
    omega_s = 1.0 / (num_samples * pdf)
    mip = np.clip(0.5 * np.log2(omega_s / omega_p), 0.0, len(chain) - 1).round().astype(int)

    dev = chain[0].device
    dirs = texel_directions(res, dev)
    t, b = gmath.build_tangent_frame(dirs)
    local_t = torch.as_tensor(local, dtype=torch.float32, device=dev)
    w_t = torch.as_tensor(w, dtype=torch.float32, device=dev)
    step = max(1, _PREFILTER_CHUNK_ELEMS // (6 * res * res))
    acc = chain[0].new_zeros((6, res, res, chain[0].shape[-1]))
    for level in range(len(chain)):
        sel = np.nonzero(mip == level)[0]
        for s0 in range(0, len(sel), step):
            idx = torch.as_tensor(sel[s0:s0 + step], device=dev)
            ls = local_t[idx]
            d = (t[..., None, :] * ls[:, 0, None] + b[..., None, :] * ls[:, 1, None]
                 + dirs[..., None, :] * ls[:, 2, None])               # [6, R, R, S, 3]
            vals = sample_cubemap(chain[level], d)                    # [6, R, R, S, C]
            acc = acc + (vals * w_t[idx][:, None]).sum(-2)
    return acc / w_t.sum()


def prefilter_splitsum(
    cube: torch.Tensor,
    *,
    min_resolution: int = 16,
    min_roughness: float = 0.08,
    max_roughness: float = 0.5,
    num_samples: int = 64,
    method: str = "conv",
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """(diffuse base [6, r, r, 3] at the min resolution, specular mip list
    from full resolution down to the min resolution). ``method="conv"`` is
    the blur approximation of the specular lobes (training),
    ``"sampled"`` the sampled GGX filter (exact-quality renders)."""
    if method not in ("conv", "sampled"):
        raise ValueError(f"prefilter_splitsum: unknown method {method!r}")
    chain = build_mip_chain(cube, min_resolution)
    n = len(chain)
    base = diffuse_prefilter(chain[-1])

    def spec(ch, rough):
        if method == "conv":
            return specular_prefilter_conv(ch, rough)
        return specular_prefilter(ch, rough, num_samples=num_samples)

    mips = []
    for idx in range(n - 1):
        rough = idx / max(n - 2, 1) * (max_roughness - min_roughness) + min_roughness
        mips.append(spec(chain[idx:], rough))
    mips.append(spec(chain[-1:], 1.0))
    return base, mips


def sample_splitsum(
    base: torch.Tensor,
    mips: list[torch.Tensor],
    normals: torch.Tensor,     # [..., 3]
    directions: torch.Tensor,  # [..., 3]
    roughness: torch.Tensor,   # [..., 1]
    *,
    min_roughness: float = 0.08,
    max_roughness: float = 0.5,
    with_diffuse: bool = True,
    filter_mode: str = "nearest",   # 'nearest' | 'bilinear'
    mip_filter: str = "nearest",    # 'nearest' | 'trilinear'
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """(l_diffuse, l_specular): each element gathers the texel(s) of its own
    mip level(s) from the flattened mip atlas, with the roughness -> mip
    level map of the JAX package."""
    if filter_mode not in ("nearest", "bilinear") or mip_filter not in ("nearest", "trilinear"):
        raise ValueError(f"sample_splitsum: unknown filters {filter_mode!r}, {mip_filter!r}")
    n = len(mips)
    miplevel = torch.where(
        roughness < max_roughness,
        ((roughness - min_roughness) / (max_roughness - min_roughness)).clamp(0, 1) * (n - 2),
        ((roughness - max_roughness) / (1.0 - max_roughness)).clamp(0, 1) + n - 2,
    )[..., 0]

    l_diff = sample_cubemap(base, normals) if with_diffuse else None

    face, u, v = dir_to_cube_uv(gmath.safe_normalize(directions))
    atlas = torch.cat([m.reshape(-1, m.shape[-1]) for m in mips])
    res_np = np.asarray([m.shape[1] for m in mips], np.int64)
    offs_np = np.concatenate([[0], np.cumsum(6 * res_np ** 2)[:-1]])
    dev = base.device
    res_t = torch.as_tensor(res_np, device=dev)
    offs_t = torch.as_tensor(offs_np, device=dev)

    def at_level(lvl):
        r = res_t[lvl]
        off = offs_t[lvl]
        rf = r.to(torch.float32)
        fu = (u * 0.5 + 0.5) * rf - 0.5
        fv = (v * 0.5 + 0.5) * rf - 0.5

        def texel(x, y):
            return gather_rows(atlas, off + (face * r + y) * r + x)

        if filter_mode == "nearest":
            x0 = torch.minimum(torch.round(fu).long().clamp(min=0), r - 1)
            y0 = torch.minimum(torch.round(fv).long().clamp(min=0), r - 1)
            return texel(x0, y0)
        x0 = torch.minimum(torch.floor(fu).long().clamp(min=0), r - 1)
        y0 = torch.minimum(torch.floor(fv).long().clamp(min=0), r - 1)
        x1 = torch.minimum(x0 + 1, r - 1)
        y1 = torch.minimum(y0 + 1, r - 1)
        wx = (fu - x0).clamp(0.0, 1.0)[..., None]
        wy = (fv - y0).clamp(0.0, 1.0)[..., None]
        return (texel(x0, y0) * (1 - wx) * (1 - wy) + texel(x1, y0) * wx * (1 - wy)
                + texel(x0, y1) * (1 - wx) * wy + texel(x1, y1) * wx * wy)

    if mip_filter == "trilinear":
        lvl0 = torch.floor(miplevel).long().clamp(0, n - 1)
        frac = (miplevel - lvl0)[..., None]
        l_spec = at_level(lvl0) * (1 - frac) + at_level((lvl0 + 1).clamp(max=n - 1)) * frac
    else:
        l_spec = at_level(torch.round(miplevel).long().clamp(0, n - 1))
    return l_diff, l_spec


def fg_analytic(n_dot_v: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Karis' analytic environment-BRDF approximation: [..., 1] each ->
    [..., 2] (scale, bias)."""
    x = n_dot_v.clamp(0.0, 1.0)
    r = roughness.clamp(0.0, 1.0)
    c0 = torch.tensor([-1.0, -0.0275, -0.572, 0.022], device=x.device)
    c1 = torch.tensor([1.0, 0.0425, 1.04, -0.04], device=x.device)
    t = r * c0 + c1
    a004 = torch.minimum(t[..., 0:1] * t[..., 0:1], torch.exp2(-9.28 * x)) * t[..., 0:1] + t[..., 1:2]
    return torch.cat((a004 * -1.04 + t[..., 2:3], a004 * 1.04 + t[..., 3:4]), -1)


@functools.lru_cache(maxsize=4)
def fg_lut(resolution: int = 256, num_samples: int = 1024) -> tuple:
    """([R, R, 2] split-sum BRDF LUT,): rows roughness, columns n.v, each
    (scale, bias) integrated numerically over a Hammersley GGX pattern with
    Schlick-GGX visibility (k = alpha / 2), in float64 numpy, stored f32."""
    nv = (np.arange(resolution) + 0.5) / resolution
    rough = (np.arange(resolution) + 0.5) / resolution
    nv_g = np.broadcast_to(nv[None, :], (resolution, resolution))
    r_g = np.broadcast_to(rough[:, None], (resolution, resolution))
    a = np.maximum(r_g, 1e-3) ** 2
    # the view vector (vx, 0, nv): only h's x and z reach v . h and l's z
    vx = np.sqrt(np.maximum(1 - nv_g**2, 0.0))
    i = np.arange(num_samples)
    u1 = (i + 0.5) / num_samples
    u2 = _radical_inverse(i)
    scale = np.zeros((resolution, resolution))
    bias = np.zeros((resolution, resolution))
    # the terms that do not change with the sample, each computed as the
    # loop computed it
    a2m1 = a**2 - 1
    kk = a / 2.0
    one_kk = 1 - kk
    g_v = nv_g / (nv_g * one_kk + kk)
    for k in range(num_samples):
        cos_t = np.sqrt((1 - u1[k]) / (1 + a2m1 * u1[k]))
        sin_t = np.sqrt(np.maximum(1 - cos_t**2, 0.0))
        phi = 2 * np.pi * u2[k]
        vh = vx * (sin_t * np.cos(phi)) + nv_g * cos_t
        nl = np.clip(2 * vh * cos_t - nv_g, 0.0, 1.0)
        nh = np.clip(cos_t, 0.0, 1.0)
        vh = np.clip(vh, 0.0, 1.0)
        g = g_v * (nl / (nl * one_kk + kk))
        g_vis = np.where(nl > 0, g * vh / np.maximum(nh * nv_g, 1e-8), 0.0)
        fc = (1 - vh) ** 5
        scale += (1 - fc) * g_vis
        bias += fc * g_vis
    lut = np.stack((scale, bias), -1) / num_samples
    return (lut.astype(np.float32),)


def sample_fg_lut(n_dot_v: torch.Tensor, roughness: torch.Tensor,
                  resolution: int = 256) -> torch.Tensor:
    """Bilinear FG LUT lookup: inputs [..., 1] each -> [..., 2]."""
    (lut_np,) = fg_lut(resolution)
    lut = torch.as_tensor(lut_np, device=n_dot_v.device)
    u = n_dot_v[..., 0].clamp(0.0, 1.0) * resolution - 0.5
    v = roughness[..., 0].clamp(0.0, 1.0) * resolution - 0.5
    x0 = torch.floor(u).long().clamp(0, resolution - 1)
    y0 = torch.floor(v).long().clamp(0, resolution - 1)
    x1 = (x0 + 1).clamp(max=resolution - 1)
    y1 = (y0 + 1).clamp(max=resolution - 1)
    wx = (u - x0).clamp(0, 1)[..., None]
    wy = (v - y0).clamp(0, 1)[..., None]
    return (lut[y0, x0] * (1 - wx) * (1 - wy) + lut[y0, x1] * wx * (1 - wy)
            + lut[y1, x0] * (1 - wx) * wy + lut[y1, x1] * wx * wy)
