"""2D Gaussian Splatting rasterization (ray-splat intersection).

Counterpart of ``geosplatting_tpu/ops/rasterize_2dgs.py`` (gsplat's
``rasterization_2dgs`` contract): each Gaussian is a flat oriented disk;
every pixel ray is intersected with the splat plane and the Gaussian is
evaluated at the intersection's (u, v) splat coordinates. Outputs: colour
(+ depth), alpha, rendered normals, depth-derived pseudo normals, a
per-pixel distortion map and the median depth, plus the screen-space
densification hook ``offset2d``.

The JAX package composites 2DGS in plain ``jnp`` differentiated by XLA (no
Pallas kernel); here it is plain PyTorch differentiated by autograd, every
tile chunk under ``torch.utils.checkpoint`` as every chunk is under
``jax.checkpoint`` there. Binning is the dense tile table of
``rasterize.bin_gaussians`` by the circular radius; ``rasterize_2dgs_batched``
(the JAX model's ``vmap`` of the render) bins a batch of cameras in one
sort (``bin_gaussians_batched``), then composites each camera as
``rasterize_2dgs`` does, to the same bits. Tiles are independent,
so a chunk's tiles are taken in order of falling pair count and the chunk is
evaluated only as deep as its fullest tile (the padded slots have alpha 0
and add nothing); on the CPU a chunk holds ``tile_chunk`` tiles' worth of
the JAX chunk ([tile_chunk, tile_capacity, P]), on the card as many as the
free device memory allows. Both keep the result within float reassociation.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..graphics import gmath
from .projection import Projected
from .rasterize import (
    MAX_ALPHA, MIN_ALPHA, TRANSMITTANCE_EPS, RENDER_MODES, TileBins, _tile_pixel_grid,
    _tiles_to_image, bin_gaussians, bin_gaussians_batched, tile_origins,
)
from .segment_rows import gather_rows

# screen-space low-pass: rho2d = FILTER_INV_SQUARE * |pix - mean2d|^2,
# the official 2DGS kernel's degenerate-view guard
FILTER_INV_SQUARE = 2.0
# alpha >= MIN_ALPHA can extend to sqrt(-2 ln(1/255)) ~ 3.33 sigma for
# opacity 1, so the screen bounds are taken at 3.4 sigma
SIGMA_BOUND = 3.4
# low-pass support: FILTER_INV_SQUARE * d^2 = -2 ln(MIN_ALPHA) at d ~ 2.36 px
LOWPASS_RADIUS = 2.4

# a chunk's recomputed forward and its backward hold about 64 float32
# tensors of the chunk's [tiles, depth, pixels] shape at once
_LIVE_BYTES_PER_ELEM = 256
_MAX_CHUNK_ELEMS = 1 << 25


def project_2dgs(
    means: torch.Tensor,      # [N, 3]
    quats: torch.Tensor,      # [N, 4] wxyz (normalized)
    scales: torch.Tensor,     # [N, >=2] linear; the first two are the disk axes
    viewmat: torch.Tensor,    # [4, 4] world->camera (+z forward)
    K: torch.Tensor,          # [3, 3]
    width: int,
    height: int,
    *,
    near: float = 0.01,
    far: float = 1e10,
):
    """Returns (record [N, 17], center2d [N, 2], depths [N], radii [N] int32).

    record columns: T rows (9) | z-row (3) | camera-space normal (3) |
    projected centre (2). T maps splat-plane homogeneous (u, v, 1) to pixel
    homogeneous coordinates; the z-row gives camera depth at (u, v)."""
    rw = viewmat[:3, :3]
    tvec = viewmat[:3, 3]
    r = gmath.quat2rot(quats)                     # [N, 3, 3] columns = axes
    m1 = (r[:, :, 0] @ rw.T) * scales[:, 0:1]     # camera-space tangent axes
    m2 = (r[:, :, 1] @ rw.T) * scales[:, 1:2]
    n_cam = r[:, :, 2] @ rw.T
    m3 = means @ rw.T + tvec                      # centre in camera space
    z = m3[:, 2]

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    t00 = fx * m1[:, 0] + cx * m1[:, 2]
    t01 = fx * m2[:, 0] + cx * m2[:, 2]
    t02 = fx * m3[:, 0] + cx * m3[:, 2]
    t10 = fy * m1[:, 1] + cy * m1[:, 2]
    t11 = fy * m2[:, 1] + cy * m2[:, 2]
    t12 = fy * m3[:, 1] + cy * m3[:, 2]
    t20 = m1[:, 2]
    t21 = m2[:, 2]
    t22 = m3[:, 2]

    # screen box from the dual conic of the SIGMA_BOUND-sigma disk boundary:
    # D = T diag(1, 1, -1/s^2) T^T; tangent verticals at
    # x = (D02 +- sqrt(D02^2 - D00 D22)) / D22
    s2 = SIGMA_BOUND * SIGMA_BOUND
    d22 = t20 * t20 + t21 * t21 - t22 * t22 / s2
    d02 = t00 * t20 + t01 * t21 - t02 * t22 / s2
    d12 = t10 * t20 + t11 * t21 - t12 * t22 / s2
    d00 = t00 * t00 + t01 * t01 - t02 * t02 / s2
    d11 = t10 * t10 + t11 * t11 - t12 * t12 / s2
    bounded = d22 < -1e-9                         # ellipse wholly in front
    d22_safe = torch.where(bounded, d22, -1.0)
    ctr_x = d02 / d22_safe
    ctr_y = d12 / d22_safe
    half_x = torch.sqrt(torch.clamp(d02 * d02 - d00 * d22_safe, min=0.0)) / -d22_safe
    half_y = torch.sqrt(torch.clamp(d12 * d12 - d11 * d22_safe, min=0.0)) / -d22_safe

    # projected splat centre (low-pass anchor and densification statistic)
    t22_safe = torch.where(torch.abs(t22) > 1e-8, t22, 1e-8)
    mean2d = torch.stack((t02 / t22_safe, t12 / t22_safe), -1)

    # the binning box covers the 3.4-sigma ellipse and the low-pass disk
    # around the projected centre
    center2d = torch.stack((ctr_x, ctr_y), -1)
    shift = torch.abs(center2d - mean2d).amax(-1)
    radius = torch.ceil(torch.maximum(torch.maximum(half_x, half_y), shift + LOWPASS_RADIUS))
    inside = ((ctr_x + radius > 0) & (ctr_x - radius < width)
              & (ctr_y + radius > 0) & (ctr_y - radius < height))
    valid = bounded & (z > near) & (z < far) & inside & (radius > 0)
    radii = torch.where(valid, radius, 0.0).to(torch.int32)

    # the splat normal faces the viewer (the camera at the origin), as the
    # depth-derived pseudo normals it is compared with do
    facing_away = (n_cam * m3).sum(-1, keepdim=True) > 0
    n_cam = torch.where(facing_away, -n_cam, n_cam)

    record = torch.stack((t00, t01, t02, t10, t11, t12, t20, t21, t22,
                          m1[:, 2], m2[:, 2], m3[:, 2]), -1)
    record = torch.cat((record, n_cam, mean2d), -1)   # [N, 17]
    return record, center2d, z, radii


def _chunk_elems(device: torch.device, tile_chunk: int, capacity: int, npx: int) -> int:
    """[tiles, depth, pixels] elements one chunk may take."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return max(min(free // _LIVE_BYTES_PER_ELEM, _MAX_CHUNK_ELEMS), capacity * npx)
    return tile_chunk * capacity * npx


def _composite_chunk(gid, origin, packed, pix_local, near: float):
    """One chunk of tiles: gid [Ct, K] -> the six [Ct, P, ...] sums."""
    safe = gid.clamp(min=0)
    live = gid >= 0                                   # [Ct, K]
    rec = gather_rows(packed, safe)                   # [Ct, K, 20 + C]
    t0x, t0y, t0z = (rec[..., i, None] for i in range(0, 3))     # rows of T
    t1x, t1y, t1z = (rec[..., i, None] for i in range(3, 6))
    t2x, t2y, t2z = (rec[..., i, None] for i in range(6, 9))
    zrow = rec[..., 9:12]
    n_cam = rec[..., 12:15]
    c2d = rec[..., 15:17]
    op = rec[..., 17]
    off = rec[..., 18:20]
    col = rec[..., 20:]

    pix = origin[:, None, :] + pix_local[None]        # [Ct, P, 2]
    # shifting the splat by +off on screen == evaluating at pix - off
    px = pix[:, None, :, 0] - off[:, :, None, 0]      # [Ct, K, P]
    py = pix[:, None, :, 1] - off[:, :, None, 1]

    # ray-splat intersection by the homogeneous planes' cross product:
    # h_u = T0 - px T2, h_v = T1 - py T2, s = h_u x h_v, (u, v) = s.xy / s.z
    hux, huy, huz = t0x - px * t2x, t0y - px * t2y, t0z - px * t2z
    hvx, hvy, hvz = t1x - py * t2x, t1y - py * t2y, t1z - py * t2z
    sx = huy * hvz - huz * hvy
    sy = huz * hvx - hux * hvz
    sz = hux * hvy - huy * hvx
    sz_safe = torch.where(torch.abs(sz) > 1e-9, sz, 1e-9)
    u = sx / sz_safe
    v = sy / sz_safe
    rho3d = u * u + v * v
    dx2 = pix[:, None, :, 0] - c2d[:, :, None, 0] - off[:, :, None, 0]
    dy2 = pix[:, None, :, 1] - c2d[:, :, None, 1] - off[:, :, None, 1]
    rho2d = FILTER_INV_SQUARE * (dx2 * dx2 + dy2 * dy2)
    rho = torch.minimum(rho3d, rho2d)

    zdep = zrow[..., 0:1] * u + zrow[..., 1:2] * v + zrow[..., 2:3]

    alpha = torch.clamp(op[..., None] * torch.exp(-0.5 * rho), max=MAX_ALPHA)
    keep = (alpha >= MIN_ALPHA) & (zdep > near) & live[:, :, None]
    alpha = torch.where(keep, alpha, 0.0)

    log_t = torch.cumsum(torch.log1p(-alpha), 1)      # inclusive
    t_excl = torch.exp(log_t - torch.log1p(-alpha))
    w = torch.where(t_excl > TRANSMITTANCE_EPS, alpha * t_excl, 0.0)

    out_c = torch.einsum("tkp,tkc->tpc", w, col)
    out_a = w.sum(1)
    out_d = (w * zdep).sum(1)
    out_n = torch.einsum("tkp,tkc->tpc", w, n_cam)

    # distortion (Mip-NeRF 360's pairwise |m_i - m_j|, front-to-back):
    # 2 sum_i w_i (m_i A_{i-1} - D_{i-1}), m = NDC-like depth in [0, 1)
    m = torch.where(keep, 1.0 - near / torch.clamp(zdep, min=near), 0.0)
    a_incl = torch.cumsum(w, 1)
    d_incl = torch.cumsum(w * m, 1)
    out_dist = (2.0 * w * (m * (a_incl - w) - (d_incl - w * m))).sum(1)

    # median depth: z of the first pair whose inclusive weight crosses 0.5
    reached = a_incl >= 0.5
    first = reached & ~torch.cat((torch.zeros_like(reached[:, :1]), reached[:, :-1]), 1)
    out_med = torch.where(first, zdep, 0.0).sum(1)
    return out_c, out_a, out_d, out_n, out_dist, out_med


def composite_tiles_2dgs(
    tile_gid: torch.Tensor,     # [T, K]
    tile_origin: torch.Tensor,  # [T, 2]
    record: torch.Tensor,       # [N, 17]
    opacities: torch.Tensor,    # [N]
    colors: torch.Tensor,       # [N, C]
    offset2d: torch.Tensor,     # [N, 2] densification gradient hook (zeros)
    *,
    near: float,
    tile_size: int,
    tile_chunk: int = 4,
):
    """Per-tile composite. Returns (colour [T, P, C], alpha [T, P], depth
    [T, P], normal [T, P, 3], distortion [T, P], median depth [T, P])."""
    dev = tile_gid.device
    num_tiles, capacity = tile_gid.shape
    pix_local = _tile_pixel_grid(tile_size, dev)
    npx = pix_local.shape[0]
    packed = torch.cat((record, opacities[:, None], offset2d, colors), -1)   # [N, 20 + C]

    # the chunks, planned on the host from the tiles' pair counts (tile_gid
    # holds each tile's pairs at its front): tiles by falling count, each
    # chunk as deep as its first (fullest) tile, at least 1, so that every
    # render reaches the parameters' graph
    counts = (tile_gid >= 0).sum(1)
    order = torch.argsort(counts, descending=True, stable=True)
    depth_of = torch.clamp(counts[order], min=1).tolist()
    elems = _chunk_elems(dev, tile_chunk, capacity, npx)
    outs = []
    i = 0
    while i < num_tiles:
        depth = depth_of[i]
        tiles = order[i:i + max(1, elems // (depth * npx))]
        outs.append(checkpoint(_composite_chunk, tile_gid[tiles, :depth], tile_origin[tiles],
                               packed, pix_local, near, use_reentrant=False))
        i += tiles.shape[0]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(num_tiles, device=dev)
    return tuple(torch.cat(o)[inv] for o in zip(*outs))


def depth_to_camera_normals(depth: torch.Tensor, alpha: torch.Tensor,
                            K: torch.Tensor) -> torch.Tensor:
    """Pseudo normals [H, W, 3] from an expected-depth map by central
    differences of back-projected camera-space positions, wrapping at the
    image border as the JAX package's ``jnp.roll`` does."""
    h, w = depth.shape[:2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = depth[..., 0]
    xs = (torch.arange(w, dtype=torch.float32, device=depth.device) + 0.5 - cx) / fx
    ys = (torch.arange(h, dtype=torch.float32, device=depth.device) + 0.5 - cy) / fy
    p = torch.stack((xs[None, :] * z, ys[:, None] * z, z), -1)    # [H, W, 3]
    ddx = torch.roll(p, -1, 1) - torch.roll(p, 1, 1)
    ddy = torch.roll(p, -1, 0) - torch.roll(p, 1, 0)
    n = gmath.safe_normalize(torch.cross(ddx, ddy, dim=-1))
    # towards the viewer (camera at the origin, +z forward: n.z < 0)
    n = torch.where((n * p).sum(-1, keepdim=True) > 0, -n, n)
    return torch.where(alpha > 1e-3, n, 0.0)


def _project_and_shade(means, quats, scales, colors, viewmat, K, width, height, *, near, far,
                       sh_degree):
    """One camera's projection (``project_2dgs``) and its colours (the SH
    evaluated towards that camera where ``sh_degree`` is given)."""
    with record_function("rasterize.2dgs_project"):
        record, center2d, depths, radii = project_2dgs(
            means, quats, scales, viewmat, K, width, height, near=near, far=far)
    if sh_degree is not None:
        campos = -viewmat[:3, :3].T @ viewmat[:3, 3]
        viewdir = gmath.safe_normalize(means - campos)
        colors = torch.clamp(gmath.eval_sh(sh_degree, colors, viewdir) + 0.5, min=0.0)
    return record, center2d, depths, radii, colors


def _composite_camera(bins: TileBins, record, center2d, depths, radii, opacities, colors,
                      offset2d, K, width: int, height: int, *, near: float, tile_size: int,
                      tile_capacity: int, max_pairs: int, render_mode: str, tile_chunk: int):
    """One camera's composite from its tile table: ``rasterize_2dgs``'s
    seven outputs."""
    tw, th = bins.num_tiles_xy
    with record_function("rasterize.2dgs_composite"):
        tiles = composite_tiles_2dgs(
            bins.tile_gid, tile_origins(tw, th, tile_size, record.device), record, opacities,
            colors, offset2d, near=near, tile_size=tile_size, tile_chunk=tile_chunk)
    grid = (tw, th, tile_size, tile_size)
    img_c, img_a, img_d, img_n, img_dist, img_med = (
        _tiles_to_image(x if x.dim() == 3 else x[..., None], grid, height, width)
        for x in tiles)

    ed = img_d / torch.clamp(img_a, min=1e-10)
    depth = ed if render_mode in ("ED", "RGB+ED") else img_d
    if render_mode == "RGB":
        render = img_c
    elif render_mode in ("ED", "D"):
        render = depth
    else:
        render = torch.cat((img_c, depth), -1)

    normals_from_depth = depth_to_camera_normals(ed, img_a, K)
    info = {
        "means2d": record[:, 15:17],
        "center2d": center2d,
        "radii": radii,
        "depths": depths,
        "total_pairs": bins.total_pairs,
        "max_pairs": max_pairs,
        "max_tile_pairs": bins.max_tile_pairs,
        "tile_capacity": tile_capacity,
    }
    return render, img_a, img_n, normals_from_depth, img_dist, img_med, info


def _bin_input(center2d, depths, radii, opacities) -> Projected:
    return Projected(means2d=center2d, depths=depths, conics=center2d.new_zeros((
        center2d.shape[0], 3)), opacities=opacities, radii=radii)


def rasterize_2dgs(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,      # linear scales
    opacities: torch.Tensor,   # [N] in [0, 1]
    colors: torch.Tensor,      # [N, C], or [N, K_sh, 3] with sh_degree
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    *,
    near: float = 0.01,
    far: float = 1e10,
    sh_degree: int | None = None,
    tile_size: int = 16,
    tile_capacity: int = 1024,
    pairs_per_gaussian: int = 8,
    render_mode: str = "RGB+ED",
    offset2d: torch.Tensor | None = None,
    tile_chunk: int = 4,
):
    """gsplat's ``rasterization_2dgs`` contract. Returns (render [H, W,
    C(+1)], alpha [H, W, 1], normals [H, W, 3], normals_from_depth [H, W,
    3], distort [H, W, 1], median_depth [H, W, 1], info). The gradient of
    ``offset2d`` (zeros, [N, 2]) is the screen-space densification signal.
    ``info["max_tile_pairs"]`` / ``tile_capacity`` is the tile fill: above
    1, a tile's farthest Gaussians were cut."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"unknown render_mode: {render_mode}")
    n = means.shape[0]
    record, center2d, depths, radii, colors = _project_and_shade(
        means, quats, scales, colors, viewmat, K, width, height, near=near, far=far,
        sh_degree=sh_degree)
    if offset2d is None:
        offset2d = means.new_zeros((n, 2))
    max_pairs = max(int(pairs_per_gaussian) * n, 1 << 12)
    with record_function("rasterize.2dgs_bin"):
        bins = bin_gaussians(_bin_input(center2d, depths, radii, opacities), width, height,
                             tile_size=tile_size, max_pairs=max_pairs,
                             tile_capacity=tile_capacity, near=near, far=far)
    return _composite_camera(bins, record, center2d, depths, radii, opacities, colors, offset2d,
                             K, width, height, near=near, tile_size=tile_size,
                             tile_capacity=tile_capacity, max_pairs=max_pairs,
                             render_mode=render_mode, tile_chunk=tile_chunk)


def rasterize_2dgs_batched(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,      # linear scales
    opacities: torch.Tensor,   # [N] in [0, 1]
    colors: torch.Tensor,      # [N, C], or [N, K_sh, 3] with sh_degree
    viewmats_b: torch.Tensor,  # [B, 4, 4]
    Ks_b: torch.Tensor,        # [B, 3, 3]
    width: int,
    height: int,
    *,
    near: float = 0.01,
    far: float = 1e10,
    sh_degree: int | None = None,
    tile_size: int = 16,
    tile_capacity: int = 1024,
    pairs_per_gaussian: int = 8,
    render_mode: str = "RGB+ED",
    offset2d: torch.Tensor | None = None,    # [B, N, 2] zeros-valued hook
    tile_chunk: int = 4,
):
    """A batch of cameras: each projected as ``rasterize_2dgs`` projects it,
    all binned in one pass (``bin_gaussians_batched``: one sort of all B x
    ``max_pairs`` keys), then composited camera by camera. Returns
    ``rasterize_2dgs``' seven outputs with a leading camera axis; each
    camera's are those ``rasterize_2dgs`` gives it alone. In ``info``,
    ``radii`` is [B, N], ``tile_gid`` the [B, T, K] tables, and
    ``total_pairs`` and ``max_tile_pairs`` are the batch's largest."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"unknown render_mode: {render_mode}")
    b, n = viewmats_b.shape[0], means.shape[0]
    if offset2d is None:
        offset2d = means.new_zeros((b, n, 2))
    fronts = [_project_and_shade(means, quats, scales, colors, viewmats_b[i], Ks_b[i], width,
                                 height, near=near, far=far, sh_degree=sh_degree)
              for i in range(b)]
    max_pairs = max(int(pairs_per_gaussian) * n, 1 << 12)
    with record_function("rasterize.2dgs_bin"):
        bins_b = bin_gaussians_batched(
            Projected(*(None if x[0] is None else torch.stack(x) for x in zip(*(
                _bin_input(f[1], f[2], f[3], opacities) for f in fronts)))),
            width, height, tile_size=tile_size, max_pairs=max_pairs,
            tile_capacity=tile_capacity, near=near, far=far)
    outs = []
    for i, (record, center2d, depths, radii, cols) in enumerate(fronts):
        bins = bins_b._replace(tile_gid=bins_b.tile_gid[i], total_pairs=bins_b.total_pairs[i],
                               max_tile_pairs=bins_b.max_tile_pairs[i])
        outs.append(_composite_camera(
            bins, record, center2d, depths, radii, opacities, cols, offset2d[i], Ks_b[i], width,
            height, near=near, tile_size=tile_size, tile_capacity=tile_capacity,
            max_pairs=max_pairs, render_mode=render_mode, tile_chunk=tile_chunk))
    infos = [o[-1] for o in outs]
    info = {k: torch.stack([x[k] for x in infos])
            for k in ("means2d", "center2d", "radii", "depths")}
    info.update(total_pairs=bins_b.total_pairs.max(), max_pairs=max_pairs,
                max_tile_pairs=bins_b.max_tile_pairs.max(), tile_capacity=tile_capacity,
                tile_gid=bins_b.tile_gid)
    return (*(torch.stack(x) for x in zip(*(o[:-1] for o in outs))), info)
