"""Tile-binned differentiable Gaussian rasterization.

Counterpart of ``geosplatting_tpu/ops/rasterize.py``: ``rasterize`` and
``rasterize_projected`` with the render modes ``RGB``, ``ED``, ``D``,
``RGB+ED`` and ``RGB+D`` (``D`` is the accumulated depth, ``ED`` = D /
max(alpha, 1e-10)), ``_tiles_to_image``, the compositing constants and the
SH colours of ``sh_degree``; and the dense tile table of the JAX package's
reference rasterizer: ``TileBins``, ``bin_gaussians``, ``_tile_pixel_grid``
and ``composite_tiles_reference``, with ``bin_gaussians_batched`` (a batch of
cameras' tables in one sort, each the table ``bin_gaussians`` gives it).

The camera-batched front end is ``bin_cameras_batched`` (every camera
projected, then all binned in one pass by ``bin_pairs_batched``),
``composite_from_bins`` (one camera's K1-K3 composite from its bins) and
``rasterize_batched`` (the two, camera by camera). Each camera's pairs and
image are those ``rasterize`` gives it alone. The JAX ``kc`` /
``chunk_size`` is not taken: the port's chunk is ``CHUNK_PAIRS``.

The render path is the pairs path on both devices (the kernels on the card,
their plain versions on the CPU). The dense tile table serves the 2DGS
rasterizer (``ops/rasterize_2dgs.py``); ``composite_tiles_reference`` is the
JAX package's dense CPU oracle, kept as an independent check of the depth
modes and called by no render path.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..graphics import gmath
from ..graphics.cameras import Cameras
from .projection import Projected, project
from .rasterize_pairs import (  # noqa: F401  (constants re-exported as in the JAX package)
    MAX_ALPHA, MIN_ALPHA, TRANSMITTANCE_EPS, PairBins, bin_pairs, bin_pairs_batched,
    camera_slice, composite_pairs, tile_grid,
)

RENDER_MODES = ("RGB", "ED", "D", "RGB+ED", "RGB+D")


class TileBins(NamedTuple):
    tile_gid: torch.Tensor        # [T, K_cap] int64 gaussian index per slot, -1 = empty
    total_pairs: torch.Tensor     # [] actual pair count (overflow check)
    num_tiles_xy: tuple[int, int]
    max_tile_pairs: torch.Tensor  # [] the fullest tile's pairs before truncation to K_cap


def _gaussian_rects(proj: Projected, tw: int, th: int, tile_size: int):
    """One camera's per-Gaussian tile rectangles: (tx0, ty0, width in
    tiles, tile count; 0 tiles where culled)."""
    means2d = proj.means2d.detach()
    if proj.extents is not None:
        rx = proj.extents[:, 0].detach()
        ry = proj.extents[:, 1].detach()
    else:
        rx = ry = proj.radii.to(torch.float32)
    tx0 = torch.floor((means2d[:, 0] - rx) / tile_size).clamp(0, tw).long()
    ty0 = torch.floor((means2d[:, 1] - ry) / tile_size).clamp(0, th).long()
    tx1 = torch.ceil((means2d[:, 0] + rx) / tile_size).clamp(0, tw).long()
    ty1 = torch.ceil((means2d[:, 1] + ry) / tile_size).clamp(0, th).long()
    bw = (tx1 - tx0).clamp(min=0)
    bh = (ty1 - ty0).clamp(min=0)
    return tx0, ty0, bw, torch.where(proj.radii > 0, bw * bh, 0)


def bin_gaussians_batched(
    proj_b: Projected,
    width: int,
    height: int,
    *,
    tile_size: int,
    max_pairs: int,
    tile_capacity: int,
    near: float = 0.01,
    far: float = 1e10,
) -> TileBins:
    """B cameras' dense [T, K_cap] tile tables (every field of ``proj_b``
    with a leading camera axis) in one pass: the pair expansion, one stable
    sort of all B x ``max_pairs`` keys and the tile search run once for the
    batch. The camera index sits above each camera's key, and every float
    of a camera (its tile rectangles, its quantized depths) is computed from
    that camera alone with ``bin_gaussians``' shapes, so each camera's table
    is the one ``bin_gaussians`` gives it alone. Returns a ``TileBins``
    whose ``tile_gid``, ``total_pairs`` and ``max_tile_pairs`` lead with the
    camera axis."""
    tw = -(-width // tile_size)
    th = -(-height // tile_size)
    num_tiles = tw * th
    b, n = proj_b.means2d.shape[:2]
    dev = proj_b.means2d.device
    rects = [_gaussian_rects(camera_slice(proj_b, i), tw, th, tile_size) for i in range(b)]
    tx0, ty0, bw, ntiles = (torch.stack(x) for x in zip(*rects))

    offsets = torch.cumsum(ntiles, 1)                 # inclusive
    total = offsets[:, -1]
    starts = offsets - ntiles
    slot = torch.arange(max_pairs, device=dev).expand(b, max_pairs)
    gid = torch.searchsorted(offsets, slot.contiguous(), right=True).clamp(max=n - 1)
    local = slot - starts.gather(1, gid)
    w_g = bw.gather(1, gid).clamp(min=1)
    tile_id = (ty0.gather(1, gid) + local // w_g) * tw + tx0.gather(1, gid) + local % w_g
    in_range = slot < torch.clamp(total, max=max_pairs)[:, None]
    tile_id = torch.where(in_range, tile_id, num_tiles)   # sentinel bucket

    cam = torch.arange(b, device=dev)[:, None]
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    depth_bits = 31 - tile_bits
    if depth_bits >= 16:
        # one packed key: camera-constant log-depth quantization, the
        # camera above it
        log_span = float(math.log(max(far / near, 1.0 + 1e-6)))
        dq = torch.stack([torch.clamp(
            (torch.log(torch.clamp(proj_b.depths[i].detach()[gid[i]] / near, min=1e-6))
             / log_span * ((1 << depth_bits) - 1)).to(torch.int32),
            0, (1 << depth_bits) - 1,
        ).long() for i in range(b)])
        packed = ((cam << (tile_bits + depth_bits)) + tile_id * (1 << depth_bits)
                  + torch.where(in_range, dq, 0))
        sorted_key, perm = torch.sort(packed.reshape(-1), stable=True)
        sorted_tile = (sorted_key.view(b, max_pairs) >> depth_bits) - (cam << tile_bits)
    else:
        # (camera, tile, float depth bits) lexicographically: minor key
        # first, stable
        depth_key = torch.where(
            in_range, proj_b.depths.detach().view(torch.int32).gather(1, gid).long(),
            torch.iinfo(torch.int32).max)
        by_depth = torch.argsort(depth_key.reshape(-1), stable=True)
        major = (tile_id + cam * (num_tiles + 1)).reshape(-1)
        perm = by_depth[torch.argsort(major[by_depth], stable=True)]
        sorted_tile = tile_id.reshape(-1)[perm].view(b, max_pairs)
    # camera c's keys are the c-th block of max_pairs in sorted order
    sorted_gid = gid.reshape(-1)[perm].view(b, max_pairs)

    tile_range = torch.arange(num_tiles, device=dev).expand(b, num_tiles).contiguous()
    seg_start = torch.searchsorted(sorted_tile, tile_range)
    counts = torch.searchsorted(sorted_tile, tile_range, right=True) - seg_start
    k = torch.arange(tile_capacity, device=dev)
    idx = (seg_start[:, :, None] + k).clamp(0, max_pairs - 1)
    tile_gid = torch.where(k < counts[:, :, None],
                           sorted_gid.gather(1, idx.view(b, -1)).view(idx.shape), -1)
    return TileBins(tile_gid=tile_gid, total_pairs=total, num_tiles_xy=(tw, th),
                    max_tile_pairs=counts.amax(1))


def bin_gaussians(
    proj: Projected,
    width: int,
    height: int,
    *,
    tile_size: int,
    max_pairs: int,
    tile_capacity: int,
    near: float = 0.01,
    far: float = 1e10,
) -> TileBins:
    """Dense [T, K_cap] tile table of depth-sorted Gaussian ids. Each valid
    Gaussian covers the tiles of its per-axis ``extents`` rectangle, or of
    its circular ``radii`` rectangle where ``proj.extents`` is None (2DGS).
    Pairs are generated in Gaussian order inside the static ``max_pairs``
    budget, sorted by a packed (tile, log-depth) key and cut to the front
    ``tile_capacity`` of each tile. ``bin_gaussians_batched`` of a batch of
    one."""
    bins = bin_gaussians_batched(
        Projected(*(None if x is None else x[None] for x in proj)), width, height,
        tile_size=tile_size, max_pairs=max_pairs, tile_capacity=tile_capacity, near=near,
        far=far)
    return bins._replace(tile_gid=bins.tile_gid[0], total_pairs=bins.total_pairs[0],
                         max_tile_pairs=bins.max_tile_pairs[0])


def _tile_pixel_grid(tile_size: int, device=None) -> torch.Tensor:
    """[P, 2] pixel centres of a tile, row-major from its origin."""
    r = torch.arange(tile_size, dtype=torch.float32, device=device) + 0.5
    py, px = torch.meshgrid(r, r, indexing="ij")
    return torch.stack((px.reshape(-1), py.reshape(-1)), -1)


def tile_origins(tw: int, th: int, tile_size: int, device=None) -> torch.Tensor:
    """[T, 2] float pixel origin of each tile, row-major."""
    ty, tx = torch.meshgrid(torch.arange(th, device=device), torch.arange(tw, device=device),
                            indexing="ij")
    return torch.stack((tx.reshape(-1) * tile_size, ty.reshape(-1) * tile_size),
                       -1).to(torch.float32)


def composite_tiles_reference(
    tile_gid: torch.Tensor,     # [T, K]
    tile_origin: torch.Tensor,  # [T, 2] float pixel origin of each tile
    means2d: torch.Tensor,      # [N, 2]
    conics: torch.Tensor,       # [N, 3]
    opacities: torch.Tensor,    # [N]
    colors: torch.Tensor,       # [N, C]
    depths: torch.Tensor,       # [N]
    *,
    tile_size: int,
    tile_chunk: int = 8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Front-to-back composite of each tile's [K, P] (Gaussian, pixel)
    alphas at once, in checkpointed chunks of ``tile_chunk`` tiles. Returns
    (color [T, P, C], alpha [T, P], depth_accum [T, P]), P = tile_size**2."""
    pix_local = _tile_pixel_grid(tile_size, tile_gid.device)

    def chunk_fn(gid, origin, means2d, conics, opacities, colors, depths):
        safe = gid.clamp(min=0)
        live = gid >= 0
        mu, con, op = means2d[safe], conics[safe], opacities[safe]
        pix = origin[:, None, :] + pix_local[None]                  # [Ct, P, 2]
        dx = mu[:, :, None, 0] - pix[:, None, :, 0]                 # [Ct, K, P]
        dy = mu[:, :, None, 1] - pix[:, None, :, 1]
        sigma = (0.5 * (con[:, :, None, 0] * dx * dx + con[:, :, None, 2] * dy * dy)
                 + con[:, :, None, 1] * dx * dy)
        alpha = torch.clamp(op[:, :, None] * torch.exp(-sigma), max=MAX_ALPHA)
        alpha = torch.where((sigma >= 0) & (alpha >= MIN_ALPHA) & live[:, :, None], alpha, 0.0)
        log_t = torch.cumsum(torch.log1p(-alpha), 1)                # inclusive
        t_excl = torch.exp(log_t - torch.log1p(-alpha))             # exclusive
        weight = torch.where(t_excl > TRANSMITTANCE_EPS, alpha * t_excl, 0.0)
        out_c = torch.einsum("tkp,tkc->tpc", weight, colors[safe])
        return out_c, weight.sum(1), torch.einsum("tkp,tk->tp", weight, depths[safe])

    outs = [
        checkpoint(chunk_fn, tile_gid[c0:c0 + tile_chunk], tile_origin[c0:c0 + tile_chunk],
                   means2d, conics, opacities, colors, depths, use_reentrant=False)
        for c0 in range(0, tile_gid.shape[0], tile_chunk)
    ]
    return tuple(torch.cat(o) for o in zip(*outs))


def _tiles_to_image(tiles: torch.Tensor, grid, height: int, width: int) -> torch.Tensor:
    """[T, P, C] per-tile pixels -> [H, W, C] image."""
    tw, th, tsx, tsy = grid
    c = tiles.shape[-1]
    img = tiles.reshape(th, tw, tsy, tsx, c).permute(0, 2, 1, 3, 4)
    return img.reshape(th * tsy, tw * tsx, c)[:height, :width]


def rasterize_projected(
    proj: Projected,
    colors: torch.Tensor,
    width: int,
    height: int,
    *,
    near: float = 0.01,
    far: float = 1e10,
    tile_size=16,
    pairs_per_gaussian: int = 8,
    render_mode: str = "RGB",
    max_pairs_override: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Binning + compositing of an already-projected Gaussian set. Returns
    (render, alpha [H, W, 1], info); the render is the colours [H, W, C]
    (``RGB``), the depth [H, W, 1] (``ED``, ``D``) or both [H, W, C + 1]."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"unknown render_mode: {render_mode}")
    max_pairs = _pair_budget(proj.means2d.shape[0], pairs_per_gaussian, max_pairs_override)

    grid = tile_grid(width, height, tile_size)
    with record_function("rasterize.bin_pairs"):
        bins = bin_pairs(proj, width, height, tile_size=(grid.tsx, grid.tsy),
                         max_pairs=max_pairs, near=near, far=far)
    with record_function("rasterize.composite"):
        tiles_c, tiles_a, tiles_d = composite_pairs(
            bins, grid, proj.means2d, proj.conics, proj.opacities, colors, proj.depths
        )
    render = _tiles_to_image(tiles_c, grid, height, width)
    img_a = _tiles_to_image(tiles_a[..., None], grid, height, width)
    if render_mode != "RGB":
        # K1's depth column; its gradient goes back through K2's depth row
        depth = _tiles_to_image(tiles_d[..., None], grid, height, width)
        if render_mode in ("ED", "RGB+ED"):
            depth = depth / torch.clamp(img_a, min=1e-10)
        render = depth if render_mode in ("ED", "D") else torch.cat((render, depth), -1)
    info = {
        "means2d": proj.means2d,
        "radii": proj.radii,
        "depths": proj.depths,
        "total_pairs": bins.total_pairs,
        "max_pairs": max_pairs,
    }
    return render, img_a, info


def _pair_budget(n: int, pairs_per_gaussian: int, max_pairs_override: int | None) -> int:
    # every binning/pack/kernel buffer scales with this static budget
    max_pairs = max(int(pairs_per_gaussian) * n, 1 << 12)
    if max_pairs_override is not None:
        max_pairs = max(min(max_pairs, int(max_pairs_override)), 1 << 12)
    return max_pairs


def sh_colors(sh_degree: int, means: torch.Tensor, colors: torch.Tensor,
              viewmat: torch.Tensor) -> torch.Tensor:
    """SH coefficients [N, K_sh, 3] evaluated towards the camera of
    ``viewmat`` as max(SH + 0.5, 0): [N, 3]."""
    campos = -viewmat[:3, :3].T @ viewmat[:3, 3]
    viewdir = gmath.safe_normalize(means - campos)
    return torch.clamp(gmath.eval_sh(sh_degree, colors, viewdir) + 0.5, min=0.0)


def rasterize(
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
    tile_size=16,
    pairs_per_gaussian: int = 8,
    rasterize_mode: str = "classic",
    render_mode: str = "RGB",
    radius_clip: float = 0.0,
    means2d_offset: torch.Tensor | None = None,
    max_pairs_override: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Render one camera. Returns (render, alpha [H, W, 1], info); the
    render is [H, W, C], [H, W, 1] or [H, W, C + 1] by ``render_mode``.
    ``means2d_offset`` is a zeros-valued [N, 2] hook whose gradient
    is the screen-space position gradient densification reads. With
    ``sh_degree`` the colours are SH coefficients, evaluated towards the
    camera as max(SH + 0.5, 0) before compositing (C = 3)."""
    proj = project(
        means, quats, scales, opacities, viewmat, K, width, height,
        near=near, far=far, rasterize_mode=rasterize_mode, radius_clip=radius_clip,
    )
    if means2d_offset is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_offset)
    if sh_degree is not None:
        colors = sh_colors(sh_degree, means, colors, viewmat)
    return rasterize_projected(
        proj, colors, width, height, near=near, far=far, tile_size=tile_size,
        pairs_per_gaussian=pairs_per_gaussian, render_mode=render_mode,
        max_pairs_override=max_pairs_override,
    )


# --- the camera-batched front end -------------------------------------------------


def camera_matrices(cameras: Cameras) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, 4, 4] view and [B, 3, 3] intrinsic matrices, each computed from
    its camera alone (as the per-camera path computes them), so the batched
    path projects with the same bits."""
    cams = [cameras[i] for i in range(len(cameras))]
    return (torch.stack([c.view_matrix for c in cams]),
            torch.stack([c.intrinsic_matrix for c in cams]))


def bin_cameras_batched(
    means: torch.Tensor,
    quats: torch.Tensor,         # normalized
    scales: torch.Tensor,        # linear scales
    opacities_b: torch.Tensor,   # [B, N] (per camera: culling may zero some)
    viewmats_b: torch.Tensor,    # [B, 4, 4]
    Ks_b: torch.Tensor,          # [B, 3, 3]
    width: int,
    height: int,
    *,
    near: float = 0.01,
    far: float = 1e10,
    rasterize_mode: str = "antialiased",
    tile_size=16,
    pairs_per_gaussian: int = 8,
    max_pairs_override: int | None = None,
    means2d_offset: torch.Tensor | None = None,   # [B, N, 2] zeros-valued hook
) -> tuple[Projected, PairBins, int]:
    """Projection of every camera, then one binning pass for the batch
    (``bin_pairs_batched``: one sort of all B x ``max_pairs`` keys). Each
    camera is projected by ``project`` as ``rasterize`` projects it, so its
    floats, and so its pairs, are the per-camera path's bit for bit.
    Returns (proj_b, bins_b, max_pairs), each field of the first two with
    a leading camera axis; feed camera i's to ``composite_from_bins``.
    Gradients reach the Gaussians through each camera's projection."""
    projs = []
    for i in range(viewmats_b.shape[0]):
        proj = project(means, quats, scales, opacities_b[i], viewmats_b[i], Ks_b[i], width,
                       height, near=near, far=far, rasterize_mode=rasterize_mode)
        if means2d_offset is not None:
            proj = proj._replace(means2d=proj.means2d + means2d_offset[i])
        projs.append(proj)
    proj_b = Projected(*(torch.stack(x) for x in zip(*projs)))
    max_pairs = _pair_budget(means.shape[0], pairs_per_gaussian, max_pairs_override)
    with record_function("rasterize.bin_pairs"):
        bins_b = bin_pairs_batched(proj_b, width, height, tile_size=tile_size,
                                   max_pairs=max_pairs, near=near, far=far)
    return proj_b, bins_b, max_pairs


def composite_from_bins(
    proj: Projected,
    bins: PairBins,
    colors: torch.Tensor,        # [N, C]
    *,
    max_pairs: int,
    width: int,
    height: int,
    tile_size=16,
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """One camera's composite (K1, and K2 and K3 in the backward) from its
    precomputed (proj, bins). Returns (render [H, W, C], alpha [H, W, 1],
    {total_pairs, max_pairs})."""
    grid = tile_grid(width, height, tile_size)
    with record_function("rasterize.composite"):
        tiles_c, tiles_a, _ = composite_pairs(
            bins, grid, proj.means2d, proj.conics, proj.opacities, colors, proj.depths
        )
    img_c = _tiles_to_image(tiles_c, grid, height, width)
    img_a = _tiles_to_image(tiles_a[..., None], grid, height, width)
    return img_c, img_a, {"total_pairs": bins.total_pairs, "max_pairs": max_pairs}


def rasterize_batched(
    means: torch.Tensor,
    quats: torch.Tensor,         # normalized
    scales: torch.Tensor,        # linear scales
    opacities_b: torch.Tensor,   # [B, N] (per camera: culling may zero some)
    colors_b: torch.Tensor,      # [B, N, C] per-camera shaded colours
    viewmats_b: torch.Tensor,    # [B, 4, 4]
    Ks_b: torch.Tensor,          # [B, 3, 3]
    width: int,
    height: int,
    *,
    near: float = 0.01,
    far: float = 1e10,
    rasterize_mode: str = "antialiased",
    tile_size=16,
    pairs_per_gaussian: int = 8,
    max_pairs_override: int | None = None,
    means2d_offset: torch.Tensor | None = None,   # [B, N, 2] zeros-valued hook
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Camera-batched rasterization on the pairs path: ``bin_cameras_batched``,
    then ``composite_from_bins`` camera by camera. Returns (render [B, H,
    W, C], alpha [B, H, W, 1], info): ``total_pairs`` the batch's largest,
    ``max_pairs``, and each camera's ``radii`` [B, N] (densification's
    visibility)."""
    proj_b, bins_b, max_pairs = bin_cameras_batched(
        means, quats, scales, opacities_b, viewmats_b, Ks_b, width, height, near=near,
        far=far, rasterize_mode=rasterize_mode, tile_size=tile_size,
        pairs_per_gaussian=pairs_per_gaussian, max_pairs_override=max_pairs_override,
        means2d_offset=means2d_offset,
    )
    renders, alphas = [], []
    for i in range(viewmats_b.shape[0]):
        img_c, img_a, _ = composite_from_bins(
            camera_slice(proj_b, i), camera_slice(bins_b, i), colors_b[i],
            max_pairs=max_pairs, width=width, height=height, tile_size=tile_size,
        )
        renders.append(img_c)
        alphas.append(img_a)
    info = {"total_pairs": bins_b.total_pairs.max(), "max_pairs": max_pairs,
            "radii": proj_b.radii}
    return torch.stack(renders), torch.stack(alphas), info
