"""Triangle-mesh rasterization: triangle ids, perspective-correct
barycentrics and depth per pixel, attribute interpolation, and analytic
edge antialiasing.

Counterpart of ``geosplatting_tpu/ops/mesh_raster.py`` (``rasterize_mesh``,
``interpolate``, ``antialias``), plain PyTorch as it is plain ``jnp``
there. The math contract is the JAX package's: triangles are binned to 16 x 16 tiles by
their screen bounding box within a pairs budget of max(16 F, 4096), sorted
by their nearest depth inside a tile and cut to ``tile_capacity`` per tile;
each pixel centre is tested against every kept triangle of its tile with
edge functions that accept both windings (|det| > 1e-12), and the inside
triangle of least perspective-correct depth wins (-1 for background).

What differs is the schedule. The JAX package resolves 8 tiles at a time;
here every tile holding a triangle is resolved, in batches sized to about
1 GB of [tiles, triangles, pixels] intermediates, and only up to the
fullest tile's count of triangles. The winner search is gradient-free (the
JAX package stops the gradient at the winner); the winner's barycentrics
and depth are then recomputed per pixel with the same expressions, so
gradients reach the vertices through them when autograd records. Past the
budgets the JAX package drops pairs and triangles without a word; this one
drops the same ones and reports the counts (``MeshRasterInfo``) so the
caller can gate on the fills.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..graphics.cameras import Cameras
from ..graphics.mesh import TriangleMesh
from .segment_rows import gather_rows

# about 1 GB of [tiles, triangles, pixels] float32 intermediates a batch,
# counting the 8 that the winner search holds at once
_BATCH_BYTES = 1 << 30
_LIVE_INTERMEDIATES = 8


class RasterOut(NamedTuple):
    tri_id: torch.Tensor   # [H, W] int64, -1 = background
    bary: torch.Tensor     # [H, W, 2] perspective-correct (u, v); w = 1 - u - v
    depth: torch.Tensor    # [H, W] camera-space z (0 at background)


class MeshRasterInfo(NamedTuple):
    """Budget observables: fills above 1 mean dropped triangles."""

    max_tile_triangles: int   # largest number of triangles binned to one tile
    tile_capacity: int
    total_pairs: int          # (triangle, tile) pairs before the budget
    max_pairs: int

    @property
    def tile_fill(self) -> float:
        return self.max_tile_triangles / self.tile_capacity

    @property
    def pair_fill(self) -> float:
        return self.total_pairs / self.max_pairs


def _project_vertices(mesh: TriangleMesh, camera: Cameras):
    vm = camera.view_matrix
    v_cam = mesh.vertices @ vm[:3, :3].T + vm[:3, 3]
    z = v_cam[:, 2]
    k = camera.intrinsic_matrix
    rz = 1.0 / torch.clamp(z, min=1e-8)
    px = k[0, 0] * v_cam[:, 0] * rz + k[0, 2]
    py = k[1, 1] * v_cam[:, 1] * rz + k[1, 2]
    return torch.stack((px, py), -1), z


def _edge(q0x, q0y, q1x, q1y, px, py):
    return (q1x - q0x) * (py - q0y) - (q1y - q0y) * (px - q0x)


def _barycentrics(a, b, c, za, zb, zc, px, py):
    """Edge weights normalised by their sum, the inside test and the
    perspective-correct depth at pixel centres (px, py), broadcast."""
    w0 = _edge(b[..., 0], b[..., 1], c[..., 0], c[..., 1], px, py)   # weight of vertex a
    w1 = _edge(c[..., 0], c[..., 1], a[..., 0], a[..., 1], px, py)   # of b
    w2 = _edge(a[..., 0], a[..., 1], b[..., 0], b[..., 1], px, py)   # of c
    det = w0 + w1 + w2
    nondegenerate = det.abs() > 1e-12
    inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))
              ) & nondegenerate
    det_safe = torch.where(nondegenerate, det, 1.0)
    l0, l1, l2 = w0 / det_safe, w1 / det_safe, w2 / det_safe
    inv_z = (l0 / torch.clamp(za, min=1e-8) + l1 / torch.clamp(zb, min=1e-8)
             + l2 / torch.clamp(zc, min=1e-8))
    return l0, l1, inside, 1.0 / torch.clamp(inv_z, min=1e-12)


def rasterize_mesh(
    mesh: TriangleMesh,
    camera: Cameras,                 # one camera
    *,
    tile_size: int = 16,
    tile_capacity: int = 256,
    pairs_per_triangle: int = 16,
    cull_backface: bool = False,
) -> tuple[RasterOut, MeshRasterInfo]:
    width, height = camera.width, camera.height
    xy, z = _project_vertices(mesh, camera)
    faces = mesh.indices
    f = faces.shape[0]
    dev = xy.device
    tw = -(-width // tile_size)
    th = -(-height // tile_size)
    num_tiles = tw * th
    max_pairs = max(int(pairs_per_triangle) * f, 1 << 12)

    with torch.no_grad():
        p = gather_rows(xy.detach(), faces)          # [F, 3, 2]
        zf = gather_rows(z.detach(), faces)          # [F, 3]
        p0, p1, p2 = p.unbind(1)
        valid = mesh.face_mask_or_ones() & (zf > camera.near).all(-1)
        area2 = ((p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1])
                 - (p1[:, 1] - p0[:, 1]) * (p2[:, 0] - p0[:, 0]))
        if cull_backface:
            valid = valid & (area2 < 0)   # +z-forward, y-down: CCW world faces wind negative
        valid = valid & (area2.abs() > 1e-12)

        # --- bin triangles by bbox, nearest depth first within a tile -------
        lo, hi = p.amin(1), p.amax(1)
        tx0 = torch.clamp(torch.floor(lo[:, 0] / tile_size), 0, tw).long()
        ty0 = torch.clamp(torch.floor(lo[:, 1] / tile_size), 0, th).long()
        tx1 = torch.clamp(torch.ceil(hi[:, 0] / tile_size), 0, tw).long()
        ty1 = torch.clamp(torch.ceil(hi[:, 1] / tile_size), 0, th).long()
        bw = torch.clamp(tx1 - tx0, min=0)
        bh = torch.clamp(ty1 - ty0, min=0)
        ntiles = torch.where(valid, bw * bh, 0)
        offsets = torch.cumsum(ntiles, 0)
        total = int(offsets[-1]) if f else 0
        n_slots = min(total, max_pairs)   # the budget keeps the first slots
        slot = torch.arange(n_slots, device=dev)
        fid = torch.searchsorted(offsets, slot, right=True)
        local = slot - (offsets - ntiles)[fid]
        w_g = torch.clamp(bw[fid], min=1)
        tile = (ty0[fid] + local // w_g) * tw + (tx0[fid] + local % w_g)
        depth_bits = zf.amin(1).view(torch.int32).long()[fid]
        order = torch.sort(tile * (1 << 32) + depth_bits, stable=True).indices
        s_tile, s_fid = tile[order], fid[order]
        counts = torch.bincount(s_tile, minlength=num_tiles)
        seg_start = torch.cumsum(counts, 0) - counts
        max_count = int(counts.max()) if n_slots else 0
        # only the tiles holding a triangle, and only as deep as the fullest
        k = min(tile_capacity, max_count)
        busy = torch.nonzero(counts > 0)[:, 0]

        tri_tiles = torch.full((num_tiles, tile_size * tile_size), -1, dtype=torch.long,
                               device=dev)
        if k > 0:
            r = torch.arange(tile_size, device=dev, dtype=torch.float32) + 0.5
            pyg, pxg = torch.meshgrid(r, r, indexing="ij")
            px_local, py_local = pxg.reshape(-1), pyg.reshape(-1)
            kk = torch.arange(k, device=dev)
            pixels = tile_size * tile_size
            batch = max(1, _BATCH_BYTES // (_LIVE_INTERMEDIATES * 4 * k * pixels))
            for b0 in range(0, busy.shape[0], batch):
                tiles_b = busy[b0:b0 + batch]
                idx = seg_start[tiles_b, None] + kk
                live = kk < counts[tiles_b, None]
                fids = torch.where(live, s_fid[idx.clamp(max=max(n_slots - 1, 0))], 0)
                pix_x = ((tiles_b % tw) * tile_size).float()[:, None, None] + px_local
                pix_y = ((tiles_b // tw) * tile_size).float()[:, None, None] + py_local
                corners = p[fids][:, :, None]             # [b, k, 1, 3, 2]
                zc = zf[fids][:, :, None]                 # [b, k, 1, 3]
                _, _, inside, zpix = _barycentrics(
                    corners[..., 0, :], corners[..., 1, :], corners[..., 2, :],
                    zc[..., 0], zc[..., 1], zc[..., 2], pix_x, pix_y)
                inside &= live[..., None]
                best = torch.argmin(torch.where(inside, zpix, torch.inf), dim=1)   # [b, P]
                hit = inside.gather(1, best[:, None])[:, 0]
                tri_tiles[tiles_b] = torch.where(hit, fids.gather(1, best), -1)

        tri_id = tri_tiles.reshape(th, tw, tile_size, tile_size).permute(0, 2, 1, 3)
        tri_id = tri_id.reshape(th * tile_size, tw * tile_size)[:height, :width]

    # the winner's barycentrics and depth, per pixel, differentiable in xy / z
    hit = tri_id >= 0
    fv = faces[tri_id.clamp(min=0)]                        # [H, W, 3]
    a, b, c = (gather_rows(xy, fv[..., i]) for i in range(3))
    za, zb, zc = (gather_rows(z, fv[..., i]) for i in range(3))
    ys = torch.arange(height, device=dev, dtype=torch.float32)[:, None] + 0.5
    xs = torch.arange(width, device=dev, dtype=torch.float32)[None, :] + 0.5
    l0, l1, _, zpix = _barycentrics(a, b, c, za, zb, zc, xs, ys)
    d0 = l0 / torch.clamp(za, min=1e-8)
    d1 = l1 / torch.clamp(zb, min=1e-8)
    d2 = (1.0 - l0 - l1) / torch.clamp(zc, min=1e-8)
    denom = torch.clamp(d0 + d1 + d2, min=1e-12)
    bary = torch.stack((d0 / denom, d1 / denom), -1)
    out = RasterOut(
        tri_id=tri_id,
        bary=torch.where(hit[..., None], bary, 0.0),
        depth=torch.where(hit, zpix, 0.0),
    )
    info = MeshRasterInfo(max_tile_triangles=max_count, tile_capacity=tile_capacity,
                          total_pairs=total, max_pairs=max_pairs)
    return out, info


def interpolate(attrs: torch.Tensor, mesh: TriangleMesh, out: RasterOut) -> torch.Tensor:
    """Per-pixel attribute interpolation: attrs [V, C] -> [H, W, C], 0 at
    background."""
    fv = mesh.indices[out.tri_id.clamp(min=0)]             # [H, W, 3]
    a0, a1, a2 = (gather_rows(attrs, fv[..., i]) for i in range(3))
    u = out.bary[..., 0:1]
    v = out.bary[..., 1:2]
    val = a0 * u + a1 * v + a2 * (1.0 - u - v)
    return torch.where((out.tri_id >= 0)[..., None], val, 0.0)


def antialias(color: torch.Tensor, mesh: TriangleMesh, camera: Cameras,
              rast: RasterOut) -> torch.Tensor:
    """Analytic edge antialiasing, the ``dr.antialias`` analog: [H, W, C].

    At every horizontally or vertically adjacent pixel pair whose triangle
    ids differ, the nearer triangle's screen-space edge that crosses the
    segment between the two pixel centres nearest its midpoint moves colour
    across by the crossing position (the JAX package's rule: each pass
    blends only the edges steeper along its fixed axis, and a pair no edge
    crosses is left as it is). The blend weight is differentiable in the
    projected vertex positions, so coverage has a gradient."""
    xy, _ = _project_vertices(mesh, camera)
    h, w = rast.tri_id.shape
    tri = rast.tri_id
    dev = color.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
                            indexing="ij")

    def edge_blend(axis: int, img: torch.Tensor) -> torch.Tensor:
        # the pixel pair (p, q) = (i, i + 1) along `axis`
        sl_p = (slice(None), slice(0, -1)) if axis == 1 else (slice(0, -1),)
        sl_q = (slice(None), slice(1, None)) if axis == 1 else (slice(1, None),)
        t_p, t_q = tri[sl_p], tri[sl_q]
        boundary = t_p != t_q
        # the nearer triangle owns the edge (the background counts as far)
        dp = torch.where(t_p >= 0, rast.depth[sl_p], torch.inf)
        dq = torch.where(t_q >= 0, rast.depth[sl_q], torch.inf)
        own = torch.where(dp <= dq, t_p, t_q).clamp(min=0)
        fv = mesh.indices[own]
        v0, v1, v2 = xy[fv[..., 0]], xy[fv[..., 1]], xy[fv[..., 2]]
        coord = 0 if axis == 1 else 1        # the moving coordinate
        fixed = 1 - coord
        pf = ys[sl_p] if axis == 1 else xs[sl_p]
        pm = xs[sl_p] if axis == 1 else ys[sl_p]

        def crossing(a, b):
            # edge a -> b crossing the line fixed-coord == pf; only edges
            # steeper along the fixed axis blend in this pass
            af, bf = a[..., fixed], b[..., fixed]
            am, bm = a[..., coord], b[..., coord]
            denom = bf - af
            steep = denom.abs() >= (bm - am).abs()
            s = (pf - af) / torch.where(denom.abs() > 1e-8, denom, 1e-8)
            hits = (s >= 0.0) & (s <= 1.0) & (denom.abs() > 1e-8) & steep
            t = am + s * (bm - am) - pm       # 0 at p's centre, 1 at q's
            return torch.where(hits & (t >= 0.0) & (t <= 1.0), t, torch.nan)

        ts = torch.stack((crossing(v0, v1), crossing(v1, v2), crossing(v2, v0)))
        # the crossing closest to the pair's midpoint wins
        score = torch.where(torch.isnan(ts), torch.inf, (ts - 0.5).abs())
        t_edge = ts.gather(0, score.argmin(0)[None])[0]
        has_edge = boundary & torch.isfinite(t_edge)
        t_edge = torch.where(has_edge, t_edge, 0.5)
        # the pixel whose half-segment the edge crosses mixes in the
        # neighbour's colour by the encroached fraction, in [-0.5, 0.5]
        c_p, c_q = img[sl_p], img[sl_q]
        w_pq = torch.clamp(0.5 - t_edge, -0.5, 0.5)[..., None]
        blend_p = torch.where(has_edge[..., None] & (w_pq > 0), w_pq * (c_q - c_p), 0.0)
        blend_q = torch.where(has_edge[..., None] & (w_pq < 0), -w_pq * (c_p - c_q), 0.0)
        pad_p = (0, 0, 0, 1) if axis == 1 else (0, 0, 0, 0, 0, 1)
        pad_q = (0, 0, 1, 0) if axis == 1 else (0, 0, 0, 0, 1, 0)
        return (img + torch.nn.functional.pad(blend_p, pad_p)
                + torch.nn.functional.pad(blend_q, pad_q))

    return edge_blend(0, edge_blend(1, color))
