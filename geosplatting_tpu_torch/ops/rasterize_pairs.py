"""Pair-centric tile rasterization: binning and the compositing kernels.

Counterpart of ``geosplatting_tpu/ops/rasterize_pairs.py``.

1. ``bin_pairs`` expands every Gaussian to its covered (tile, depth) pairs
   inside a static ``max_pairs`` budget, with the JAX package's depth-
   priority overflow drop, exact circle prune and packed ``tile | log-depth``
   sort key, so pair sets, ``total_pairs`` and ``pair_fill`` mean the same.
   Each tile's pairs are one contiguous range ``[seg_start[t],
   seg_start[t+1])`` of the sorted pair array (the TPU's chunk list and its
   SMEM bit-packing are not needed). ``bin_pairs_batched`` bins a batch of
   cameras in one pass (one sort of every camera's keys, the camera index
   above them), each camera's pairs exactly those ``bin_pairs`` gives it.
2. ``chunk_list`` cuts every tile's range into chunks of at most
   ``CHUNK_PAIRS`` pairs (an empty tile is one chunk of none) inside the
   static budget ``num_tiles + ceil(max_pairs / kc)`` slots, on the device.
3. ``composite_pairs`` is an autograd Function over kernel K1 (forward:
   ``chunk_products`` then ``composite_fwd``, ``csrc/rasterize_fwd.cu``) and
   K2 (backward: ``chunk_suffix`` then ``composite_bwd``,
   ``csrc/rasterize_bwd.cu``), whose passes run every chunk of a tile in
   parallel. The backward writes one gradient row per sorted pair; the rows
   go back to generation order and are reduced per Gaussian with
   ``contiguous_segment_sum`` (kernel K3), as in the JAX package.

Pair rows are packed with a stride of a multiple of 4 floats (``row_stride``)
so the kernels stage them in 16-byte copies. Beside each kernel pass is its
plain PyTorch version (same gate order, rank gate and clamps), which runs for
CPU tensors only; the plain compositing passes work per tile and need no
chunk state.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import _kernels
from .projection import Projected
from .segment_rows import contiguous_segment_sum

TRANSMITTANCE_EPS = 1e-4
MIN_ALPHA = 1.0 / 255.0
MAX_ALPHA = 0.999
HDR = 7            # packed pair row: mu2 | conic3 | opacity | depth | color C
MAX_CHANNELS = 16  # csrc/common.cuh kMaxChannels
CHUNK_PAIRS = 256  # pairs per chunk: the kernels' work unit


def row_stride(channels: int) -> int:
    """Floats per packed pair row: 7 + C rounded up to a multiple of 4."""
    return -(-(HDR + channels) // 4) * 4


def tile_wh(tile_size) -> tuple[int, int]:
    """Tile spec (int, "WxH" string or (w, h)) -> (tile_w, tile_h) pixels."""
    if isinstance(tile_size, str):
        parts = tile_size.split("x")
        tsx = int(parts[0])
        tsy = int(parts[1]) if len(parts) > 1 else tsx
    elif isinstance(tile_size, (tuple, list)):
        tsx, tsy = int(tile_size[0]), int(tile_size[1])
    else:
        tsx = tsy = int(tile_size)
    return tsx, tsy


class TileGrid(NamedTuple):
    tw: int
    th: int
    tsx: int
    tsy: int

    @property
    def num_tiles(self) -> int:
        return self.tw * self.th

    @property
    def pixels(self) -> int:
        return self.tsx * self.tsy


def tile_grid(width: int, height: int, tile_size) -> TileGrid:
    tsx, tsy = tile_wh(tile_size)
    return TileGrid(-(-width // tsx), -(-height // tsy), tsx, tsy)


class PairBins(NamedTuple):
    """Static-shape binning of (tile, depth)-sorted Gaussian pairs; from
    ``bin_pairs_batched`` every field has a leading camera axis
    (``camera_slice`` takes one camera's)."""

    sorted_gid: torch.Tensor          # [max_pairs] gaussian id per sorted pair (N = invalid)
    seg_start: torch.Tensor           # [T+1] first sorted pair of each tile; [T] ends the valid pairs
    sorted_row_of_slot: torch.Tensor  # [max_pairs] sorted position of each generated slot
    # per-gaussian contiguous slot runs in generation (depth-priority) order:
    # gaussian order[i]'s pairs occupy slots [gs_start[i], gs_start[i] + gs_count[i])
    gs_start: torch.Tensor            # [N]
    gs_count: torch.Tensor            # [N]
    gs_inv: torch.Tensor              # [N] original gaussian id -> run index
    total_pairs: torch.Tensor         # [] true pair count (overflow check)


def camera_slice(batch, i: int):
    """Camera ``i``'s slice of a batched ``PairBins`` or ``Projected``
    (contiguous views)."""
    return type(batch)(*(None if x is None else x[i] for x in batch))


def _gaussian_tiles(proj: Projected, grid: TileGrid, near: float, log_span: float,
                    depth_bits: int):
    """One camera's per-Gaussian binning inputs: the tile rectangle of the
    opacity-aware extents (tx0, ty0, width in tiles, tile count; 0 tiles
    when culled), the quantized log depth, and the prune circle."""
    tw, th, tsx, tsy = grid
    means2d = proj.means2d.detach()
    depths = proj.depths.detach()
    valid = proj.radii > 0
    rx = proj.extents[:, 0].detach()
    ry = proj.extents[:, 1].detach()
    tx0 = torch.floor((means2d[:, 0] - rx) / tsx).clamp(0, tw).long()
    ty0 = torch.floor((means2d[:, 1] - ry) / tsy).clamp(0, th).long()
    tx1 = torch.ceil((means2d[:, 0] + rx) / tsx).clamp(0, tw).long()
    ty1 = torch.ceil((means2d[:, 1] + ry) / tsy).clamp(0, th).long()
    bw = (tx1 - tx0).clamp(min=0)
    ntiles = torch.where(valid, bw * (ty1 - ty0).clamp(min=0), 0)
    dq = (
        torch.log(torch.clamp(depths / near, min=1e-6)) / log_span
        * ((1 << depth_bits) - 1)
    ).to(torch.int32).long().clamp(0, (1 << depth_bits) - 1)
    return (tx0, ty0, bw, ntiles, dq, depths, means2d[:, 0], means2d[:, 1],
            proj.prune_r.detach())


def bin_pairs_batched(
    proj_b: Projected,
    width: int,
    height: int,
    *,
    tile_size,
    max_pairs: int,
    near: float = 0.01,
    far: float = 1e10,
) -> PairBins:
    """Bin B cameras' projections (every field with a leading camera axis)
    in one pass: the pair expansion, one stable sort of all B x
    ``max_pairs`` keys and the tile search run once for the batch. The
    camera index sits above each camera's ``tile | log-depth`` key, whose
    bits come from the tile count alone, so each camera's slice of the
    sorted pairs is what ``bin_pairs`` gives it alone. The per-Gaussian
    inputs (tile rectangles, quantized depths) are computed one camera at a
    time with ``bin_pairs``' own shapes, so their floats are its bits too.
    Returns a ``PairBins`` with a leading camera axis."""
    grid = tile_grid(width, height, tile_size)
    tw, th, tsx, tsy = grid
    num_tiles = grid.num_tiles
    if proj_b.extents is None or proj_b.prune_r is None:
        raise ValueError("bin_pairs bins by the opacity-aware bounds: give the projection's "
                         "extents and prune_r (ops/projection.project computes them)")
    b, n = proj_b.means2d.shape[:2]
    dev = proj_b.means2d.device
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    depth_bits = min(31 - tile_bits, 19)
    if depth_bits < 14:
        raise ValueError(f"too many tiles for packed-key binning: {num_tiles}")
    log_span = float(math.log(max(far / near, 1.0 + 1e-6)))
    per_camera = [_gaussian_tiles(camera_slice(proj_b, i), grid, near, log_span,
                                  depth_bits) for i in range(b)]
    tx0, ty0, bw, ntiles, dq, depths, mx, my, prune_r = (torch.stack(x) for x in zip(*per_camera))

    # depth-priority budget, per camera: when its pairs overflow max_pairs,
    # slots go to Gaussians near-to-far, so the overflow drops the farthest
    iota = torch.arange(n, device=dev).expand(b, n)
    by_depth = torch.argsort(torch.where(ntiles > 0, depths, torch.inf), dim=1, stable=True)
    order = torch.where(ntiles.sum(1, keepdim=True) > max_pairs, by_depth, iota)
    order_inv = torch.empty_like(order).scatter_(1, order, iota)

    counts = ntiles.gather(1, order)
    offsets = torch.cumsum(counts, 1)
    total = offsets[:, -1]
    starts = offsets - counts
    slot = torch.arange(max_pairs, device=dev).expand(b, max_pairs)
    rank = torch.searchsorted(offsets, slot.contiguous(), right=True).clamp(max=n - 1)
    gid = order.gather(1, rank)
    local = slot - starts.gather(1, rank)
    bw1 = bw.clamp(min=1).gather(1, gid)
    tile_xi = tx0.gather(1, gid) + local % bw1
    tile_yi = ty0.gather(1, gid) + local // bw1
    tile_id = tile_yi * tw + tile_xi
    in_range = slot < torch.clamp(total, max=max_pairs)[:, None]
    # per-pair circle prune: a tile whose rect lies beyond prune_r of the mean
    # is entirely below the 1/255 alpha cutoff, so dropping it is exact
    gx, gy, r = mx.gather(1, gid), my.gather(1, gid), prune_r.gather(1, gid)
    x0 = tile_xi.to(torch.float32) * tsx
    y0 = tile_yi.to(torch.float32) * tsy
    dx = gx - torch.minimum(torch.maximum(gx, x0), x0 + tsx)
    dy = gy - torch.minimum(torch.maximum(gy, y0), y0 + tsy)
    in_range = in_range & (dx * dx + dy * dy <= r * r)
    tile_id = torch.where(in_range, tile_id, num_tiles)
    pair_gid = torch.where(in_range, gid, n)

    key = tile_id * (1 << depth_bits) + torch.where(in_range, dq.gather(1, gid), 0)
    cam = torch.arange(b, device=dev)[:, None]
    key = key + (cam << (tile_bits + depth_bits))
    sorted_key, perm = torch.sort(key.reshape(-1), stable=True)
    # camera c's keys are the c-th block of max_pairs in sorted order
    perm = perm.view(b, max_pairs) - cam * max_pairs
    sorted_tile = (sorted_key.view(b, max_pairs) >> depth_bits) - (cam << tile_bits)
    seg_start = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, device=dev).expand(b, -1).contiguous()
    )
    return PairBins(
        sorted_gid=pair_gid.gather(1, perm),
        seg_start=seg_start,
        sorted_row_of_slot=torch.empty_like(perm).scatter_(1, perm, slot),
        gs_start=starts,
        gs_count=counts,
        gs_inv=order_inv,
        total_pairs=total,
    )


def bin_pairs(
    proj: Projected,
    width: int,
    height: int,
    *,
    tile_size,
    max_pairs: int,
    near: float = 0.01,
    far: float = 1e10,
) -> PairBins:
    """One camera's ``PairBins``: ``bin_pairs_batched`` of a batch of one."""
    return camera_slice(
        bin_pairs_batched(Projected(*(None if x is None else x[None] for x in proj)), width,
                          height, tile_size=tile_size, max_pairs=max_pairs, near=near, far=far),
        0)


class Chunks(NamedTuple):
    """Static-size chunk list over the tiles' sorted pair ranges."""

    tile_chunk_start: torch.Tensor  # [T+1] int32 slot of each tile's first chunk; [T] = chunk count
    chunk_tile: torch.Tensor        # [slots] int32 tile of each slot (T past the chunk count)
    kc: int                         # pairs per chunk, at most


def chunk_list(seg_start: torch.Tensor, max_pairs: int, kc: int = CHUNK_PAIRS) -> Chunks:
    """Cut every tile's pairs into chunks of at most ``kc``, on the device and
    without a host sync: ``num_tiles + ceil(max_pairs / kc)`` slots always
    hold them, since a tile of n pairs takes max(1, ceil(n / kc)) chunks."""
    num_tiles = seg_start.shape[0] - 1
    counts = seg_start[1:] - seg_start[:-1]
    per_tile = torch.clamp(torch.div(counts + kc - 1, kc, rounding_mode="floor"), min=1)
    ends = torch.cumsum(per_tile, 0)
    slots = torch.arange(num_tiles + -(-max_pairs // kc), device=seg_start.device)
    return Chunks(
        tile_chunk_start=torch.cat((ends.new_zeros(1), ends)).to(torch.int32),
        chunk_tile=torch.searchsorted(ends, slots, right=True).to(torch.int32),
        kc=kc,
    )


# --- plain versions of K1 and K2 ------------------------------------------------

_PLAIN_GROUP_ELEMS = 1 << 24  # bounds each [tiles, pairs, pixels] temporary


def _tile_groups(seg_start: torch.Tensor, npx: int):
    """Yield (tiles [G], idx [G, K], live [G, K]) over groups of the tiles
    that hold pairs, taken in order of falling pair count: each group is
    padded to its first (fullest) tile and holds as many tiles as the
    temporaries' bound allows. One host sync reads the counts."""
    counts = seg_start[1:] - seg_start[:-1]
    order = torch.argsort(counts, descending=True, stable=True)
    sorted_counts = counts[order].tolist()
    i = 0
    while i < len(sorted_counts) and sorted_counts[i] > 0:
        kmax = sorted_counts[i]
        tiles = order[i:i + max(1, _PLAIN_GROUP_ELEMS // (kmax * npx))]
        i += tiles.shape[0]
        k = torch.arange(kmax, device=seg_start.device)
        live = k < counts[tiles, None]
        # padding past a tile's pairs points at some pair in a tile: never
        # past the array's end
        idx = torch.clamp(seg_start[tiles, None] + k, max=seg_start[-1] - 1)
        yield tiles, idx, live


def _pixel_centers(grid: TileGrid, tiles: torch.Tensor):
    flat = torch.arange(grid.pixels, device=tiles.device)[None, :]
    px = ((tiles[:, None] % grid.tw) * grid.tsx + flat % grid.tsx).to(torch.float32) + 0.5
    py = ((tiles[:, None] // grid.tw) * grid.tsy + flat // grid.tsx).to(torch.float32) + 0.5
    return px[:, None, :], py[:, None, :]      # [G, 1, P]


def _alphas(p: torch.Tensor, live: torch.Tensor, px, py):
    """[G, K, W] pair rows -> per (pair, pixel) dx, dy, exp(-sigma), raw
    alpha, keep."""
    dx = p[..., 0:1] - px
    dy = p[..., 1:2] - py
    sigma = 0.5 * (p[..., 2:3] * dx * dx + p[..., 4:5] * dy * dy) + p[..., 3:4] * dx * dy
    falloff = torch.exp(-sigma)
    alpha_raw = torch.clamp(p[..., 5:6] * falloff, max=MAX_ALPHA)
    keep = (sigma >= 0) & (alpha_raw >= MIN_ALPHA) & live[..., None]
    return dx, dy, falloff, alpha_raw, keep


def _colmat(p: torch.Tensor, channels: int) -> torch.Tensor:
    """[G, K, C+2] per-pair accumulation columns: colors | depth | 1."""
    return torch.cat(
        (p[..., HDR:HDR + channels], p[..., 6:7], torch.ones_like(p[..., :1])), -1
    )


def composite_fwd_plain(pairs, seg_start, grid: TileGrid, channels: int):
    """Plain version of K1. Returns (out [T, C+2, P], t_final [T, P],
    n_contrib [T, P] int32)."""
    num_tiles, npx = grid.num_tiles, grid.pixels
    dev = pairs.device
    out = torch.zeros((num_tiles, channels + 2, npx), device=dev)
    t_final = torch.ones((num_tiles, npx), device=dev)
    n_contrib = torch.zeros((num_tiles, npx), dtype=torch.int32, device=dev)
    for tiles, idx, live in _tile_groups(seg_start, npx):
        p = pairs[idx]
        px, py = _pixel_centers(grid, tiles)
        _, _, _, alpha_raw, keep = _alphas(p, live, px, py)
        alpha = torch.where(keep, alpha_raw, 0.0)
        trans = torch.cumprod(1.0 - alpha, dim=1)                  # inclusive
        t_excl = torch.cat((torch.ones_like(trans[:, :1]), trans[:, :-1]), 1)
        # the gate precedes the contribution: T before the pair > 1e-4
        gate = (t_excl > TRANSMITTANCE_EPS) & live[..., None]
        w = torch.where(gate, alpha * t_excl, 0.0)
        out[tiles] = torch.einsum("gkc,gkp->gcp", _colmat(p, channels), w)
        cnt = gate.sum(1)
        last = trans.gather(1, (cnt - 1).clamp(min=0)[:, None, :])[:, 0]
        t_final[tiles] = torch.where(cnt > 0, last, 1.0)
        n_contrib[tiles] = cnt.to(torch.int32)
    return out, t_final, n_contrib


def composite_bwd_plain(pairs, seg_start, grid: TileGrid, channels: int,
                        grad_out, t_final, n_contrib, max_pairs: int):
    """Plain version of K2, written from K2's formulas (not autograd of the
    forward). Returns d_pairs [max_pairs, 7+C] in sorted pair order."""
    width = HDR + channels
    dev = pairs.device
    d_pairs = torch.zeros((max_pairs, width), device=dev)
    for tiles, idx, live in _tile_groups(seg_start, grid.pixels):
        p = pairs[idx]
        px, py = _pixel_centers(grid, tiles)
        dx, dy, falloff, alpha_raw, keep = _alphas(p, live, px, py)
        alpha = torch.where(keep, alpha_raw, 0.0)
        one_minus = 1.0 - alpha
        # rank gate: pair k is live for a pixel iff k < its contributor count
        k = torch.arange(p.shape[1], device=dev)[None, :, None]
        lv = k < n_contrib[tiles, None, :]
        # T before pair k = T after the last contributor / prod_{j>=k} (1 - a_j)
        suf_prod = torch.flip(torch.cumprod(torch.flip(torch.where(lv, one_minus, 1.0), [1]), 1), [1])
        t_excl = t_final[tiles, None, :] / suf_prod
        w = torch.where(lv, alpha * t_excl, 0.0)
        g = grad_out[tiles]                                         # [G, C+2, P]
        s = torch.einsum("gkc,gcp->gkp", _colmat(p, channels), g)
        ws = w * s
        suffix_after = torch.flip(torch.cumsum(torch.flip(ws, [1]), 1), [1]) - ws
        d_alpha = torch.where(lv, t_excl * s - suffix_after / torch.clamp(one_minus, min=1e-6), 0.0)
        d_alpha = torch.where(keep & (alpha_raw < MAX_ALPHA), d_alpha, 0.0)
        d_sigma = -alpha * d_alpha
        ca, cb, cc = p[..., 2:3], p[..., 3:4], p[..., 4:5]
        d_op = torch.where(keep, falloff * d_alpha, 0.0).sum(-1)
        rows = torch.cat(
            (
                (d_sigma * (ca * dx + cb * dy)).sum(-1, keepdim=True),
                (d_sigma * (cc * dy + cb * dx)).sum(-1, keepdim=True),
                (0.5 * d_sigma * dx * dx).sum(-1, keepdim=True),
                (d_sigma * dx * dy).sum(-1, keepdim=True),
                (0.5 * d_sigma * dy * dy).sum(-1, keepdim=True),
                torch.where(p[..., 5] > 0, d_op, 0.0)[..., None],
                torch.einsum("gkp,gp->gk", w, g[:, channels])[..., None],
                torch.einsum("gkp,gcp->gkc", w, g[:, :channels]),
            ),
            -1,
        )
        d_pairs[idx[live]] = rows[live]
    return d_pairs


def _fold_chunks(x: torch.Tensor, kc: int, fill: float, reduce) -> torch.Tensor:
    """[G, K, P] per-pair values -> [G, ceil(K / kc), P] reduced per chunk."""
    g, k, p = x.shape
    nck = -(-k // kc)
    x = torch.nn.functional.pad(x, (0, 0, 0, nck * kc - k), value=fill)
    return reduce(x.reshape(g, nck, kc, p), 2)


def _chunk_slots(chunks: Chunks, seg_start, tiles, nck: int):
    """[G, nck] slot of tile t's j-th chunk, and whether the tile has it."""
    counts = seg_start[tiles + 1] - seg_start[tiles]
    j = torch.arange(nck, device=counts.device)
    have = j * chunks.kc < counts[:, None]
    return chunks.tile_chunk_start[tiles, None].long() + j, have


def chunk_products_plain(pairs, seg_start, grid: TileGrid, chunks: Chunks):
    """Plain version of K1's first pass. Returns [slots, P]: each chunk's
    per-pixel product of (1 - alpha) over its pairs, with no gate (1 for an
    empty tile's chunk, 0 for the slots past the chunk count)."""
    dev = pairs.device
    prod = torch.zeros((chunks.chunk_tile.shape[0], grid.pixels), device=dev)
    prod[chunks.tile_chunk_start[:-1].long()] = 1.0
    for tiles, idx, live in _tile_groups(seg_start, grid.pixels):
        px, py = _pixel_centers(grid, tiles)
        _, _, _, alpha_raw, keep = _alphas(pairs[idx], live, px, py)
        cp = _fold_chunks(torch.where(keep, 1.0 - alpha_raw, 1.0), chunks.kc, 1.0, torch.prod)
        slot, have = _chunk_slots(chunks, seg_start, tiles, cp.shape[1])
        prod[slot[have]] = cp[have]
    return prod


def chunk_suffix_plain(pairs, seg_start, grid: TileGrid, channels: int, chunks: Chunks,
                       grad_out, n_contrib):
    """Plain version of K2's first pass. Returns [slots, P]: each chunk's
    per-pixel sum of w * s over its rank-live pairs; 0 for a tile's first
    chunk (only earlier chunks read a sum) and for the slots past the chunk
    count."""
    dev = pairs.device
    suffix = torch.zeros((chunks.chunk_tile.shape[0], grid.pixels), device=dev)
    for tiles, idx, live in _tile_groups(seg_start, grid.pixels):
        p = pairs[idx]
        px, py = _pixel_centers(grid, tiles)
        _, _, _, alpha_raw, keep = _alphas(p, live, px, py)
        alpha = torch.where(keep, alpha_raw, 0.0)
        k = torch.arange(p.shape[1], device=dev)[None, :, None]
        lv = k < n_contrib[tiles, None, :]
        trans = torch.cumprod(torch.where(lv, 1.0 - alpha, 1.0), 1)
        t_excl = torch.cat((torch.ones_like(trans[:, :1]), trans[:, :-1]), 1)
        s = torch.einsum("gkc,gcp->gkp", _colmat(p, channels), grad_out[tiles])
        cs = _fold_chunks(torch.where(lv, alpha * t_excl * s, 0.0), chunks.kc, 0.0, torch.sum)
        slot, have = _chunk_slots(chunks, seg_start, tiles, cs.shape[1])
        have &= slot > chunks.tile_chunk_start[tiles, None].long()
        suffix[slot[have]] = cs[have]
    return suffix


# --- kernel wrappers -------------------------------------------------------------


def _chunk_args(pairs, seg_start, grid: TileGrid, channels: int, chunks: Chunks) -> tuple:
    """Check the operands every compositing pass takes; return their C
    arguments (pairs .. kc)."""
    if grid.pixels > 256 or grid.pixels % 32:
        raise ValueError(f"tile {grid.tsx}x{grid.tsy}: pixels must be a multiple of 32, <= 256")
    if not 1 <= channels <= MAX_CHANNELS:
        raise ValueError(f"channels={channels}: the kernels take 1..{MAX_CHANNELS}")
    num_tiles = grid.num_tiles
    _kernels.check_cuda_tensor(pairs, "pairs", torch.float32)
    if pairs.dim() != 2 or pairs.shape[1] != row_stride(channels):
        raise ValueError(
            f"pairs: expected [M, {row_stride(channels)}], got {tuple(pairs.shape)}")
    if pairs.data_ptr() % 16:
        raise ValueError("pairs: the kernels copy rows in 16 bytes; align the tensor to 16")
    _kernels.check_cuda_tensor(seg_start, "seg_start", torch.int64, (num_tiles + 1,))
    slots = num_tiles + -(-pairs.shape[0] // chunks.kc)
    _kernels.check_cuda_tensor(chunks.tile_chunk_start, "tile_chunk_start", torch.int32,
                               (num_tiles + 1,))
    _kernels.check_cuda_tensor(chunks.chunk_tile, "chunk_tile", torch.int32, (slots,))
    return (pairs.data_ptr(), seg_start.data_ptr(), chunks.chunk_tile.data_ptr(),
            chunks.tile_chunk_start.data_ptr(), num_tiles, slots, grid.tw, grid.tsx,
            grid.tsy, channels, chunks.kc)


def chunk_products(pairs, seg_start, grid: TileGrid, channels: int, chunks: Chunks):
    """K1's first pass for CUDA tensors, its plain version for CPU tensors.
    Returns [slots, P] per-chunk products of (1 - alpha)."""
    if pairs.device.type == "cpu":
        return chunk_products_plain(pairs, seg_start, grid, chunks)
    args = _chunk_args(pairs, seg_start, grid, channels, chunks)
    prod = torch.zeros((chunks.chunk_tile.shape[0], grid.pixels), device=pairs.device)
    _kernels.launch("k1_chunk_products", *args, prod.data_ptr(), _kernels.stream_of(pairs))
    return prod


def composite_fwd(pairs, seg_start, grid: TileGrid, channels: int, chunks: Chunks, prod):
    """K1's compositing pass for CUDA tensors, its plain version for CPU
    tensors. Returns (out [T, C+2, P], t_final [T, P], n_contrib [T, P] int32)."""
    if pairs.device.type == "cpu":
        return composite_fwd_plain(pairs, seg_start, grid, channels)
    args = _chunk_args(pairs, seg_start, grid, channels, chunks)
    slots, npx = chunks.chunk_tile.shape[0], grid.pixels
    _kernels.check_cuda_tensor(prod, "prod", torch.float32, (slots, npx))
    dev = pairs.device
    out = torch.empty((grid.num_tiles, channels + 2, npx), device=dev)
    t_final = torch.empty((grid.num_tiles, npx), device=dev)
    n_contrib = torch.empty((grid.num_tiles, npx), dtype=torch.int32, device=dev)
    # per-chunk partials of the tiles with several chunks, combined in order
    part = torch.empty((slots, channels + 2, npx), device=dev)
    part_t = torch.empty((slots, npx), device=dev)
    part_n = torch.empty((slots, npx), dtype=torch.int32, device=dev)
    _kernels.launch(
        "k1_composite_fwd", *args, prod.data_ptr(), out.data_ptr(), t_final.data_ptr(),
        n_contrib.data_ptr(), part.data_ptr(), part_t.data_ptr(), part_n.data_ptr(),
        _kernels.stream_of(pairs),
    )
    return out, t_final, n_contrib


def chunk_suffix(pairs, seg_start, grid: TileGrid, channels: int, chunks: Chunks, prod,
                 grad_out, n_contrib):
    """K2's first pass for CUDA tensors, its plain version for CPU tensors.
    Returns [slots, P] per-chunk sums of w * s over rank-live pairs."""
    if pairs.device.type == "cpu":
        return chunk_suffix_plain(pairs, seg_start, grid, channels, chunks, grad_out, n_contrib)
    args = _chunk_args(pairs, seg_start, grid, channels, chunks)
    slots, npx = chunks.chunk_tile.shape[0], grid.pixels
    _kernels.check_cuda_tensor(prod, "prod", torch.float32, (slots, npx))
    _kernels.check_cuda_tensor(grad_out, "grad_out", torch.float32,
                               (grid.num_tiles, channels + 2, npx))
    _kernels.check_cuda_tensor(n_contrib, "n_contrib", torch.int32, (grid.num_tiles, npx))
    suffix = torch.zeros((slots, npx), device=pairs.device)
    _kernels.launch(
        "k2_chunk_suffix", *args, prod.data_ptr(), grad_out.data_ptr(), n_contrib.data_ptr(),
        suffix.data_ptr(), _kernels.stream_of(pairs),
    )
    return suffix


def composite_bwd(pairs, seg_start, grid: TileGrid, channels: int, grad_out, t_final,
                  n_contrib, max_pairs: int, chunks: Chunks, prod, suffix):
    """K2's gradient pass for CUDA tensors, its plain version for CPU
    tensors. Returns d_pairs [max_pairs, 7+C] in sorted pair order (zero for
    pairs outside every tile and behind every pixel's last contributor)."""
    if pairs.device.type == "cpu":
        return composite_bwd_plain(pairs, seg_start, grid, channels,
                                   grad_out, t_final, n_contrib, max_pairs)
    args = _chunk_args(pairs, seg_start, grid, channels, chunks)
    slots, npx = chunks.chunk_tile.shape[0], grid.pixels
    if pairs.shape[0] != max_pairs:
        raise ValueError(f"pairs: expected {max_pairs} rows, got {pairs.shape[0]}")
    _kernels.check_cuda_tensor(grad_out, "grad_out", torch.float32,
                               (grid.num_tiles, channels + 2, npx))
    _kernels.check_cuda_tensor(t_final, "t_final", torch.float32, (grid.num_tiles, npx))
    _kernels.check_cuda_tensor(n_contrib, "n_contrib", torch.int32, (grid.num_tiles, npx))
    _kernels.check_cuda_tensor(prod, "prod", torch.float32, (slots, npx))
    _kernels.check_cuda_tensor(suffix, "suffix", torch.float32, (slots, npx))
    d_pairs = torch.empty((max_pairs, HDR + channels), device=pairs.device)
    _kernels.launch(
        "k2_composite_bwd", *args, grad_out.data_ptr(), t_final.data_ptr(),
        n_contrib.data_ptr(), prod.data_ptr(), suffix.data_ptr(), d_pairs.data_ptr(),
        max_pairs, _kernels.stream_of(pairs),
    )
    return d_pairs


def pack_pairs(bins: PairBins, means2d, conics, opacities, colors, depths) -> torch.Tensor:
    """[max_pairs, row_stride(C)] pair rows in sorted order: 7 + C columns,
    zero padding, and zero rows for invalid pairs."""
    pad = row_stride(colors.shape[-1]) - HDR - colors.shape[-1]
    packed = torch.cat(
        (means2d, conics, opacities[:, None], depths[:, None], colors,
         colors.new_zeros((colors.shape[0], pad))), -1
    )
    packed = torch.cat((packed, packed.new_zeros((1, packed.shape[1]))))
    return packed[bins.sorted_gid].contiguous()


class _CompositePairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means2d, conics, opacities, colors, depths, bins: PairBins, grid: TileGrid):
        channels = colors.shape[-1]
        pairs = pack_pairs(bins, means2d, conics, opacities, colors, depths)
        # the chunk list and the first passes (K1a, K2a) feed only the
        # kernels' second passes: the plain second passes (CPU) read neither
        chunks = prod = None
        if pairs.device.type != "cpu":
            chunks = chunk_list(bins.seg_start, pairs.shape[0])
            prod = chunk_products(pairs, bins.seg_start, grid, channels, chunks)
        out, t_final, n_contrib = composite_fwd(pairs, bins.seg_start, grid, channels, chunks,
                                                prod)
        ctx.save_for_backward(pairs, t_final, n_contrib, prod)
        ctx.bins = bins
        ctx.grid = grid
        ctx.chunks = chunks
        color = out[:, :channels, :].transpose(1, 2).contiguous()   # [T, P, C]
        return color, out[:, channels + 1, :], out[:, channels, :]  # color, alpha, depth

    @staticmethod
    def backward(ctx, g_color, g_alpha, g_depth):
        pairs, t_final, n_contrib, prod = ctx.saved_tensors
        bins, grid, chunks = ctx.bins, ctx.grid, ctx.chunks
        channels = g_color.shape[-1]
        grad_out = torch.cat(
            (g_color.transpose(1, 2), g_depth[:, None, :], g_alpha[:, None, :]), 1
        ).contiguous()
        suffix = None if prod is None else chunk_suffix(
            pairs, bins.seg_start, grid, channels, chunks, prod, grad_out, n_contrib)
        d_sorted = composite_bwd(pairs, bins.seg_start, grid, channels, grad_out,
                                 t_final, n_contrib, pairs.shape[0], chunks, prod, suffix)
        # generation order is gaussian-major: one contiguous run per gaussian
        d_pair = d_sorted[bins.sorted_row_of_slot]
        d_g = contiguous_segment_sum(d_pair, bins.gs_start, bins.gs_count)[bins.gs_inv]
        return (d_g[:, 0:2], d_g[:, 2:5], d_g[:, 5], d_g[:, HDR:], d_g[:, 6], None, None)


def composite_pairs(bins: PairBins, grid: TileGrid, means2d, conics, opacities,
                    colors, depths):
    """Differentiable composite of binned pairs. Returns per-tile
    (color [T, P, C], alpha [T, P], accumulated depth [T, P])."""
    return _CompositePairs.apply(means2d, conics, opacities, colors, depths, bins, grid)
