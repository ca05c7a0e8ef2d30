"""The yardstick of kernels K1 and K2: what their inputs need, and the chip's peaks.

A frozen copy of the counting that ``chip_smoke.py`` applies to K1 / K2
(``EVAL_OPS``, ``kept_ops``, ``pair_pixel_counts``, ``bound_ms``, the bytes
of ``measure_kernels``), which later changes to the port must not move. The
alpha test is the reference's frozen one, not the port's.
"""
from __future__ import annotations

import torch

from .reference.plain.ops import rasterize_pairs as rp

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# FP32 operations per (pair, pixel), counting an FMA as 2 and expf as 1
# (csrc/rasterize_fwd.cu, csrc/rasterize_bwd.cu). Every walked pair-pixel
# pays the evaluation (offsets 2, sigma 9, exp 1, alpha / keep 4); only a
# kept one pays the rest:
#   K1 products: 1 - alpha and the product, 2;
#   K1 compositing: weight 1, T update 2, accumulation 2 (C + 2);
#   K2 suffix: s 2 (C + 2), w 2, sum 2, T update 2;
#   K2 gradients: reciprocal and T rebuild 2, w 1, s 2 (C + 2), d_alpha 4,
#       suffix 2, d_sigma 1, geometry terms 14, d_opacity 1, colour and depth
#       terms C + 1, and the pair's 7 + C terms summed across the tile.
EVAL_OPS = 16

# the kernels of each pass, as their names appear in a device trace
PASS_KERNELS = {
    "k1_chunk_products": ("chunk_products_kernel",),
    "k1_composite_fwd": ("composite_fwd_kernel", "combine_kernel"),
    "k2_chunk_suffix": ("chunk_suffix_kernel",),
    "k2_composite_bwd": ("composite_bwd_kernel",),
}
K1 = ("k1_chunk_products", "k1_composite_fwd")
K2 = ("k2_chunk_suffix", "k2_composite_bwd")


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    """The least time the chip could take: bytes at the HBM peak or FP32
    operations at their peak, whichever is longer, and which it was."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kept_ops(kernel: str, c: int) -> int:
    return {
        "k1_chunk_products": 2,
        "k1_composite_fwd": 3 + 2 * (c + 2),
        "k2_chunk_suffix": 6 + 2 * (c + 2),
        "k2_composite_bwd": 25 + 2 * (c + 2) + (c + 1) + (7 + c),
    }[kernel]


@torch.no_grad()
def pair_pixel_counts(pairs, seg_start, grid, n_contrib, kc: int) -> dict:
    """What these inputs need of K1 and K2: the walked (pair, pixel)
    evaluations (each pixel's pairs up to its contributor count), the kept
    ones among them (sigma >= 0 and alpha >= 1/255), all (pair, pixel) of
    the pairs in some tile, the tiles holding a pair and the largest tile;
    and the pairs some pixel walks (each tile's pairs up to its largest
    contributor count) with the chunks of kc that hold them. The suffix_*
    counts are the same past each tile's first chunk, the only part K2's
    suffix pass walks; multi_chunk_tiles hold more than one chunk."""
    dev = pairs.device
    counts = seg_start[1:] - seg_start[:-1]
    total = int(seg_start[-1])
    tile_of = torch.repeat_interleave(torch.arange(grid.num_tiles, device=dev), counts)
    rank = torch.arange(total, device=dev) - seg_start[tile_of]
    flat = torch.arange(grid.pixels, device=dev)
    kept = kept_late = 0
    step = max(1, (1 << 24) // grid.pixels)
    for s0 in range(0, total, step):
        s1 = min(s0 + step, total)
        t = tile_of[s0:s1, None]
        px = ((t % grid.tw) * grid.tsx + flat % grid.tsx).float() + 0.5
        py = ((t // grid.tw) * grid.tsy + flat // grid.tsx).float() + 0.5
        live = torch.ones((s1 - s0, 1), dtype=torch.bool, device=dev)
        keep = rp._alphas(pairs[s0:s1, None, :], live, px[:, None], py[:, None])[-1][:, 0]
        r = rank[s0:s1, None]
        walked_keep = keep & (r < n_contrib[t[:, 0]])
        kept += int(walked_keep.sum())
        kept_late += int((walked_keep & (r >= kc)).sum())
    walked = torch.minimum(counts, n_contrib.long().amax(-1))
    walked_chunks = (walked + kc - 1) // kc
    return {
        "walked_pairs": int(walked.sum()),
        "walked_chunks": int(walked_chunks.sum()),
        "walked_pair_pixels": int(n_contrib.long().sum()),
        "kept_pair_pixels": kept,
        "suffix_walked_pairs": int((walked - kc).clamp(min=0).sum()),
        "suffix_walked_chunks": int((walked_chunks - 1).clamp(min=0).sum()),
        "suffix_walked_tiles": int((walked > kc).sum()),
        "suffix_pair_pixels": int((n_contrib.long() - kc).clamp(min=0).sum()),
        "suffix_kept_pair_pixels": kept_late,
        "multi_chunk_tiles": int((counts > kc).sum()),
        "tile_pair_pixels": int(seg_start[-1]) * grid.pixels,
        "tiles_with_pairs": int((counts > 0).sum()),
        "max_pairs_per_tile": int(counts.max()) if counts.numel() else 0,
    }


def pass_work(pairs, seg_start, grid, channels: int, n_contrib, max_pairs: int,
              kc: int = rp.CHUNK_PAIRS) -> dict:
    """Per pass of K1 and K2 at these inputs: the bytes it must move (inputs
    read once, outputs written once), the FP32 operations it must do, and
    its bound. K1's products pass reads every pair and writes every chunk's
    products; the passes after it need only the pairs some pixel walks and
    their chunks, and K2's suffix pass only those past each tile's first
    chunk (with the products of the chunks before them) but writes every
    chunk's suffix."""
    counts = pair_pixel_counts(pairs, seg_start, grid, n_contrib, kc)
    tiles, npx, f = grid.num_tiles, grid.pixels, 4
    per_tile_chunks = torch.clamp((seg_start[1:] - seg_start[:-1] + kc - 1) // kc, min=1)
    n_chunks = int(per_tile_chunks.sum())
    slots = tiles + -(-pairs.shape[0] // kc)
    row = rp.row_stride(channels) * f
    list_bytes = (tiles + 1) * 8 + (tiles + 1) * 4 + slots * 4
    per_chunk = n_chunks * npx * f
    walked = counts["walked_pairs"] * row + counts["walked_chunks"] * npx * f
    per_tile = tiles * npx * f
    work = {
        "k1_chunk_products": (int(seg_start[-1]) * row + list_bytes + per_chunk,
                              counts["tile_pair_pixels"], counts["kept_pair_pixels"]),
        "k1_composite_fwd": (walked + list_bytes + per_tile * (channels + 4),
                             counts["walked_pair_pixels"], counts["kept_pair_pixels"]),
        "k2_chunk_suffix": (
            counts["suffix_walked_pairs"] * row + counts["suffix_walked_chunks"] * npx * f
            + per_chunk + list_bytes + counts["multi_chunk_tiles"] * npx * 4
            + counts["suffix_walked_tiles"] * (channels + 2) * npx * f,
            counts["suffix_pair_pixels"], counts["suffix_kept_pair_pixels"]),
        "k2_composite_bwd": (
            walked + counts["walked_chunks"] * npx * f + list_bytes
            + per_tile * (channels + 4) + max_pairs * (rp.HDR + channels) * f,
            counts["walked_pair_pixels"], counts["kept_pair_pixels"]),
    }
    out = {}
    for name, (nbytes, evaluated, kept) in work.items():
        ops = evaluated * EVAL_OPS + kept * kept_ops(name, channels)
        b, by = bound_ms(nbytes, ops)
        out[name] = {"bytes": nbytes, "ops": ops, "bound_ms": b, "bound_by": by}
    out["counts"] = counts
    return out
