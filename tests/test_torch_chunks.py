"""The chunk work unit of the compositing kernels K1 and K2, on the CPU: the
chunk list, the plain versions of the per-chunk passes (K1's products, K2's
suffix sums) and chip_smoke.py's count of the work the kernels need, each
against a plain numpy loop over tiles, chunks, pairs and pixels."""
import math

import numpy as np
import pytest
import torch

from chip_smoke import pair_pixel_counts
from geosplatting_tpu_torch.ops import rasterize_pairs as rp

from .torch_parity import n, one_torch_thread  # noqa: F401

GRID = rp.TileGrid(tw=3, th=2, tsx=8, tsy=4)  # 6 tiles of 32 pixels
COUNTS = [0, 5, 70, 0, 33, 1]


def np_chunk_list(counts, max_pairs, kc):
    tiles = len(counts)
    chunk_tile, starts = [], [0]
    for t, c in enumerate(counts):
        chunk_tile += [t] * max(1, math.ceil(c / kc))
        starts.append(len(chunk_tile))
    slots = tiles + math.ceil(max_pairs / kc)
    assert len(chunk_tile) <= slots
    return np.array(starts), np.array(chunk_tile + [tiles] * (slots - len(chunk_tile)))


@pytest.mark.parametrize("counts", [COUNTS, [0, 0, 0], [7], [128, 0, 129, 1]])
@pytest.mark.parametrize("kc", [1, 16, 64, 1000])
def test_chunk_list_matches_a_loop(counts, kc):
    max_pairs = sum(counts) + 3  # rows past the tiles' pairs, as bin_pairs leaves
    seg_start = torch.tensor(np.concatenate(([0], np.cumsum(counts))), dtype=torch.int64)
    chunks = rp.chunk_list(seg_start, max_pairs, kc)
    starts, chunk_tile = np_chunk_list(counts, max_pairs, kc)
    assert chunks.kc == kc
    assert chunks.tile_chunk_start.dtype == chunks.chunk_tile.dtype == torch.int32
    np.testing.assert_array_equal(n(chunks.tile_chunk_start), starts)
    np.testing.assert_array_equal(n(chunks.chunk_tile), chunk_tile)


def scene(seed=0, channels=3):
    """Pairs drawn around each tile (some far off it) with a few opaque ones,
    so some pixels saturate inside a chunk and others never do."""
    rng = np.random.default_rng(seed)
    rows = []
    for t, c in enumerate(COUNTS):
        x0, y0 = (t % GRID.tw) * GRID.tsx, (t // GRID.tw) * GRID.tsy
        mu = rng.uniform([x0 - 4, y0 - 4], [x0 + GRID.tsx + 4, y0 + GRID.tsy + 4], (c, 2))
        a = rng.uniform(0.02, 0.3, c)
        cc = rng.uniform(0.02, 0.3, c)
        b = rng.uniform(-0.5, 0.5, c) * np.sqrt(a * cc)
        op = np.where(rng.uniform(size=c) < 0.3, 0.99, rng.uniform(0.05, 0.6, c))
        depth = np.sort(rng.uniform(0.5, 3.0, c))
        color = rng.uniform(size=(c, channels))
        pad = np.zeros((c, rp.row_stride(channels) - rp.HDR - channels))
        rows.append(np.concatenate((mu, np.stack((a, b, cc, op, depth), 1), color, pad), 1))
    pairs = np.concatenate(rows + [np.zeros((3, rows[0].shape[1]))]).astype(np.float32)
    seg_start = np.concatenate(([0], np.cumsum(COUNTS)))
    return torch.from_numpy(pairs), torch.tensor(seg_start, dtype=torch.int64)


def np_alpha(row, px, py):
    dx, dy = row[0] - px, row[1] - py
    sigma = np.float32(0.5) * (row[2] * dx * dx + row[4] * dy * dy) + row[3] * dx * dy
    alpha = min(row[5] * np.exp(-sigma), np.float32(rp.MAX_ALPHA))
    return alpha if sigma >= 0 and alpha >= np.float32(rp.MIN_ALPHA) else np.float32(0.0)


def pixel_centers(tile):
    q = np.arange(GRID.pixels)
    px = (tile % GRID.tw) * GRID.tsx + q % GRID.tsx + 0.5
    py = (tile // GRID.tw) * GRID.tsy + q // GRID.tsx + 0.5
    return px.astype(np.float32), py.astype(np.float32)


def test_pack_pairs_pads_rows_to_16_bytes():
    for c in (1, 3, 14, 16):
        assert rp.row_stride(c) % 4 == 0 and 0 <= rp.row_stride(c) - rp.HDR - c < 4
    bins = rp.PairBins(sorted_gid=torch.tensor([1, 2, 0]), seg_start=None,
                       sorted_row_of_slot=None, gs_start=None, gs_count=None, gs_inv=None,
                       total_pairs=None)
    g = torch.arange(2 * 12, dtype=torch.float32).reshape(2, 12)
    packed = rp.pack_pairs(bins, g[:, 0:2], g[:, 2:5], g[:, 5], g[:, 7:10], g[:, 6])
    assert packed.shape == (3, rp.row_stride(3))
    np.testing.assert_array_equal(n(packed[0, :10]), n(g[1, :10]))
    assert not packed[1].any()          # the invalid gaussian id: a zero row
    assert not packed[:, 10:].any()     # the padding


@pytest.mark.parametrize("kc", [4, 16, 32])
def test_chunk_products_plain_matches_a_loop(kc):
    pairs, seg_start = scene()
    chunks = rp.chunk_list(seg_start, pairs.shape[0], kc)
    got = n(rp.chunk_products(pairs, seg_start, GRID, 3, chunks))
    want = np.zeros_like(got)
    p = n(pairs)
    starts = n(chunks.tile_chunk_start)
    for t, c in enumerate(COUNTS):
        px, py = pixel_centers(t)
        want[starts[t]] = 1.0
        for k in range(c):
            row = p[seg_start[t] + k]
            slot = starts[t] + k // kc
            if k % kc == 0:
                want[slot] = 1.0
            want[slot] *= np.array([1.0 - np_alpha(row, x, y) for x, y in zip(px, py)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kc", [4, 16])
def test_chunk_suffix_plain_matches_a_loop(kc):
    channels = 3
    pairs, seg_start = scene(0)
    chunks = rp.chunk_list(seg_start, pairs.shape[0], kc)
    _, _, n_contrib = rp.composite_fwd_plain(pairs, seg_start, GRID, channels)
    grad_out = torch.from_numpy(np.random.default_rng(2).normal(
        size=(GRID.num_tiles, channels + 2, GRID.pixels)).astype(np.float32))
    got = n(rp.chunk_suffix(pairs, seg_start, GRID, channels, chunks, None, grad_out,
                            n_contrib))
    want = np.zeros_like(got)
    p, g, cnt = n(pairs), n(grad_out), n(n_contrib)
    starts = n(chunks.tile_chunk_start)
    assert 0 < (cnt[2] < COUNTS[2]).sum() < GRID.pixels  # some pixels saturate in tile 2
    for t in range(GRID.num_tiles):
        px, py = pixel_centers(t)
        for q in range(GRID.pixels):
            T = 1.0
            for k in range(cnt[t, q]):
                row = p[seg_start[t] + k]
                alpha = np_alpha(row, px[q], py[q])
                s = g[t, :channels, q] @ row[rp.HDR:rp.HDR + channels] + g[t, channels, q] * row[6]
                s += g[t, channels + 1, q]
                if k >= kc:  # a tile's first chunk stays 0
                    want[starts[t] + k // kc, q] += alpha * T * s
                T *= 1.0 - alpha
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_pair_pixel_counts_match_a_loop():
    pairs, seg_start = scene(3)
    _, _, n_contrib = rp.composite_fwd_plain(pairs, seg_start, GRID, 3)
    got = pair_pixel_counts(pairs, seg_start, GRID, n_contrib)
    p, cnt = n(pairs), n(n_contrib)
    kept = 0
    for t in range(GRID.num_tiles):
        px, py = pixel_centers(t)
        for q in range(GRID.pixels):
            kept += sum(np_alpha(p[seg_start[t] + k], px[q], py[q]) > 0 for k in range(cnt[t, q]))
    assert got == {
        "walked_pair_pixels": int(cnt.sum()),
        "kept_pair_pixels": kept,
        "tile_pair_pixels": sum(COUNTS) * GRID.pixels,
        "tiles_with_pairs": 4,
        "max_pairs_per_tile": 70,
    }
    assert 0 < kept < cnt.sum()
