"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker gpu; the ``cuda_device``
fixture skips without one). This file imports no JAX, so it also runs where
only PyTorch is installed:

    python -m pytest -m gpu --noconftest -o addopts="" tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from geosplatting_tpu_torch import _kernels
from geosplatting_tpu_torch.graphics.cameras import Cameras
from geosplatting_tpu_torch.ops import rasterize_pairs as rp
from geosplatting_tpu_torch.ops.projection import project
from geosplatting_tpu_torch.ops.rasterize import rasterize
from geosplatting_tpu_torch.ops.segment_rows import (
    contiguous_segment_sum, cumsum_rows, cumsum_rows_plain,
)

from .torch_parity import cuda_device, n, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.gpu

WIDTH, HEIGHT = 128, 96


def k3_close(got, x):
    """K3 and torch.cumsum sum in different orders: hold the difference to
    1e-5 of the running |prefix| (plus 1e-6 absolute)."""
    want = torch.cumsum(x.double(), 0)
    scale = torch.cumsum(x.abs().double(), 0)
    err = (got.double() - want).abs()
    assert bool((err <= 1e-5 * scale + 1e-6).all()), float((err / (scale + 1e-6)).max())


@pytest.mark.parametrize("m,c", [(7, 3), (1000, 17), (5000, 1), (4097, 256), (300_000, 10)])
def test_k3_matches_cumsum(cuda_device, m, c):
    x = torch.randn((m, c), generator=torch.Generator().manual_seed(m), dtype=torch.float32)
    x = x.to(cuda_device)
    before = _kernels.launches["k3_cumsum_rows"]
    got = cumsum_rows(x)
    torch.cuda.synchronize()
    assert _kernels.launches["k3_cumsum_rows"] == before + 1
    k3_close(got, x)
    k3_close(cumsum_rows_plain(x), x)


def test_contiguous_segment_sum_on_card(cuda_device):
    vals = torch.randn((50, 4), device=cuda_device)
    counts = torch.tensor([3, 0, 10, 7, 30, 0], device=cuda_device)
    starts = torch.cumsum(counts, 0) - counts
    got = contiguous_segment_sum(vals, starts, counts)
    want = torch.stack([vals[int(s):int(s) + int(k)].sum(0) for s, k in zip(starts, counts)])
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


def scene(device, seed=3, num=400, channels=3, saturated=False):
    g = torch.Generator().manual_seed(seed)
    if saturated:
        xy = torch.randn((num, 2), generator=g) * 0.05
        z = torch.linspace(0.5, 2.0, num)[:, None]
        means = torch.cat((xy, z), -1)
        quats = torch.tensor([1.0, 0, 0, 0]).repeat(num, 1)
        scales = torch.full((num, 3), 0.08)
        opacities = torch.full((num,), 0.9)
    else:
        means = torch.rand((num, 3), generator=g) * 2 - 1
        quats = torch.nn.functional.normalize(torch.randn((num, 4), generator=g), dim=-1)
        scales = torch.exp(torch.rand((num, 3), generator=g) * 2.5 - 4.5)
        opacities = torch.rand((num,), generator=g) * 0.65 + 0.3
    colors = torch.rand((num, channels), generator=g)
    cam = Cameras.from_lookat(torch.tensor([2.0, 1.0, 1.5]), torch.zeros(3),
                              width=WIDTH, height=HEIGHT)
    return [x.to(device) for x in (means, quats, scales, opacities, colors,
                                   cam.view_matrix, cam.intrinsic_matrix)]


def binned(device, channels, tile, **kw):
    means, quats, scales, opacities, colors, vm, K = scene(device, channels=channels, **kw)
    proj = project(means, quats, scales, opacities, vm, K, WIDTH, HEIGHT)
    grid = rp.tile_grid(WIDTH, HEIGHT, tile)
    bins = rp.bin_pairs(proj, WIDTH, HEIGHT, tile_size=(grid.tsx, grid.tsy), max_pairs=16384)
    pairs = rp.pack_pairs(bins, proj.means2d, proj.conics, proj.opacities, colors, proj.depths)
    return pairs, bins, grid


PASSES = ("k1_chunk_products", "k1_composite_fwd", "k2_chunk_suffix", "k2_composite_bwd")


def check_passes(pairs, seg_start, grid, channels, kc):
    """Every K1 / K2 pass once on the card against its plain version; returns
    the kernels' (out, t_final, n_contrib)."""
    before = {k: _kernels.launches[k] for k in PASSES}
    chunks = rp.chunk_list(seg_start, pairs.shape[0], kc)
    prod = rp.chunk_products(pairs, seg_start, grid, channels, chunks)
    out, tf, nc = rp.composite_fwd(pairs, seg_start, grid, channels, chunks, prod)
    g = torch.rand(out.shape, generator=torch.Generator().manual_seed(1)).to(pairs.device)
    suffix = rp.chunk_suffix(pairs, seg_start, grid, channels, chunks, prod, g, nc)
    d = rp.composite_bwd(pairs, seg_start, grid, channels, g, tf, nc, pairs.shape[0], chunks,
                         prod, suffix)
    torch.cuda.synchronize()
    assert {k: _kernels.launches[k] - before[k] for k in PASSES} == dict.fromkeys(PASSES, 1)
    # products of at most kc <= 256 factors, each rounding by up to 2^-24,
    # multiplied in another order
    np.testing.assert_allclose(n(prod), n(rp.chunk_products_plain(pairs, seg_start, grid, chunks)),
                               rtol=2e-5, atol=1e-7)
    out_p, _, nc_p = rp.composite_fwd_plain(pairs, seg_start, grid, channels)
    # the plain version's cumprod runs as a parallel scan on the card, and the
    # kernel starts each chunk from a product of chunk products, so a pixel at
    # the T = 1e-4 cutoff may flip (tests/test_rasterize_pallas.py:53)
    np.testing.assert_allclose(n(out), n(out_p), atol=1e-3)
    assert float((nc != nc_p).float().mean()) < 0.01
    # feed the plain backward passes the kernel's saved state, so the rank
    # gates agree
    suffix_p = rp.chunk_suffix_plain(pairs, seg_start, grid, channels, chunks, g, nc)
    scale = float(suffix_p.abs().max())
    np.testing.assert_allclose(n(suffix), n(suffix_p), atol=2e-3 * scale, rtol=2e-3)
    d_p = rp.composite_bwd_plain(pairs, seg_start, grid, channels, g, tf, nc, pairs.shape[0])
    np.testing.assert_allclose(n(d), n(d_p), atol=2e-3, rtol=2e-3)
    return out, tf, nc


@pytest.mark.parametrize("channels,tile,saturated,kc", [
    (3, 16, False, 256), (3, (16, 8), False, 256), (14, 16, False, 256), (3, 16, True, 256),
    (1, 16, False, 32), (3, 16, True, 32), (14, (16, 8), True, 32), (16, 16, False, 32),
    (16, (16, 8), True, 64),
])
def test_k1_k2_match_plain(cuda_device, channels, tile, saturated, kc):
    pairs, bins, grid = binned(cuda_device, channels, tile, saturated=saturated)
    check_passes(pairs, bins.seg_start, grid, channels, kc)


def one_tile(device, opacity, conic=0.0, channels=3, seed=0):
    """The pairs of one 16x16 tile, all centred on it: opacity [M] per pair,
    conic a = c (0: the same alpha at every pixel)."""
    m = opacity.shape[0]
    rng = np.random.default_rng(seed)
    rows = np.zeros((m, rp.row_stride(channels)), np.float32)
    rows[:, 0:2] = 8.0 + rng.uniform(-2, 2, (m, 2))
    rows[:, 2] = rows[:, 4] = conic
    rows[:, 5] = opacity
    rows[:, 6] = np.linspace(0.5, 3.0, m)
    rows[:, rp.HDR:rp.HDR + channels] = rng.uniform(size=(m, channels))
    pairs = torch.from_numpy(np.concatenate((rows, np.zeros((5, rows.shape[1]), np.float32))))
    seg_start = torch.tensor([0, m], dtype=torch.int64)
    return pairs.to(device), seg_start.to(device), rp.TileGrid(1, 1, 16, 16)


@pytest.mark.parametrize("case", ["never_saturates", "saturates_mid_chunk", "at_boundary"])
def test_one_tile_of_several_chunks(cuda_device, case):
    kc = 16
    if case == "never_saturates":
        pairs, seg, grid = one_tile(cuda_device, np.full(5 * kc, 0.01), conic=0.002)
    elif case == "saturates_mid_chunk":
        pairs, seg, grid = one_tile(cuda_device, np.full(6 * kc, 0.3), conic=0.002)
    else:
        # T after chunk 0 = 0.05 * 0.001 <= 1e-4 at every pixel: chunk 1's
        # first pair is the first one gated out
        op = np.full(4 * kc, 0.5)
        op[:kc - 1] = 1.0 - 0.05 ** (1.0 / (kc - 1))
        op[kc - 1] = 0.999
        pairs, seg, grid = one_tile(cuda_device, op)
    _, _, nc = check_passes(pairs, seg, grid, 3, kc)
    count = int(seg[1])
    if case == "never_saturates":
        assert bool((nc == count).all())
    elif case == "saturates_mid_chunk":
        assert kc < int(nc.min()) and int(nc.max()) < count and bool((nc % kc != 0).any())
    else:
        assert bool((nc == kc).all())


def test_k1_is_the_same_bit_for_bit_from_run_to_run(cuda_device):
    pairs, bins, grid = binned(cuda_device, 3, 16, saturated=True)
    chunks = rp.chunk_list(bins.seg_start, pairs.shape[0], 32)
    runs = []
    for _ in range(2):
        prod = rp.chunk_products(pairs, bins.seg_start, grid, 3, chunks)
        runs.append((prod, *rp.composite_fwd(pairs, bins.seg_start, grid, 3, chunks, prod)))
    torch.cuda.synchronize()
    assert int(chunks.tile_chunk_start[-1]) > grid.num_tiles  # some tile holds several chunks
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_rasterize_gradients_card_vs_cpu(cuda_device):
    """The whole differentiable rasterizer on the card (K1, K2, K3) against
    the CPU path (plain versions). The two devices round the projection and
    exp differently, so pixels at the T = 1e-4 cutoff flip: the rule of
    test_rasterize_pallas.py:127-132 applies (< 3% of entries off by more
    than 5e-3 + 5e-3 |g|, cosine > 0.999)."""
    arrays = scene("cpu", num=200)
    tgt = torch.rand((HEIGHT, WIDTH, 3), generator=torch.Generator().manual_seed(5))
    grads = []
    for dev in ("cpu", cuda_device):
        means, quats, scales, opacities, colors, vm, K = [a.to(dev) for a in arrays]
        leaves = [x.clone().requires_grad_() for x in (means, scales, opacities, colors)]
        r, a, _ = rasterize(leaves[0], quats, leaves[1], leaves[2], leaves[3], vm, K,
                            WIDTH, HEIGHT, rasterize_mode="antialiased")
        (((r - tgt.to(dev)) ** 2).sum() + (a * 0.3).sum()).backward()
        grads.append([n(x.grad) for x in leaves])
    for gc, gg in zip(*grads):
        assert np.isfinite(gg).all()
        assert (np.abs(gg - gc) > 5e-3 + 5e-3 * np.abs(gc)).mean() < 0.03
        cos = (gg * gc).sum() / (np.linalg.norm(gg) * np.linalg.norm(gc) + 1e-12)
        assert cos > 0.999, cos


def test_cuda_tensor_never_takes_the_plain_version(cuda_device):
    x = torch.randn((10, 3), device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError):
        cumsum_rows(x)  # f64 on the card: no kernel, so it raises
