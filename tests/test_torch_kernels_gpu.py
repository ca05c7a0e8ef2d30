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


@pytest.mark.parametrize("channels,tile,saturated", [
    (3, 16, False), (3, (16, 8), False), (14, 16, False), (3, 16, True),
])
def test_k1_k2_match_plain(cuda_device, channels, tile, saturated):
    pairs, bins, grid = binned(cuda_device, channels, tile, saturated=saturated)
    before = dict(_kernels.launches)
    out, tf, nc = rp.composite_fwd(pairs, bins.seg_start, grid, channels)
    out_p, tf_p, nc_p = rp.composite_fwd_plain(pairs, bins.seg_start, grid, channels)
    torch.cuda.synchronize()
    # the plain version's cumprod runs as a parallel scan on the card, so a
    # pixel at the T = 1e-4 cutoff may flip (tests/test_rasterize_pallas.py:53)
    np.testing.assert_allclose(n(out), n(out_p), atol=1e-3)
    assert float((nc != nc_p).float().mean()) < 0.01
    g = torch.rand(out.shape, device=cuda_device)
    # feed both backwards the kernel's saved state, so the rank gates agree
    d = rp.composite_bwd(pairs, bins.seg_start, grid, channels, g, tf, nc, pairs.shape[0])
    d_p = rp.composite_bwd_plain(pairs, bins.seg_start, grid, channels, g, tf, nc,
                                 pairs.shape[0])
    torch.cuda.synchronize()
    np.testing.assert_allclose(n(d), n(d_p), atol=2e-3, rtol=2e-3)
    assert _kernels.launches["k1_composite_fwd"] == before.get("k1_composite_fwd", 0) + 1
    assert _kernels.launches["k2_composite_bwd"] == before.get("k2_composite_bwd", 0) + 1


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
