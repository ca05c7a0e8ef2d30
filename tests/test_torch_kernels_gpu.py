"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker gpu; the ``cuda_device``
fixture skips without one). This file imports no JAX, so it also runs where
only PyTorch is installed:

    python -m pytest -m gpu --noconftest -o addopts="" tests/test_torch_kernels_gpu.py
"""
import math

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

from .test_torch_sdf_trace import SDFS
from .test_torch_sdf_trace import rays as trace_rays
from .torch_parity import cuda_device, n, one_torch_thread  # noqa: F401
from .torch_scenes import uv_sphere

pytestmark = pytest.mark.gpu

WIDTH, HEIGHT = 128, 96


def k3_close(got, x):
    """K3 and torch.cumsum sum in different orders: hold the difference to
    1e-5 of the running |prefix| (plus 1e-6 absolute)."""
    want = torch.cumsum(x.double(), 0)
    scale = torch.cumsum(x.abs().double(), 0)
    err = (got.double() - want).abs()
    assert bool((err <= 1e-5 * scale + 1e-6).all()), float((err / (scale + 1e-6)).max())


# (4M, 10): some 4,900 tiles of 824 rows, more than the CTAs resident at
# once; (1_400_001, 10) ends in a partial tile; (5000, 33) takes more than
# 48 KB of shared memory
@pytest.mark.parametrize("m,c", [(7, 3), (1000, 17), (5000, 1), (4097, 256), (300_000, 10),
                                 (4_000_000, 10), (1_400_001, 10), (5000, 33), (70_000, 256)])
def test_k3_matches_cumsum(cuda_device, m, c):
    x = torch.randn((m, c), generator=torch.Generator().manual_seed(m), dtype=torch.float32)
    x = x.to(cuda_device)
    before = _kernels.launches["k3_cumsum_rows"]
    got = cumsum_rows(x)
    torch.cuda.synchronize()
    assert _kernels.launches["k3_cumsum_rows"] == before + 1
    k3_close(got, x)
    k3_close(cumsum_rows_plain(x), x)


def test_k3_back_to_back_on_one_stream(cuda_device):
    """The tiles' flags and the tile counter are zeroed before every launch:
    calls queued without a synchronisation are all right, and, since each
    tile sums its carry in a fixed order, a repeated call gives the same
    bits."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn((900_000, 10), generator=g).to(cuda_device)
    y = torch.randn((900_000, 10), generator=g).to(cuda_device)
    a = cumsum_rows(x)
    b = cumsum_rows(y)
    again = cumsum_rows(x)
    torch.cuda.synchronize()
    k3_close(a, x)
    k3_close(b, y)
    assert torch.equal(a, again)


def test_k3_on_an_unaligned_view(cuda_device):
    """A contiguous view that starts 40 bytes into its storage is not 16-byte
    aligned: the kernel stages it with 4-byte loads."""
    base = torch.randn((100_001, 10), generator=torch.Generator().manual_seed(12))
    x = base.to(cuda_device)[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = cumsum_rows(x)
    torch.cuda.synchronize()
    k3_close(got, x)


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


# --- K4, the SDF sphere trace --------------------------------------------------------


@pytest.mark.parametrize("kind,steps,r,scale", [
    ("sphere", 24, 96, 0.8), ("sphere", 8, 96, 0.8), ("noisy", 24, 96, 0.8),
    ("noisy", 8, 96, 0.8), ("noisy", 24, 128, 1.05)])
def test_sdf_trace_matches_plain(cuda_device, monkeypatch, kind, steps, r, scale):
    """K4 against the plain march on the card at a stage-2 batch: 2^23 rays,
    grid 96, scale 0.8 (the benchmark cells' trace), and the Shiny Blender
    preset's grid 128, scale 1.05. K4 rounds as the plain version does on
    the card, operation by operation (bit-equal when measured); the stated
    tolerance, max |dv| <= 1e-4 and mean <= 1e-7, leaves room for another
    PyTorch's order of summation. The live ray-steps, counted on every ray,
    are the plain recount's; the issued lane-steps lie between them and a
    full march's."""
    from geosplatting_tpu_torch import counters
    from geosplatting_tpu_torch.ops import sdf_visibility as sv

    rays = 1 << 23
    sdf = SDFS[kind](r, scale, device=cuda_device)
    origins, dirs = trace_rays(rays, cuda_device)
    monkeypatch.setattr(sv, "LIVE_STRIDE", 1)
    counts = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for make in (sv.make_sdf_visibility, sv.make_sdf_visibility_plain):
            counters.reset()
            before = _kernels.launches["sdf_trace"]
            out = make(sdf, (r,) * 3, scale, num_steps=steps)(origins, dirs)
            counts.append((counters.totals(), _kernels.launches["sdf_trace"] - before, out))
    counters.reset()
    (kern, launched, got), (plain, plain_launched, want) = counts
    assert (launched, plain_launched) == (1, 0)
    diff = (got - want).abs()
    assert float(diff.max()) <= 1e-4 and float(diff.mean()) <= 1e-7, (diff.max(), diff.mean())
    assert kern["sdf_trace.ray_steps"] == plain["sdf_trace.ray_steps"] == rays * steps
    assert kern["sdf_trace.live_ray_steps"] == plain["sdf_trace.live_ray_steps"]
    assert kern["sdf_trace.live_ray_steps"] <= kern["sdf_trace.issued_ray_steps"] \
        <= kern["sdf_trace.ray_steps"]
    assert bool(((got >= 0) & (got <= 1)).all())


def test_sdf_trace_one_launch_a_call_and_what_it_refuses(cuda_device):
    from geosplatting_tpu_torch.ops.sdf_visibility import make_sdf_visibility

    r = 8
    sdf = SDFS["sphere"](r, device=cuda_device)
    vis = make_sdf_visibility(sdf, (r,) * 3, 0.8)
    origins, dirs = trace_rays(1000, cuda_device)
    before = _kernels.launches["sdf_trace"]
    got = vis(origins.reshape(10, 100, 3), dirs.reshape(10, 100, 3))
    vis(origins, dirs)
    assert got.shape == (10, 100) and _kernels.launches["sdf_trace"] == before + 2
    for o, d in ((origins.double(), dirs.double()),               # another dtype
                 (origins.t().contiguous().t(), dirs),            # not contiguous
                 (origins, dirs[:, :1].expand(-1, 3)),            # a stride-0 view
                 (origins.cpu(), dirs.cpu()),                     # not on the card
                 (origins, dirs[:500])):                          # shapes differ
        with pytest.raises(ValueError):
            vis(o, d)
    with pytest.raises(ValueError):
        make_sdf_visibility(sdf.double(), (r,) * 3, 0.8)
    assert _kernels.launches["sdf_trace"] == before + 2


# --- K5, the Monte-Carlo shading loop ----------------------------------------------


def k5_and_plain(operands, smp, ups, bsdf):
    """(outputs, gradients of the six operands) of K5 and of the plain loop
    from the same operands and upstream gradients, and K5's launches."""
    from geosplatting_tpu_torch.ops import envshade as es

    res = []
    for shade in (es.mc_shade, lambda *a: es.mc_shade_plain(*a)[0]):
        leaves = [x.detach().requires_grad_() for x in operands]
        before = (_kernels.launches["mc_shade_fwd"], _kernels.launches["mc_shade_bwd"])
        out = shade(*leaves, smp, bsdf)
        sum((o * u).sum() for o, u in zip(out, ups)).backward()
        torch.cuda.synchronize()
        launched = (_kernels.launches["mc_shade_fwd"] - before[0],
                    _kernels.launches["mc_shade_bwd"] - before[1])
        res.append(([o.detach() for o in out], [x.grad for x in leaves], launched))
    return res


@pytest.mark.parametrize("bsdf", ["pbr", "diffuse", "white"])
@pytest.mark.parametrize("shape,n,live,steps,bank", [
    ("stage2", 6 * 8192, 0.42, 64, 2048), ("stage3", 200 * 200, 0.126, 64, 2048),
    ("prior", 30_000, 1.0, 16, 2048), ("bank_past_smem", 8192, 1.0, 4, 20_000)])
def test_mc_shade_matches_the_plain_loop(cuda_device, shape, n, live, steps, bank, bsdf):
    """K5 against the plain loop on the card, at stage 2's and stage 3's
    shapes scaled down (their shares of rows with a gradient), the prior's
    16 steps, and a bank of 19,881 directions whose gradient (238 KB) takes
    global atomics: the forward bit for bit, each gradient within
    chip_smoke.TOL_K5_GRAD of its largest magnitude (the two sum in other
    orders). The rows include back-facing points, roughness at and under
    its clamp and wo = n; the white lobe gives kd, arm and wo no gradient."""
    from chip_smoke import TOL_K5_GRAD, mc_shade_gaps, mc_shade_inputs

    gen = torch.Generator(cuda_device).manual_seed(n + steps)
    operands, smp, ups = mc_shade_inputs(cuda_device, gen, n, steps, live, light_hw=(64, 128),
                                         light_bank=bank)
    (out, grads, launched), (want, want_grads, plain_launched) = k5_and_plain(
        operands, smp, ups, bsdf)
    assert launched == (1, 1) and plain_launched == (0, 0)
    for name, a, b in zip(("diffuse", "specular", "residual"), out, want):
        assert torch.equal(a, b), (name, mc_shade_gaps(a, b))
    assert float(want[2].max()) > 1e-3  # shadowed samples reach the residual
    for name, a, b in zip(("kd", "arm", "normals", "wo", "bank_cols", "light_rows"), grads,
                          want_grads):
        if bsdf != "pbr" and name in ("kd", "arm", "wo"):
            assert a is None and b is None, name
            continue
        gap = mc_shade_gaps(a, b)
        assert bool(torch.isfinite(a).all()) and gap["max_rel_gap"] <= TOL_K5_GRAD, (name, gap)
        if name in ("kd", "arm", "normals", "wo"):
            assert bool((a[int(n * live):] == 0).all()), name  # rows with no upstream gradient


def test_env_shade_launches_k5_once_each_way(cuda_device):
    """One forward launch per env_shade call on the card, one backward launch
    per call that gets gradients, none under no_grad; the no_grad forward
    gives the same bits."""
    from geosplatting_tpu_torch.ops import envshade as es

    gen = torch.Generator(cuda_device).manual_seed(5)
    n = 4096
    pos = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=gen, device=cuda_device), dim=-1) * 0.4
    nrm = torch.nn.functional.normalize(pos + 0.3, dim=-1)
    kd = torch.rand((n, 3), generator=gen, device=cuda_device)
    arm = torch.rand((n, 3), generator=gen, device=cuda_device)
    table = 0.2 + torch.rand((32, 64, 3), generator=gen, device=cuda_device)
    draws = es.draw_shade(n, num_samples_x=4, generator=gen, device=cuda_device)
    view = torch.tensor([0.3, 0.6, 2.8], device=cuda_device)
    before = (_kernels.launches["mc_shade_fwd"], _kernels.launches["mc_shade_bwd"])
    leaves = [x.clone().requires_grad_() for x in (pos, nrm, kd, arm, table)]
    out = es.env_shade(leaves[0], leaves[1], view, leaves[2], leaves[3],
                       es.compute_light_pdf(leaves[4]), draws)
    sum(o.sum() for o in out).backward()
    with torch.no_grad():
        again = es.env_shade(pos, nrm, view, kd, arm, es.compute_light_pdf(table), draws)
    # a non-contiguous kd (stage 3 reads it from its G-buffer) is made contiguous first
    wide = torch.cat((kd, arm), -1)
    sliced = es.env_shade(pos, nrm, view, wide[:, :3], arm, es.compute_light_pdf(table), draws)
    torch.cuda.synchronize()
    assert (_kernels.launches["mc_shade_fwd"] - before[0],
            _kernels.launches["mc_shade_bwd"] - before[1]) == (3, 1)
    for a, b, c in zip(out, again, sliced):
        assert torch.equal(a.detach(), b) and torch.equal(b, c)
    assert all(bool(torch.isfinite(x.grad).all()) for x in leaves)


def test_mc_shade_refuses_what_it_cannot_take(cuda_device):
    """A CUDA tensor never takes the plain loop: K5 raises for a
    non-contiguous operand, another dtype, a tensor on the CPU or an unknown
    lobe, and launches nothing."""
    from chip_smoke import mc_shade_inputs
    from geosplatting_tpu_torch.ops import envshade as es

    gen = torch.Generator(cuda_device).manual_seed(9)
    operands, smp, _ = mc_shade_inputs(cuda_device, gen, 1024, 4, 1.0, light_hw=(16, 32))
    kd = operands[0]
    before = (_kernels.launches["mc_shade_fwd"], _kernels.launches["mc_shade_bwd"])
    for bad in (kd.t().contiguous().t(), kd.double(), kd.cpu(), kd[:, :1].expand(-1, 3)):
        with pytest.raises(ValueError):
            es.mc_shade(bad, *operands[1:], smp)
    with pytest.raises(ValueError):
        es.mc_shade(*operands, smp._replace(bidx=smp.bidx.int()))
    with pytest.raises(ValueError):
        es.mc_shade(*operands, smp, "glossy")
    with pytest.raises(ValueError):
        es.mc_shade(*[x.double() for x in operands], smp)
    assert (_kernels.launches["mc_shade_fwd"], _kernels.launches["mc_shade_bwd"]) == before


# --- stage 2 on the card against the CPU path -------------------------------------


def close_card_cpu(got, want):
    """The rule of test_rasterize_gradients_card_vs_cpu: the two devices
    round differently (and a nearest-texel lookup or a transmittance cutoff
    may flip), so < 3% of entries off by more than 5e-3 + 5e-3 |x| and a
    cosine > 0.999."""
    assert np.isfinite(got).all()
    assert (np.abs(got - want) > 5e-3 + 5e-3 * np.abs(want)).mean() < 0.03
    got, want = got.astype(np.float64), want.astype(np.float64)
    cos = (got * want).sum() / max(np.linalg.norm(got) * np.linalg.norm(want), 1e-300)
    assert cos > 0.999, cos


def test_env_shade_card_vs_cpu(cuda_device):
    """env_shade with SDF shadows, values and gradients, from the same
    draws on both devices."""
    from geosplatting_tpu_torch.ops import envshade as es
    from geosplatting_tpu_torch.ops.sdf_visibility import make_sdf_visibility

    g = torch.Generator().manual_seed(0)
    num = 3000
    d = torch.nn.functional.normalize(torch.randn((num, 3), generator=g), dim=-1)
    pos = d * (0.36 + 0.2 * torch.rand((num, 1), generator=g))
    view = torch.tensor([0.3, 0.6, 2.8])
    nrm = torch.nn.functional.normalize(0.3 * d + torch.nn.functional.normalize(view - pos, dim=-1),
                                        dim=-1)
    kd = 0.2 + 0.6 * torch.rand((num, 3), generator=g)
    arm = torch.stack((torch.zeros(num), 0.3 + 0.6 * torch.rand(num, generator=g),
                       0.05 + 0.75 * torch.rand(num, generator=g)), -1)
    i, j = torch.meshgrid(torch.arange(32.0), torch.arange(64.0), indexing="ij")
    light = (0.3 + 0.2 * torch.sin(i / 10) * torch.cos(j / 9))[..., None] + torch.tensor(
        [0.0, 0.07, 0.14])
    r = torch.linspace(-1, 1, 17)
    z, y, x = torch.meshgrid(r, r, r, indexing="ij")
    sdf = (torch.sqrt(x * x + y * y + z * z) - 0.31).reshape(-1)
    draws = es.draw_shade(num, num_samples_x=4, generator=g)
    wts = [torch.randn(s, generator=g) for s in ((num, 3), (num, 3), (num, 2))]
    outs, grads = [], []
    for dev in ("cpu", cuda_device):
        leaves = [v.detach().to(dev).requires_grad_() for v in (pos, nrm, kd, arm, light)]
        vis = make_sdf_visibility(sdf.to(dev), (16, 16, 16), 1.0, num_steps=24)
        out = es.env_shade(leaves[0], leaves[1], view.to(dev), leaves[2], leaves[3],
                           es.compute_light_pdf(leaves[4]), draws.to(dev), visibility_fn=vis)
        sum((o * w.to(dev)).sum() for o, w in zip(out, wts)).backward()
        outs.append([n(o) for o in out])
        grads.append([n(v.grad) for v in leaves])
    assert outs[0][2].max() > 1e-3  # some samples are shadowed
    for got, want in zip(outs[1] + grads[1], outs[0] + grads[0]):
        close_card_cpu(got, want)


def test_stage2_step_card_vs_cpu(cuda_device):
    """One GeoSplatMCTrainer step at a small size on the card (kernels) and
    on the CPU (plain versions) from the same weights and draws."""
    from geosplatting_tpu_torch.models.geosplat import GeoSplatter
    from geosplatting_tpu_torch.models.geosplat_mc import GeoSplatterMC, export_stage1
    from geosplatting_tpu_torch.train.geosplat_mc_trainer import (
        GeoSplatMCTrainer, GeoSplatMCTrainerConfig,
    )

    gen = torch.Generator().manual_seed(0)
    s1 = GeoSplatter(resolution=12, light_resolution=16, scale=1.0, triplane_resolution=32,
                     generator=gen, device="cpu")
    with torch.no_grad():
        s1.sdf.copy_(torch.linalg.norm(s1.grid.base_vertices() - 0.03, dim=-1) - 0.45)
        s1.deform.copy_(torch.randn(s1.deform.shape, generator=gen) * 0.1)
        s1.weights.copy_(torch.randn(s1.weights.shape, generator=gen) * 0.1)
    export = export_stage1(s1)
    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.0, elevation_degrees=20.0,
                              num_samples=2, width=64, height=64, device="cpu")
    origins, dirs = cams.generate_rays()
    b = (origins * dirs).sum(-1)
    hit = (b * b - ((origins * origins).sum(-1) - 0.25) > 0)[..., None].float()
    gt = torch.cat((hit * 0.6 * torch.ones(3), hit), -1)
    kw = dict(resolution=12, scale=1.0, num_samples_x=2, max_render_faces=2048,
              triplane_resolution=32)
    model = GeoSplatterMC(generator=gen, device="cpu", **kw)
    model.init_from_stage1(export)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    bg = torch.rand(gt[..., :3].shape, generator=gen)
    noise = torch.randn((model.num_field_points(), 3), generator=gen)
    draws = [model.draw_shade(gen) for _ in range(2)]
    metrics, grads = [], []
    for dev in ("cpu", cuda_device):
        m = GeoSplatterMC(device=dev, **kw)
        m.load_state_dict(state)
        trainer = GeoSplatMCTrainer(GeoSplatMCTrainerConfig(batch_size=2), m)
        _kernels.reset_launches()
        out = trainer.train_step(cams.to(dev), gt.to(dev), 60.0, background=bg.to(dev),
                                 jitter_noise=noise.to(dev), draws=[d.to(dev) for d in draws])
        metrics.append({k: float(v) for k, v in out.items()})
        grads.append({k: n(p.grad) for k, p in m.named_parameters()})
    assert all(_kernels.launches[k] > 0 for k in _kernels.KERNELS)
    assert metrics[1]["nonfinite_grads"] == 0 and metrics[1]["num_gaussians"] > 0
    for k in ("loss", "reg", "pair_fill", "exposure"):
        np.testing.assert_allclose(metrics[1][k], metrics[0][k], rtol=1e-3, err_msg=k)
    for k, want in grads[0].items():
        close_card_cpu(grads[1][k], want)


def _stage2_model(cams_res=64):
    """A small stage-2 model on the CPU from a stage-1 export with an SDF
    sphere and random deform / weights, and two orbit cameras."""
    from geosplatting_tpu_torch.models.geosplat import GeoSplatter
    from geosplatting_tpu_torch.models.geosplat_mc import GeoSplatterMC, export_stage1

    gen = torch.Generator().manual_seed(0)
    s1 = GeoSplatter(resolution=12, light_resolution=16, scale=1.0, triplane_resolution=32,
                     generator=gen, device="cpu")
    with torch.no_grad():
        s1.sdf.copy_(torch.linalg.norm(s1.grid.base_vertices() - 0.03, dim=-1) - 0.45)
        s1.deform.copy_(torch.randn(s1.deform.shape, generator=gen) * 0.1)
        s1.weights.copy_(torch.randn(s1.weights.shape, generator=gen) * 0.1)
    model = GeoSplatterMC(resolution=12, scale=1.0, num_samples_x=2, max_render_faces=2048,
                          triplane_resolution=32, generator=gen, device="cpu")
    model.init_from_stage1(export_stage1(s1))
    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.0, elevation_degrees=20.0,
                              num_samples=2, width=cams_res, height=cams_res, device="cpu")
    return model, cams, gen


def test_mesh_raster_card_vs_cpu(cuda_device):
    """rasterize_mesh and interpolate of a stage-2 mesh on the card against
    the CPU: the same winners but at rounding ties, barycentrics to 1e-5."""
    from geosplatting_tpu_torch.graphics.mesh import TriangleMesh
    from geosplatting_tpu_torch.ops.mesh_raster import interpolate, rasterize_mesh

    model, cams, _ = _stage2_model(96)
    export = model.export_model()
    mesh = TriangleMesh(vertices=export["mc_vertices"], indices=export["mc_indices"].long(),
                        face_mask=export["mc_face_mask"])
    out = []
    for dev in ("cpu", cuda_device):
        m = TriangleMesh(vertices=mesh.vertices.to(dev), indices=mesh.indices.to(dev),
                         face_mask=mesh.face_mask.to(dev))
        rast, info = rasterize_mesh(m, cams[0].to(dev), tile_capacity=64)
        out.append((rast, info, interpolate(m.vertices, m, rast)))
    (r0, i0, p0), (r1, i1, p1) = out
    assert i0 == i1 and i1.tile_fill > 0
    same = n(r1.tri_id) == n(r0.tri_id)
    assert same.mean() > 0.995 and (n(r0.tri_id) >= 0).mean() > 0.1
    np.testing.assert_allclose(n(r1.bary)[same], n(r0.bary)[same], atol=1e-5)
    np.testing.assert_allclose(n(p1)[same], n(p0)[same], atol=1e-5)


def test_stage3_step_card_vs_cpu(cuda_device):
    """One GeoSplatDeferTrainer step (the 14-channel G-buffer and the kd map
    through K1-K3, the mesh raster, env_shade) at a small size on the card
    and on the CPU from the same weights and draws; then the relit render."""
    from geosplatting_tpu_torch.models.geosplat_defer import GeoSplatterDefer
    from geosplatting_tpu_torch.models.geosplat_mc import compact_export
    from geosplatting_tpu_torch.ops.envshade import draw_shade
    from geosplatting_tpu_torch.train.geosplat_defer_trainer import (
        GeoSplatDeferTrainer, GeoSplatDeferTrainerConfig,
    )

    model2, cams, gen = _stage2_model()
    export = compact_export(model2.export_model(), pad_to=256)
    kw = dict(num_gaussians=export["means"].shape[0], ks_resolution=32, resolution=12,
              scale=1.0, num_samples_x=2)
    origins, dirs = cams.generate_rays()
    b = (origins * dirs).sum(-1)
    hit = (b * b - ((origins * origins).sum(-1) - 0.25) > 0)[..., None].float()
    gt = torch.cat((hit * 0.6 * torch.ones(3), hit), -1)
    bg = torch.rand(gt[..., :3].shape, generator=gen)
    noise = torch.randn((kw["num_gaussians"], 3), generator=gen)
    env = 0.5 + torch.rand((8, 16, 3), generator=gen)
    shade = [draw_shade(64 * 64, num_samples_x=2, generator=gen) for _ in range(2)]
    metrics, grads, relit = [], [], []
    for dev in ("cpu", cuda_device):
        m = GeoSplatterDefer(device=dev, **kw)
        m.init_from_stage2(export)
        draws = [d.to(dev) for d in shade]
        trainer = GeoSplatDeferTrainer(GeoSplatDeferTrainerConfig(batch_size=2), m)
        _kernels.reset_launches()
        out = trainer.train_step(cams.to(dev), gt.to(dev), background=bg.to(dev),
                                 jitter_noise=noise.to(dev), draws=draws)
        metrics.append({k: float(v) for k, v in out.items()})
        grads.append({k: n(p.grad) for k, p in m.named_parameters()})
        with torch.no_grad():
            relit.append(n(m.render(cams.to(dev), relight_envmap=env.to(dev),
                                    albedo_scaling=torch.tensor([1.1, 0.9, 0.8], device=dev),
                                    draws=draws)[0]))
    assert all(_kernels.launches[k] > 0 for k in _kernels.KERNELS)
    assert metrics[1]["nonfinite_grads"] == 0 and metrics[1]["mesh_tile_fill"] <= 1
    for k in ("loss", "reg", "pair_fill", "exposure", "mesh_tile_fill"):
        np.testing.assert_allclose(metrics[1][k], metrics[0][k], rtol=1e-3, err_msg=k)
    for k, want in grads[0].items():
        close_card_cpu(grads[1][k], want)
    assert (np.abs(relit[1] - relit[0]) > 1e-3).mean() < 0.01


# --- vanilla 3DGS on the card ------------------------------------------------------


def test_k1_k2_k3_at_3dgs_density(cuda_device):
    """K1-K3 on bench.py's kind of input: free Gaussians of the 3-NN spacing
    of 50k points in the cube of half-width 0.8 (0.0316), opacity
    sigmoid(1), seen at 800x800 from radius 2.5: ~22 pairs a Gaussian, the
    central tiles several chunks long."""
    g = torch.Generator().manual_seed(11)
    num = 20_000
    means = (torch.rand((num, 3), generator=g) - 0.5) * 1.6
    quats = torch.nn.functional.normalize(torch.randn((num, 4), generator=g), dim=-1)
    scales = torch.full((num, 3), 0.0316)
    opacities = torch.full((num,), 1 / (1 + math.exp(-1.0)))
    colors = torch.rand((num, 3), generator=g)
    cam = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.5, elevation_degrees=15.0,
                             num_samples=1, width=800, height=800, device="cpu")[0]
    means, quats, scales, opacities, colors = (x.to(cuda_device) for x in (
        means, quats, scales, opacities, colors))
    proj = project(means, quats, scales, opacities, cam.view_matrix.to(cuda_device),
                   cam.intrinsic_matrix.to(cuda_device), 800, 800)
    grid = rp.tile_grid(800, 800, 16)
    bins = rp.bin_pairs(proj, 800, 800, tile_size=(grid.tsx, grid.tsy), max_pairs=32 * num)
    total = int(bins.total_pairs)
    assert 18 * num < total <= 32 * num, total / num
    pairs = rp.pack_pairs(bins, proj.means2d, proj.conics, proj.opacities, colors, proj.depths)
    counts = bins.seg_start[1:] - bins.seg_start[:-1]
    assert int(counts.max()) > rp.CHUNK_PAIRS        # a tile past a chunk boundary
    check_passes(pairs, bins.seg_start, grid, 3, rp.CHUNK_PAIRS)
    rows = torch.randn((total, rp.HDR + 3), generator=g).to(cuda_device)
    k3_close(cumsum_rows(rows), rows)


@pytest.mark.parametrize("budget", [None, 1_000_000], ids=["fits", "overflows"])
def test_batched_binning_matches_per_camera_on_card(cuda_device, budget):
    """bin_cameras_batched at 8 x 800x800 (bench.py's 50k random Gaussians
    at random opacities in [0.3, 0.9], ~40 pairs a Gaussian on 16x8 tiles,
    a budget of 48) against bin_pairs of each camera alone on the card:
    every field of each camera's PairBins equal, also where a budget of 1M
    pairs makes every camera drop its farthest Gaussians."""
    from geosplatting_tpu_torch.graphics.splats import Splats
    from geosplatting_tpu_torch.ops import rasterize as rz

    g = torch.Generator().manual_seed(12)
    splats = Splats.random(50_000, sh_degree=0, random_scale=0.8, generator=g, device="cpu")
    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.5, elevation_degrees=15.0,
                              num_samples=8, width=800, height=800, device=cuda_device)
    means, quats, scales = (x.to(cuda_device) for x in (
        splats.means, torch.nn.functional.normalize(splats.quats, dim=-1),
        torch.exp(splats.scales)))
    opac = torch.rand((8, 50_000), generator=g).to(cuda_device) * 0.6 + 0.3
    vm, ks = rz.camera_matrices(cams)
    proj_b, bins_b, max_pairs = rz.bin_cameras_batched(
        means, quats, scales, opac, vm, ks, 800, 800, tile_size=(16, 8), pairs_per_gaussian=48,
        max_pairs_override=budget)
    totals = bins_b.total_pairs
    assert (totals > max_pairs).all() if budget else (totals <= max_pairs).all()
    for i in range(8):
        alone = rp.bin_pairs(rp.camera_slice(proj_b, i), 800, 800, tile_size=(16, 8),
                             max_pairs=max_pairs)
        for field, got in zip(rp.PairBins._fields, rp.camera_slice(bins_b, i)):
            assert torch.equal(got, getattr(alone, field)), (i, field)


def test_gsplat_step_card_vs_cpu(cuda_device):
    """One GSplatTrainer step at SH degree 3 (2 cameras at 64x64, 2,000
    Gaussians) on the card and on the CPU from the same state: the loss, the
    gradients, the densification statistics; then a densification on the
    card and a finite next step."""
    from geosplatting_tpu_torch.graphics.splats import Splats
    from geosplatting_tpu_torch.models.gsplatter import GSplatter
    from geosplatting_tpu_torch.train.gsplat_trainer import GSplatTrainer, GSplatTrainerConfig

    g = torch.Generator().manual_seed(2)
    splats = Splats.random(2000, sh_degree=3, random_scale=0.8, generator=g, device="cpu")
    # anisotropic, so that the rotations have a gradient
    splats = splats.replace(shs=torch.randn(splats.shs.shape, generator=g) * 0.1,
                            scales=splats.scales + torch.randn((2000, 3), generator=g) * 0.4,
                            colors=torch.rand((2000, 3), generator=g),
                            opacities=torch.full_like(splats.opacities, 1.0))
    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.5, elevation_degrees=15.0,
                              num_samples=2, width=64, height=64, device="cpu")
    gt = torch.rand((2, 64, 64, 4), generator=g)
    cfg = GSplatTrainerConfig(batch_size=2, warmup_length=1, refine_every=2,
                              reset_alpha_every=10, densify_grad_thresh=1e-6)
    out = []
    for dev in ("cpu", cuda_device):
        trainer = GSplatTrainer(cfg, GSplatter(background_color="random", device=dev), 2)
        trainer.init_state(Splats(**{k: getattr(splats, k).to(dev) for k in (
            "means", "scales", "quats", "colors", "opacities", "shs")}))
        _kernels.reset_launches()
        m = trainer.train_step(cams.to(dev), gt.to(dev), max_sh_degree=3,
                               background=torch.tensor([0.2, 0.5, 0.7], device=dev))
        out.append((trainer, {k: float(v) for k, v in m.items()},
                    {k: n(p.grad) for k, p in trainer.params.items() if p.grad is not None}))
    assert all(_kernels.launches[k] == 2 for k in _kernels.RASTER_KERNELS)
    (_, m_cpu, g_cpu), (trainer, m_gpu, g_gpu) = out
    assert m_gpu["nonfinite_grads"] == 0 and m_gpu["pair_fill"] <= 1
    for k in ("loss", "psnr", "pair_fill"):
        np.testing.assert_allclose(m_gpu[k], m_cpu[k], rtol=1e-3, err_msg=k)
    for k, want in g_cpu.items():
        close_card_cpu(g_gpu[k], want)
    close_card_cpu(n(trainer.xys_grad_norm), n(out[0][0].xys_grad_norm))
    np.testing.assert_array_equal(n(trainer.vis_counts), n(out[0][0].vis_counts))
    info = trainer.after_update(6, (64, 64), generator=torch.Generator(cuda_device))
    assert info["param_map"] is not None
    assert trainer.params["means"].shape[0] == info["param_map"].shape[0] != 2000
    m = trainer.train_step(cams.to(cuda_device), gt.to(cuda_device), max_sh_degree=3)
    assert np.isfinite(float(m["loss"])) and int(m["nonfinite_grads"]) == 0


# --- the mesh prior and the hash field on the card --------------------------------


def test_k1_k2_k3_at_prior_density(cuda_device):
    """K1-K3 on the prior's kind of input: the MGAdapter Gaussians of a
    150 x 140 UV sphere (252,000 flat Gaussians, opacity 0.99) at 800x800
    from radius 2: ~2 pairs a Gaussian, every tile's pairs saturating
    within its first chunk."""
    from geosplatting_tpu_torch.graphics import gmath
    from geosplatting_tpu_torch.models.geosplat import MGAdapter

    with torch.no_grad():
        splats, offsets, _ = MGAdapter().make(uv_sphere(150, 140, device=cuda_device))
    num = splats.means.shape[0]
    cam = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.0, elevation_degrees=20.0,
                             num_samples=1, width=800, height=800, device="cpu")[0]
    proj = project(splats.means - offsets * 0.5, gmath.safe_normalize(splats.quats),
                   torch.exp(splats.scales), torch.sigmoid(splats.opacities[:, 0]),
                   cam.view_matrix.to(cuda_device), cam.intrinsic_matrix.to(cuda_device),
                   800, 800, rasterize_mode="antialiased")
    grid = rp.tile_grid(800, 800, 16)
    bins = rp.bin_pairs(proj, 800, 800, tile_size=(grid.tsx, grid.tsy), max_pairs=6 * num)
    total = int(bins.total_pairs)
    assert num < total <= 6 * num, total / num
    colors = torch.rand((num, 3), generator=torch.Generator().manual_seed(4)).to(cuda_device)
    pairs = rp.pack_pairs(bins, proj.means2d, proj.conics, proj.opacities, colors, proj.depths)
    check_passes(pairs, bins.seg_start, grid, 3, rp.CHUNK_PAIRS)
    rows = torch.randn((total, rp.HDR + 3), generator=torch.Generator().manual_seed(5))
    rows = rows.to(cuda_device)
    k3_close(cumsum_rows(rows), rows)


def test_hashgrid_card_vs_cpu(cuda_device):
    """The hash encoding at the field's default widths (16 levels of 2^18
    rows), values and the index_add_ gradients of the table and the points,
    on the card against the CPU; the coarse levels put thousands of points
    on one row."""
    from geosplatting_tpu_torch.ops.hashgrid import HashGridConfig, hashgrid_encode

    cfg = HashGridConfig(max_res=4096, log2_hashmap_size=18, grad_scaling=16.0)
    g = torch.Generator().manual_seed(6)
    table = cfg.init(g)
    x = torch.rand((50_000, 3), generator=g) * 2 - 1
    w = torch.randn((50_000, cfg.output_dim), generator=g)
    outs = []
    for dev in ("cpu", cuda_device):
        tb, xx = (v.detach().to(dev).requires_grad_() for v in (table, x))
        out = hashgrid_encode(tb, xx, cfg)
        (out * w.to(dev)).sum().backward()
        outs.append([n(out), n(tb.grad), n(xx.grad)])
    np.testing.assert_allclose(outs[1][0], outs[0][0], atol=1e-6)
    for got, want in zip(outs[1][1:], outs[0][1:]):
        close_card_cpu(got, want)


@pytest.mark.parametrize("field", ["shared", "hash"])
def test_prior_step_card_vs_cpu(cuda_device, field):
    """One GeoSplatPriorTrainer step (a 12 x 14 UV sphere, 2 cameras at
    64x64, 2 x 2 sample steps with the 16^3 occupancy-grid shadows) on the
    card and on the CPU from the same weights and draws: the loss, reg and
    every parameter's gradient."""
    from geosplatting_tpu_torch.models.geosplat import GaussianField
    from geosplatting_tpu_torch.models.geosplat_mc import OCC_ENC
    from geosplatting_tpu_torch.models.geosplat_prior import GeoSplatterPrior
    from geosplatting_tpu_torch.train.geosplat_prior_trainer import (
        GeoSplatPriorTrainer, GeoSplatPriorTrainerConfig,
    )

    g = torch.Generator().manual_seed(7)
    mesh = uv_sphere(12, 14)
    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.0, elevation_degrees=20.0,
                              num_samples=2, width=64, height=64, device="cpu")
    gt = torch.rand((2, 64, 64, 4), generator=g)
    f = GaussianField(occ_enc=OCC_ENC, generator=g, device="cpu") if field == "hash" else None
    ref = GeoSplatterPrior(mesh, scale=1.0, num_samples_x=2, visibility_resolution=16,
                           triplane_resolution=32, field=f, generator=g, device="cpu")
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    bg = torch.rand((2, 64, 64, 3), generator=g)
    jitter = torch.randn(ref.field.jitter_shape(ref.num_faces), generator=g)
    surface = ref.draw_visibility(g)
    draws = [ref.draw_shade(g) for _ in range(2)]
    out = []
    for dev in ("cpu", cuda_device):
        fd = GaussianField(occ_enc=OCC_ENC, device=dev) if field == "hash" else None
        m = GeoSplatterPrior(mesh, scale=1.0, num_samples_x=2, visibility_resolution=16,
                             triplane_resolution=32, field=fd, device=dev)
        m.load_state_dict(state)
        trainer = GeoSplatPriorTrainer(GeoSplatPriorTrainerConfig(batch_size=2), m)
        _kernels.reset_launches()
        (loss, reg), _ = trainer.compute_grads(
            cams.to(dev), gt.to(dev), background=bg.to(dev), jitter_noise=jitter.to(dev),
            surface_draws=tuple(x.to(dev) for x in surface), draws=[d.to(dev) for d in draws])
        out.append((float(loss), float(reg), {k: n(p.grad) for k, p in m.named_parameters()}))
    assert all(_kernels.launches[k] == 2 for k in _kernels.RASTER_KERNELS)
    (l_cpu, r_cpu, g_cpu), (l_gpu, r_gpu, g_gpu) = out
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-3)
    np.testing.assert_allclose(r_gpu, r_cpu, rtol=1e-4)
    for k, want in g_cpu.items():
        if np.abs(want).max() > 0:
            close_card_cpu(g_gpu[k], want)


# --- 2DGS and the depth render modes on the card -----------------------------------


def test_2dgs_step_card_vs_cpu(cuda_device):
    """One 2DGS train step with both regularisers on the card and on the
    CPU from the same state (chip_smoke.check_2dgs_card_vs_cpu: the metrics
    within 1e-3, every gradient by the close_card_cpu rule)."""
    from chip_smoke import check_2dgs_card_vs_cpu

    check_2dgs_card_vs_cpu(cuda_device, 0)


def test_depth_render_kernels_match_plain(cuda_device, monkeypatch):
    """A differentiated ED render on the card: K1, K2 and K3 launch once
    each, K2's gradient carries a non-zero depth row, each K1 / K2 pass
    agrees with its plain version at those inputs, and the gradients agree
    with the CPU path's."""
    means, quats, scales, opacities, colors, vm, K = scene("cpu", num=300)
    w = torch.rand((HEIGHT, WIDTH, 1), generator=torch.Generator().manual_seed(4))
    recorded = []
    composite_bwd = rp.composite_bwd
    monkeypatch.setattr(rp, "composite_bwd",
                        lambda *a: recorded.append(a) or composite_bwd(*a))
    grads = []
    for dev in ("cpu", cuda_device):
        leaves = [x.to(dev).clone().requires_grad_() for x in (means, scales, opacities)]
        _kernels.reset_launches()
        r, a, _ = rasterize(leaves[0], quats.to(dev), leaves[1], leaves[2], colors.to(dev),
                            vm.to(dev), K.to(dev), WIDTH, HEIGHT, render_mode="ED")
        (r * w.to(dev) * (a > 0.5)).sum().backward()
        grads.append([n(x.grad) for x in leaves])
    torch.cuda.synchronize()
    assert all(_kernels.launches[k] == 1 for k in _kernels.RASTER_KERNELS)
    pairs, seg_start, grid, channels, g = recorded[-1][:5]
    assert g.is_cuda and float(g[:, channels].abs().max()) > 0
    chunks = rp.chunk_list(seg_start, pairs.shape[0])
    prod = rp.chunk_products(pairs, seg_start, grid, channels, chunks)
    out, tf, nc = rp.composite_fwd(pairs, seg_start, grid, channels, chunks, prod)
    np.testing.assert_allclose(n(out), n(rp.composite_fwd_plain(pairs, seg_start, grid,
                                                                channels)[0]), atol=1e-3)
    suffix = rp.chunk_suffix(pairs, seg_start, grid, channels, chunks, prod, g, nc)
    d = rp.composite_bwd(pairs, seg_start, grid, channels, g, tf, nc, pairs.shape[0], chunks,
                         prod, suffix)
    d_p = rp.composite_bwd_plain(pairs, seg_start, grid, channels, g, tf, nc, pairs.shape[0])
    assert float(d_p[:, 6].abs().max()) > 0          # the depth column's gradient
    np.testing.assert_allclose(n(d), n(d_p), atol=2e-3 * float(d_p.abs().max()), rtol=2e-3)
    for gc, gg in zip(*grads):
        close_card_cpu(gg, gc)
