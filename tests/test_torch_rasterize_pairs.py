"""Port parity: pair binning and the compositing kernels' plain versions (K1
forward, K2 backward) against the JAX pairs backend in interpret mode, as
tests/test_rasterize_pallas.py runs it; plus the kernels against their plain
versions on the card live in test_torch_kernels_gpu.py.

Tolerances are the JAX package's own between its two rasterizer backends
(tests/test_rasterize_pallas.py:53,77,127-132): the port composites
sequentially while JAX reassociates the transmittance scan, so a weight at
the T = 1e-4 cutoff can flip."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics.cameras import Cameras as JCameras
from geosplatting_tpu.ops import rasterize_pairs as jrp
from geosplatting_tpu.ops.projection import project as jproject
from geosplatting_tpu.ops.rasterize import rasterize as jrasterize
from geosplatting_tpu_torch import _kernels
from geosplatting_tpu_torch.ops import rasterize_pairs as rp
from geosplatting_tpu_torch.ops.projection import project
from geosplatting_tpu_torch.ops.rasterize import rasterize

from .torch_parity import n, one_torch_thread, t  # noqa: F401

WIDTH, HEIGHT = 64, 48


def scene(seed, num=300, channels=3):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, (num, 3)).astype(np.float32)
    q = rng.normal(size=(num, 4)).astype(np.float32)
    quats = q / np.linalg.norm(q, axis=-1, keepdims=True)
    scales = np.exp(rng.uniform(-4.5, -2.0, (num, 3))).astype(np.float32)
    opacities = rng.uniform(0.3, 0.95, (num,)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (num, channels)).astype(np.float32)
    return means, quats, scales, opacities, colors


def cam():
    c = JCameras.from_lookat(jnp.array([2.0, 1.0, 1.5]), jnp.zeros(3),
                             fov_degrees=60.0, width=WIDTH, height=HEIGHT)
    return np.asarray(c.view_matrix), np.asarray(c.intrinsic_matrix)


def both(fn_j, fn_t, arrays):
    return fn_j(*[jnp.asarray(a) for a in arrays]), fn_t(*[t(a) for a in arrays])


@pytest.fixture(autouse=True)
def jax_pairs_interpret():
    old = jrp._INTERPRET
    jrp._INTERPRET = True
    yield
    jrp._INTERPRET = old


@pytest.mark.parametrize("tile", [16, (16, 8)])
@pytest.mark.parametrize("max_pairs", [4096, 300])
def test_bin_pairs_pair_sets_match(tile, max_pairs):
    """Same per-tile pair multisets, pair totals and per-gaussian slot runs,
    including the depth-priority drop when the budget overflows."""
    vm, K = cam()
    means, quats, scales, opacities, _ = scene(0)
    pt = project(*(t(a) for a in (means, quats, scales, opacities, vm, K)),
                 WIDTH, HEIGHT, rasterize_mode="antialiased")

    def bin_j(*a):
        pj = jproject(*a, WIDTH, HEIGHT, rasterize_mode="antialiased")
        return jrp.bin_pairs(pj, WIDTH, HEIGHT, tile_size=tile, max_pairs=max_pairs,
                             chunk_size=128)

    bj = jax.jit(bin_j)(*(jnp.asarray(a) for a in (means, quats, scales, opacities, vm, K)))
    bt = rp.bin_pairs(pt, WIDTH, HEIGHT, tile_size=tile, max_pairs=max_pairs)
    assert int(bj.total_pairs) == int(bt.total_pairs)
    if max_pairs == 300:
        assert int(bt.total_pairs) > max_pairs  # the overflow path ran
    np.testing.assert_array_equal(n(bj.gs_count), n(bt.gs_count))
    np.testing.assert_array_equal(n(bj.gs_start), n(bt.gs_start))
    np.testing.assert_array_equal(n(bj.gs_inv), n(bt.gs_inv))
    counts_j = n(bj.tile_counts)
    seg = n(bt.seg_start)
    np.testing.assert_array_equal(counts_j, np.diff(seg))
    gid_j, gid_t = n(bj.sorted_gid), n(bt.sorted_gid)
    start = 0
    for tile_i, cnt in enumerate(counts_j):
        # lax.sort is not stable: compare per-tile multisets, not buffer order
        assert sorted(gid_j[start:start + cnt]) == sorted(gid_t[seg[tile_i]:seg[tile_i + 1]])
        start += cnt


@pytest.mark.parametrize("channels", [3, 14])
@pytest.mark.parametrize("tile", [16, (16, 8)])
def test_forward_matches_jax_pairs(channels, tile):
    vm, K = cam()
    arrays = (*scene(0, channels=channels), vm, K)

    def fj(*a):
        return jrasterize(*a, WIDTH, HEIGHT, backend="pairs", tile_size=tile)

    def ft(*a):
        return rasterize(*a, WIDTH, HEIGHT, tile_size=tile)

    (rj, aj, ij), (rt, at, it) = both(jax.jit(fj), ft, arrays)
    assert int(ij["total_pairs"]) == int(it["total_pairs"])
    # cutoff flips: isolated pixels may differ by ~1e-4 * color
    np.testing.assert_allclose(n(rt), n(rj), atol=1e-3)
    np.testing.assert_allclose(n(at), n(aj), atol=1e-3)


@pytest.mark.parametrize("channels,tile", [(3, 16), (3, (16, 8)), (14, 16)])
def test_gradients_match_jax_pairs(channels, tile):
    vm, K = cam()
    means, quats, scales, opacities, colors = scene(1, num=120, channels=channels)
    tgt = np.random.default_rng(2).uniform(size=(HEIGHT, WIDTH, channels)).astype(np.float32)
    off = np.zeros((120, 2), np.float32)

    def loss_j(m, s, o, c, d):
        r, a, _ = jrasterize(m, jnp.asarray(quats), s, o, c, jnp.asarray(vm), jnp.asarray(K),
                             WIDTH, HEIGHT, means2d_offset=d, backend="pairs", tile_size=tile)
        return jnp.sum((r - tgt) ** 2) + jnp.sum(a * 0.3)

    g_j = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in (means, scales, opacities, colors, off)))
    args = [t(a).requires_grad_() for a in (means, scales, opacities, colors, off)]
    r, a, _ = rasterize(args[0], t(quats), args[1], args[2], args[3], t(vm), t(K),
                        WIDTH, HEIGHT, means2d_offset=args[4], tile_size=tile)
    (((r - t(tgt)) ** 2).sum() + (a * 0.3).sum()).backward()
    for name, gj, at in zip(["means", "scales", "opacities", "colors", "means2d"], g_j, args):
        np.testing.assert_allclose(n(at.grad), np.asarray(gj), atol=2e-3, rtol=2e-3,
                                   err_msg=f"grad mismatch: {name}")


def test_saturated_tiles_match_jax_pairs():
    """Deeply saturated tiles: finite gradients; < 3% of entries may differ
    (cutoff flips) and the gradient direction must agree (cos > 0.999)."""
    vm, K = cam()
    num = 600
    rng = np.random.default_rng(7)
    means = np.concatenate([rng.normal(size=(num, 2)) * 0.05,
                            np.linspace(0.5, 2.0, num)[:, None]], -1).astype(np.float32)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (num, 1))
    scales = np.full((num, 3), 0.08, np.float32)
    opacities = np.full((num,), 0.9, np.float32)
    colors = rng.uniform(size=(num, 3)).astype(np.float32)
    tgt = rng.uniform(size=(HEIGHT, WIDTH, 3)).astype(np.float32)

    def loss_j(m, o, c):
        r, a, _ = jrasterize(m, jnp.asarray(quats), jnp.asarray(scales), o, c, jnp.asarray(vm),
                             jnp.asarray(K), WIDTH, HEIGHT, backend="pairs")
        return jnp.sum((r - tgt) ** 2) + jnp.sum(a)

    g_j = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(
        jnp.asarray(means), jnp.asarray(opacities), jnp.asarray(colors))
    args = [t(a).requires_grad_() for a in (means, opacities, colors)]
    r, a, _ = rasterize(args[0], t(quats), t(scales), args[1], args[2], t(vm), t(K),
                        WIDTH, HEIGHT)
    (((r - t(tgt)) ** 2).sum() + a.sum()).backward()
    for name, gj, at in zip(["means", "opacities", "colors"], g_j, args):
        gp, gr = n(at.grad), np.asarray(gj)
        assert np.isfinite(gp).all(), name
        frac = (np.abs(gp - gr) > (5e-3 + 5e-3 * np.abs(gr))).mean()
        assert frac < 0.03, f"{name}: {frac:.3f} of grads mismatch"
        cos = float((gp * gr).sum() / (np.linalg.norm(gp) * np.linalg.norm(gr) + 1e-12))
        assert cos > 0.999, f"{name}: gradient direction diverged ({cos})"


def test_cpu_path_never_launches():
    vm, K = cam()
    means, quats, scales, opacities, colors = scene(3)
    proj = project(*(t(a) for a in (means, quats, scales, opacities, vm, K)),
                   WIDTH, HEIGHT, rasterize_mode="antialiased")
    grid = rp.tile_grid(WIDTH, HEIGHT, 16)
    bins = rp.bin_pairs(proj, WIDTH, HEIGHT, tile_size=16, max_pairs=4096)
    pairs = rp.pack_pairs(bins, proj.means2d, proj.conics, proj.opacities, t(colors),
                          proj.depths)
    before = dict(_kernels.launches)
    chunks = rp.chunk_list(bins.seg_start, pairs.shape[0], kc=32)
    prod = rp.chunk_products(pairs, bins.seg_start, grid, 3, chunks)
    out, t_final, n_contrib = rp.composite_fwd(pairs, bins.seg_start, grid, 3, chunks, prod)
    suffix = rp.chunk_suffix(pairs, bins.seg_start, grid, 3, chunks, prod, out, n_contrib)
    rp.composite_bwd(pairs, bins.seg_start, grid, 3, out, t_final, n_contrib,
                     pairs.shape[0], chunks, prod, suffix)
    assert dict(_kernels.launches) == before
