"""Port parity: the depth render modes, the dense tile binning and the dense
reference compositing against the JAX package on the CPU.

The port renders ``ED`` / ``D`` / ``RGB+ED`` / ``RGB+D`` on its pairs path
(the plain versions of K1-K3 on the CPU); the JAX package's dense reference
rasterizer (``backend="reference"``) is the oracle, as it is for the JAX
pairs path. ``bin_gaussians`` is fed the same projection in both packages
and its tile table compared id for id: by the per-axis extents, by the
circular radius (2DGS), truncated to a small capacity, over the pair budget,
and past 2^15 tiles (the two-key sort). ``composite_tiles_reference`` is
held against the JAX one on the same table. 300 Gaussians at 64x48.

Tolerances are the ones the JAX package uses between its two rasterizer
backends (tests/test_rasterize_pallas.py:53,77,127-132): the depth renders
atol 1e-4 (its ED-mode test), alpha atol 1e-3 (transmittance-cutoff flips),
the gradients atol 2e-3 + rtol 2e-3. The dense compositing, the same
algorithm in both packages, atol 1e-5 and its gradients 1e-4 of the largest
entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics.cameras import Cameras as JCameras
from geosplatting_tpu.ops import rasterize as jr
from geosplatting_tpu.ops.projection import Projected as JProjected
from geosplatting_tpu.ops.projection import project as jproject
from geosplatting_tpu_torch.ops import rasterize as tr
from geosplatting_tpu_torch.ops.projection import Projected

from .torch_parity import n, one_torch_thread, t  # noqa: F401

WIDTH, HEIGHT = 64, 48
MODES = ("ED", "D", "RGB+ED", "RGB+D")
INPUTS = ("means", "quats", "scales", "opacities")


def scene(seed=0, num=300):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(num, 4))
    return {
        "means": rng.uniform(-1.0, 1.0, (num, 3)).astype(np.float32),
        "quats": (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32),
        "scales": np.exp(rng.uniform(-4.5, -2.0, (num, 3))).astype(np.float32),
        "opacities": rng.uniform(0.3, 0.95, num).astype(np.float32),
        "colors": rng.uniform(0, 1, (num, 3)).astype(np.float32),
    }


def cam(width=WIDTH, height=HEIGHT):
    c = JCameras.from_lookat(jnp.array([2.0, 1.0, 1.5]), jnp.zeros(3), fov_degrees=60.0,
                             width=width, height=height)
    return c.view_matrix, c.intrinsic_matrix


def cotangents(channels: int, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(HEIGHT, WIDTH, channels)).astype(np.float32),
            rng.normal(size=(HEIGHT, WIDTH, 1)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_modes():
    """Each mode through the JAX reference rasterizer: render, alpha and the
    gradients of sum(render * w) + sum(alpha * wa), jitted once per mode."""
    viewmat, K = cam()
    x = scene()
    out = {}
    for mode in MODES:
        w, wa = cotangents(1 if mode in ("ED", "D") else 4)

        def loss(means, quats, scales, opacities, mode=mode, w=w, wa=wa):
            r, a, _ = jr.rasterize(means, quats, scales, opacities, jnp.asarray(x["colors"]),
                                   viewmat, K, WIDTH, HEIGHT, render_mode=mode,
                                   backend="reference", tile_capacity=256)
            return jnp.sum(r * w) + jnp.sum(a * wa), (r, a)

        grads, (r, a) = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
            *(jnp.asarray(x[k]) for k in INPUTS))
        out[mode] = (np.asarray(r), np.asarray(a), [np.asarray(g) for g in grads])
    return out


@pytest.mark.parametrize("mode", MODES)
def test_depth_modes_match_jax_reference(jax_modes, mode):
    viewmat, K = cam()
    x = scene()
    r_j, a_j, g_j = jax_modes[mode]
    xt = {k: t(v).requires_grad_(k in INPUTS) for k, v in x.items()}
    r, a, info = tr.rasterize(*(xt[k] for k in (*INPUTS, "colors")), t(viewmat), t(K),
                              WIDTH, HEIGHT, render_mode=mode)
    w, wa = cotangents(r.shape[-1])
    ((r * t(w)).sum() + (a * t(wa)).sum()).backward()
    assert r.shape == r_j.shape == (HEIGHT, WIDTH, 1 if mode in ("ED", "D") else 4)
    covered = a_j[..., 0] > 0.5
    assert covered.mean() > 0.1
    np.testing.assert_allclose(n(r), r_j, atol=1e-4)
    np.testing.assert_allclose(n(a), a_j, atol=1e-3)
    if mode.endswith("ED"):   # an expected depth lies among the Gaussians' depths
        d = n(r)[..., -1][covered]
        z = n(info["depths"])[n(info["radii"]) > 0]
        assert d.min() >= z.min() - 1e-4 and d.max() <= z.max() + 1e-4
    for name, want in zip(INPUTS, g_j):
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(n(xt[name].grad), want, atol=2e-3, rtol=2e-3,
                                   err_msg=f"{mode}: {name}")


def test_rgb_mode_and_unknown_mode():
    """RGB is the colour render alone; an unknown mode raises, as in JAX."""
    viewmat, K = cam()
    x = {k: t(v) for k, v in scene().items()}
    args = (*(x[k] for k in (*INPUTS, "colors")), t(viewmat), t(K), WIDTH, HEIGHT)
    rgb, alpha, _ = tr.rasterize(*args)
    both, alpha2, _ = tr.rasterize(*args, render_mode="RGB+D")
    assert torch.equal(rgb, both[..., :3]) and torch.equal(alpha, alpha2)
    with pytest.raises(ValueError, match="render_mode"):
        tr.rasterize(*args, render_mode="RGBD")


def projection(width=WIDTH, height=HEIGHT, seed=0, num=300) -> JProjected:
    viewmat, K = cam(width, height)
    x = scene(seed, num)
    return jproject(*(jnp.asarray(x[k]) for k in INPUTS), viewmat, K, width, height)


@pytest.mark.parametrize("case", ["extents", "radii", "truncated", "over_budget", "two_key"])
def test_bin_gaussians_matches_jax(case):
    """The [T, K] tile table id for id, the pair count and the fullest tile."""
    width, height = (4096, 2048) if case == "two_key" else (WIDTH, HEIGHT)
    pj = projection(width, height)
    if case != "extents":   # 2DGS: the circular radius rectangle
        pj = pj._replace(extents=None, prune_r=None)
    kw = {"tile_size": 16, "max_pairs": 1 << 14, "tile_capacity": 256}
    if case == "truncated":
        kw["tile_capacity"] = 8
    if case == "over_budget":
        kw["max_pairs"] = 600
    if case == "two_key":   # 32,768 tiles leave the packed key < 16 depth bits
        kw.update(max_pairs=1 << 16, tile_capacity=16)
    bins_j = jr.bin_gaussians(pj, width, height, **kw)
    pt = Projected(*(None if v is None else t(v, torch.int32 if k == "radii" else torch.float32)
                     for k, v in pj._asdict().items()))
    bins = tr.bin_gaussians(pt, width, height, **kw)
    np.testing.assert_array_equal(n(bins.tile_gid), np.asarray(bins_j.tile_gid))
    assert int(bins.total_pairs) == int(bins_j.total_pairs)
    assert bins.num_tiles_xy == bins_j.num_tiles_xy
    tw, th = bins.num_tiles_xy
    assert (31 - int(tw * th + 1).bit_length() < 16) == (case == "two_key")
    # the fullest tile, counted before truncation
    full_cap = 512
    full = jr.bin_gaussians(pj, width, height, **dict(kw, tile_capacity=full_cap))
    fullest = int((np.asarray(full.tile_gid) >= 0).sum(1).max())
    assert int(bins.max_tile_pairs) == fullest and 0 < fullest < full_cap
    if case == "truncated":
        assert fullest > kw["tile_capacity"]
    if case == "over_budget":
        assert int(bins.total_pairs) > kw["max_pairs"]


def test_composite_tiles_reference_matches_jax():
    """The dense CPU oracle on the same tile table: values and the gradients
    of every input."""
    width, height = WIDTH, HEIGHT
    pj = projection(seed=4)
    x = scene(4)
    bins = jr.bin_gaussians(pj, width, height, tile_size=16, max_pairs=1 << 14,
                            tile_capacity=128)
    tw, th = bins.num_tiles_xy
    origin = np.asarray(tr.tile_origins(tw, th, 16))
    names = ("means2d", "conics", "opacities", "colors", "depths")
    vals = [np.asarray(pj.means2d), np.asarray(pj.conics), np.asarray(pj.opacities),
            x["colors"], np.asarray(pj.depths)]
    rng = np.random.default_rng(2)
    ws = [rng.normal(size=s).astype(np.float32) for s in ((tw * th, 256, 3), (tw * th, 256),
                                                          (tw * th, 256))]

    def loss(*v):
        outs = jr.composite_tiles_reference(bins.tile_gid, jnp.asarray(origin), *v,
                                            tile_size=16, tile_chunk=4)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), outs

    g_j, outs_j = jax.jit(jax.grad(loss, argnums=tuple(range(5)), has_aux=True))(
        *map(jnp.asarray, vals))
    vt = [t(v).requires_grad_() for v in vals]
    outs = tr.composite_tiles_reference(t(bins.tile_gid, torch.long), t(origin), *vt,
                                        tile_size=16, tile_chunk=4)
    sum((o * t(w)).sum() for o, w in zip(outs, ws)).backward()
    assert float(outs[1].detach().max()) > 0.5
    for o, o_j in zip(outs, outs_j):
        np.testing.assert_allclose(n(o), np.asarray(o_j), atol=1e-5)
    for name, v, g in zip(names, vt, g_j):
        scale = np.abs(np.asarray(g)).max()
        assert scale > 0, name
        np.testing.assert_allclose(n(v.grad) / scale, np.asarray(g) / scale, atol=1e-4,
                                   err_msg=name)
