"""Port parity: graphics/sg (the SG algebra, the GGX lobe, the cubemap fit,
TextureSG) and the 2D toy (graphics/toy2d and data/dataparsers/toy2d)
against the JAX package on the CPU. Random lobes, circles and view orders
are the JAX package's draws, given to the port.

Tolerances: the SG algebra 1e-5 relative; the cubemap fit (60 Adam steps
on the mean L1 error, torch.optim.Adam against optax's Adam) 2e-3 relative
on each parameter and its loss; the 2D toy 1e-5 (rays, renders) and equal
splits and batches. Each test's JAX side is one compiled program (op by op,
every JAX function of the file compiles each of its ops on its own)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.data.dataparsers import toy2d as jtoyp
from geosplatting_tpu.graphics import sg as jsg
from geosplatting_tpu.graphics import toy2d as jtoy
from geosplatting_tpu.ops.cubemap import texel_directions
from geosplatting_tpu_torch.data.dataparsers import toy2d as ttoyp
from geosplatting_tpu_torch.graphics import sg, toy2d

from .torch_parity import n, one_torch_thread, t  # noqa: F401


def rel(got, want, rtol, name=""):
    got, want = n(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()),
                               err_msg=name)


def to_t(s):
    return sg.SphericalGaussians(*(t(x) for x in s))


def test_sg_algebra_matches_jax():
    dirs = np.array(jax.random.normal(jax.random.key(2), (40, 3)))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    wo = np.roll(dirs, 3, axis=0)
    normals = dirs * np.sign((dirs * wo).sum(-1, keepdims=True))
    rough = np.linspace(0.1, 0.9, 40, dtype=np.float32)[:, None]

    @jax.jit
    def jax_side(dirs, normals, wo, rough):
        a_j, b_j = jsg.random_sg(jax.random.key(0), 6), jsg.random_sg(jax.random.key(1), 6)
        return {"a": a_j, "b": b_j, "evaluate": a_j.evaluate(dirs), "integral": a_j.integral(),
                "product": a_j.product(b_j), "inner_product": a_j.inner_product(b_j),
                "cosine_integral": a_j.cosine_integral(dirs[:10].reshape(2, 5, 3)),
                "brdf lobe": jsg.sg_brdf_lobe(normals, wo, rough)}

    want = jax_side(dirs, normals, wo, rough)
    a, b = to_t(want["a"]), to_t(want["b"])
    rel(a.evaluate(t(dirs)), want["evaluate"], 1e-5, "evaluate")
    rel(a.integral(), want["integral"], 1e-5, "integral")
    for x, y in zip(a.product(b), want["product"], strict=True):
        rel(x, y, 1e-5, "product")
    rel(a.inner_product(b), want["inner_product"], 1e-5, "inner_product")
    rel(a.cosine_integral(t(dirs[:10].reshape(2, 5, 3))), want["cosine_integral"], 1e-5,
        "cosine_integral")
    for x, y in zip(sg.sg_brdf_lobe(t(normals), t(wo), t(rough)), want["brdf lobe"],
                    strict=True):
        rel(x, y, 1e-5, "brdf lobe")


def test_fit_sg_to_cubemap_matches_jax():
    """The same start (JAX's random lobes from its key), the same L1 fit:
    60 Adam steps land on the same lobes."""
    res, k, steps = 8, 4, 60
    d = np.asarray(texel_directions(res))
    cube = (0.3 + np.clip(d @ np.array([0.3, 0.8, 0.5]), 0, None)[..., None]
            * np.array([1.0, 0.8, 0.6])).astype(np.float32)
    key = jax.random.key(5)
    fit_j = jsg.fit_sg_to_cubemap(jnp.asarray(cube), k, key=key, num_steps=steps)
    fit_t = sg.fit_sg_to_cubemap(t(cube), k, init=to_t(jsg.random_sg(key, k)), num_steps=steps)
    for name, x, y in zip(("axis", "sharpness", "amplitude"), fit_t, fit_j, strict=True):
        rel(x, y, 2e-3, name)
    target = cube.reshape(-1, 3)
    flat = d.reshape(-1, 3)
    loss_t = float((fit_t.evaluate(t(flat)) - t(target)).abs().mean())
    loss_j = float(jnp.abs(fit_j.evaluate(flat) - target).mean())
    np.testing.assert_allclose(loss_t, loss_j, rtol=2e-3)
    start = float(jnp.abs(jsg.random_sg(key, k).evaluate(flat) - target).mean())
    assert loss_t < start
    # TextureSG's fit stores the same lobes before their activations
    tex = sg.TextureSG.from_cubemap(t(cube), k, init=to_t(jsg.random_sg(key, k)),
                                    num_steps=steps)
    rel(tex.as_sg().sharpness, fit_j.sharpness, 2e-3, "TextureSG")


def test_texture_sg_matches_jax():
    rng = np.random.default_rng(0)
    m = 30
    normals = rng.normal(size=(m, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    wo = normals + 0.6 * rng.normal(size=(m, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    albedo = rng.uniform(size=(m, 3)).astype(np.float32)
    rough = rng.uniform(0.1, 0.9, size=(m, 1)).astype(np.float32)
    metal = rng.uniform(size=(m, 1)).astype(np.float32)

    @jax.jit
    def jax_side(normals):
        tex_j = jsg.TextureSG.from_random(jax.random.key(7), 5)
        return {"tex": tex_j, "sample": tex_j.sample(normals),
                "visualize": tex_j.visualize(width=16, height=8)}

    want = jax_side(normals)
    tex_j = want["tex"]
    tex = sg.TextureSG(*(t(x) for x in tex_j))
    rel(tex.sample(t(normals)), want["sample"], 1e-5, "sample")
    rel(tex.visualize(width=16, height=8), want["visualize"], 1e-5, "visualize")
    got = tex.integral(t(normals), t(wo), albedo=t(albedo), roughness=t(rough),
                       metallic=t(metal))
    # the integral op by op: compiled whole, XLA moves its specular term by ulps
    want = jsg.TextureSG.integral(tex_j, normals, wo, albedo=albedo, roughness=rough,
                                  metallic=metal)
    for name, x, y in zip(("diffuse", "specular"), got, want, strict=True):
        rel(x, y, 1e-5, name)
    draw = sg.TextureSG.from_random(5, generator=torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in draw] == [tuple(x.shape) for x in tex_j]


def test_toy2d_matches_jax():
    @jax.jit
    def jax_side():
        cj = jtoy.Cameras2D.from_orbit(center=(0.1, -0.2), radius=1.3, num_samples=5,
                                       width=32, hfov_degrees=70.0, far=3.0)
        shape_j = jtoy.CircleShape2D.random(jax.random.key(3), 4)
        return {"cams": cj, "rays": cj.generate_rays(), "shape": shape_j,
                "render": shape_j.render(cj), "visualize": shape_j.visualize(width=20, height=14),
                "shading2d": jtoy.shading2d(cj.c2w[:, :, 2])}

    want = jax_side()
    cj, shape_j = want["cams"], want["shape"]
    ct = toy2d.Cameras2D.from_orbit(center=(0.1, -0.2), radius=1.3, num_samples=5, width=32,
                                    hfov_degrees=70.0, far=3.0, device="cpu")
    rel(ct.c2w, cj.c2w, 1e-5, "c2w")
    rel(ct.focal, cj.focal, 1e-6, "focal")
    for x, y in zip(ct.generate_rays(), want["rays"], strict=True):
        np.testing.assert_allclose(n(x), np.asarray(y), atol=1e-5)
    shape = toy2d.CircleShape2D(t(shape_j.origins), t(shape_j.radius))
    img = shape.render(ct)
    np.testing.assert_allclose(n(img), np.asarray(want["render"]), atol=1e-5)
    assert 0 < float(img[..., 3].mean()) < 1
    np.testing.assert_allclose(n(shape.visualize(width=20, height=14)),
                               np.asarray(want["visualize"]), atol=1e-6)
    np.testing.assert_allclose(n(toy2d.shading2d(t(np.asarray(cj.c2w[:, :, 2])))),
                               np.asarray(want["shading2d"]), atol=1e-6)


def test_syn2d_dataset_matches_jax(monkeypatch):
    kw = dict(num_circles=3, num_train_views=12, num_val_views=6, num_test_views=4, width=24)

    def jax_draws(seed, num_circles, num_views):
        k_shape, k_perm = jax.random.split(jax.random.key(seed))
        s = jtoy.CircleShape2D.random(k_shape, num_circles)
        return (toy2d.CircleShape2D(t(s.origins), t(s.radius)),
                torch.as_tensor(np.array(jax.random.permutation(k_perm, num_views))))

    monkeypatch.setattr(ttoyp, "_scene_draws", jax_draws)
    # the JAX parser runs eagerly: jitted whole, each split compiles once
    monkeypatch.setattr(jtoyp.Synthetic2DDataparser, "parse2d",
                        jax.jit(jtoyp.Synthetic2DDataparser.parse2d, static_argnums=(0, 1)))
    dj = jtoyp.MultiView2DDataset(jtoyp.Synthetic2DDataparser(**kw))
    dt = ttoyp.MultiView2DDataset(ttoyp.Synthetic2DDataparser(**kw), device="cpu")
    for split, size in (("train", 12), ("val", 6), ("test", 4)):
        cj, ij, _ = dj.get_split(split)
        ct, it, _ = dt.get_split(split)
        assert dt.get_size(split) == dj.get_size(split) == size
        np.testing.assert_allclose(n(ct.c2w), np.asarray(cj.c2w), atol=1e-5)
        np.testing.assert_allclose(n(it), np.asarray(ij), atol=1e-5)
    bj, bt = dj.iter_batches("train", 5, seed=2), dt.iter_batches("train", 5, seed=2)
    for _ in range(4):
        (cj, ij, idx_j), (ct, it, idx_t) = next(bj), next(bt)
        np.testing.assert_array_equal(idx_t, idx_j)
        np.testing.assert_allclose(n(it), np.asarray(ij), atol=1e-5)
    with pytest.raises(ValueError):
        ttoyp.Synthetic2DDataparser(**kw).parse2d("holdout", device="cpu")
