"""Port parity: the options and helpers that only the JAX package's own
tests call, each held against its JAX function on seeded numpy inputs (one
case each, tolerance beside it): ``project``'s ``radius_clip``,
``env_shade``'s ``bsdf``, stage 2's ACES tone mapping, ``antialias``, the
image helpers, the cosine schedule, the MLP (biases, skip connections,
activations, init schemes), the positional / SH / product-triplane
encodings, FlexiCubes without weights, the ``gmath`` helpers and
``as_points``. Where the JAX function takes a key the JAX draws are
injected; the MLP's init schemes draw from different streams, so they are
held by their bounds and moments."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics import flexicubes as jfc
from geosplatting_tpu.graphics import gmath as jgmath
from geosplatting_tpu.graphics import images as jimages
from geosplatting_tpu.graphics.cameras import Cameras as JCameras
from geosplatting_tpu.graphics.mesh import TriangleMesh as JMesh
from geosplatting_tpu.graphics.splats import Splats as JSplats
from geosplatting_tpu.graphics.splats import as_points as jas_points
from geosplatting_tpu.models import encodings as jenc
from geosplatting_tpu.models.mlp import MLPConfig
from geosplatting_tpu.ops import envshade as jes
from geosplatting_tpu.ops import mesh_raster as jmr
from geosplatting_tpu.ops.projection import project as jproject
from geosplatting_tpu.train.optim import make_schedule as jmake_schedule
from geosplatting_tpu_torch.convert import mlp_from_numpy, mlp_to_numpy
from geosplatting_tpu_torch.graphics import flexicubes as fc
from geosplatting_tpu_torch.graphics import gmath
from geosplatting_tpu_torch.graphics import images
from geosplatting_tpu_torch.graphics.mesh import TriangleMesh
from geosplatting_tpu_torch.graphics.splats import Splats, as_points
from geosplatting_tpu_torch.models import encodings as enc
from geosplatting_tpu_torch.models.geosplat import tone_aces
from geosplatting_tpu_torch.models.geosplat_mc import GeoSplatterMC
from geosplatting_tpu_torch.models.mlp import MLP
from geosplatting_tpu_torch.ops import envshade as es
from geosplatting_tpu_torch.ops.mesh_raster import antialias, rasterize_mesh
from geosplatting_tpu_torch.ops.projection import project
from geosplatting_tpu_torch.train.optim import make_schedule

from .test_torch_geosplat import close_grads
from .torch_parity import (  # noqa: F401
    cameras_from_jax, jax_shade_draws, n, one_torch_thread, shade_draws, t,
)


def rng(seed=0):
    return np.random.default_rng(seed)


def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


# --- ops/projection: radius_clip ---------------------------------------------------


def case_radius_clip():
    """``radius > radius_clip`` joins the culling: the same radii (exact) and
    bounds (1e-5) as JAX, and some Gaussians culled by it alone."""
    r = rng(1)
    num = 300
    means = r.uniform(-1, 1, (num, 3)).astype(np.float32)
    quats = unit(r.normal(size=(num, 4)))
    scales = np.exp(r.uniform(-5.0, -2.0, (num, 3))).astype(np.float32)
    opac = r.uniform(0.3, 0.95, num).astype(np.float32)
    cam = JCameras.from_lookat(jnp.array([2.0, 1.0, 1.5]), jnp.zeros(3), fov_degrees=60.0,
                               width=64, height=48)
    vm, K = np.asarray(cam.view_matrix), np.asarray(cam.intrinsic_matrix)
    args = (means, quats, scales, opac, vm, K)
    pj = jax.jit(lambda *a: jproject(*a, 64, 48, rasterize_mode="antialiased",
                                     radius_clip=3.5))(*(jnp.asarray(a) for a in args))
    pt = project(*(t(a) for a in args), 64, 48, rasterize_mode="antialiased", radius_clip=3.5)
    free = project(*(t(a) for a in args), 64, 48, rasterize_mode="antialiased")
    np.testing.assert_array_equal(n(pt.radii), np.asarray(pj.radii))
    assert ((n(free.radii) > 0) & (n(pt.radii) == 0)).any() and (n(pt.radii) > 0).any()
    np.testing.assert_allclose(n(pt.extents), np.asarray(pj.extents), rtol=1e-5, atol=1e-5)


# --- ops/envshade: bsdf="diffuse" / "white" ------------------------------------------


def shade_inputs():
    r = rng(2)
    num = 64
    view = np.array([0.3, 0.6, 2.8], np.float32)
    d = unit(r.normal(size=(num, 3)))
    pos = (d * r.uniform(0.36, 0.55, (num, 1))).astype(np.float32)
    nrm = unit(0.3 * d + unit(view - pos))
    kd = r.uniform(0.2, 0.8, (num, 3)).astype(np.float32)
    arm = np.stack((np.zeros(num), r.uniform(0.3, 0.9, num), r.uniform(0.05, 0.8, num)),
                   -1).astype(np.float32)
    i, j, c = np.meshgrid(np.arange(16), np.arange(32), np.arange(3), indexing="ij")
    light = (0.3 + 0.15 * np.sin((i + 0.5) / 16 * np.pi) * (1 + np.cos((j + 0.5) / 16 * np.pi))
             + 0.07 * c + 0.01 * np.sin(3.1 * i + 1.7 * j)).astype(np.float32)
    return view, pos, nrm, kd, arm, light


SHADE_KEY = 5
SHADE_WEIGHTS = ((64, 3), (64, 3), (64, 2))


@functools.lru_cache(maxsize=None)
def jax_env_shade(bsdf):
    """The JAX ``env_shade`` and its gradient in (normals, kd, light table)
    of a weighted sum of its outputs."""
    view, pos, nrm, kd, arm, light = shade_inputs()
    key = jax.random.key(SHADE_KEY)
    wts = [rng(3).normal(size=s).astype(np.float32) for s in SHADE_WEIGHTS]

    def loss_j(nrm_, kd_, x):
        out = jes.env_shade(key, jnp.asarray(pos), nrm_, jnp.asarray(view), kd_,
                            jnp.asarray(arm), jes.compute_light_pdf(x), num_samples_x=2,
                            bsdf=bsdf)
        return sum(jnp.sum(o * w) for o, w in zip(out, wts)), out

    return jax.device_get(jax.jit(jax.grad(loss_j, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(nrm), jnp.asarray(kd), jnp.asarray(light)))


def env_shade_case(bsdf):
    """Outputs rtol 1e-4 (atol 1e-6) and gradients as
    tests/test_torch_envshade.py holds the "pbr" lobe; no specular, and kd
    (which only steers the sampling) takes no gradient. JAX's two lobes are
    one branch (envshade.py:346), computed once as "diffuse"."""
    view, pos, nrm, kd, arm, light = shade_inputs()
    gj, out_j = jax_env_shade("diffuse")
    draws = jax_shade_draws(jax.random.key(SHADE_KEY), pos.shape[0], 2)
    wts = [rng(3).normal(size=s).astype(np.float32) for s in SHADE_WEIGHTS]
    leaves = [t(a).requires_grad_() for a in (nrm, kd, light)]
    out_t = es.env_shade(t(pos), leaves[0], t(view), leaves[1], t(arm),
                         es.compute_light_pdf(leaves[2]), shade_draws(draws), bsdf=bsdf)
    sum((o * t(w)).sum() for o, w in zip(out_t, wts)).backward()
    for name, a, b in zip(("diffuse", "specular", "residual"), out_t, out_j):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-4, atol=1e-6, err_msg=name)
    assert float(out_t[1].detach().abs().max()) == 0.0 and float(out_t[0].detach().max()) > 0
    assert leaves[1].grad is None and not np.asarray(gj[1]).any()
    for name, leaf, g in (("normals", leaves[0], gj[0]), ("latlng", leaves[2], gj[2])):
        close_grads(name, n(leaf.grad), np.asarray(g))


# --- models/geosplat_mc: tone_type="aces" ------------------------------------------


def case_stage2_tone_aces():
    """Stage 2 with ``tone_type="aces"`` is the JAX ``tone_aces`` (rtol 1e-6)
    of the untone-mapped render (``tone_type="none"``, exposure applied),
    from the same draws, finite and in [0, 1]."""
    g = torch.Generator().manual_seed(0)
    m = GeoSplatterMC(resolution=8, scale=1.0, num_samples_x=1, shadow_steps=2,
                      max_render_faces=512, triplane_resolution=16, generator=g, device="cpu")
    with torch.no_grad():
        m.sdf.copy_(torch.linalg.norm(m.grid.base_vertices("cpu") - 0.03, dim=-1) - 0.45)
        m.exposure.fill_(0.3)
    cams_j = JCameras.from_orbit(center=jnp.zeros(3), radius=2.0, elevation_degrees=15.0,
                                 num_samples=1, width=16, height=16)
    cams = cameras_from_jax(cams_j)
    noise = torch.randn(m.field.jitter_shape(m.num_field_points()), generator=g)
    draws = [m.draw_shade(g)]
    with torch.no_grad():
        raw, _, _ = m.render(cams, tone_type="none", jitter_noise=noise, draws=draws)
        aces, _, _ = m.render(cams, tone_type="aces", jitter_noise=noise, draws=draws)
    from geosplatting_tpu.models.geosplat import tone_aces as jtone_aces

    want = np.asarray(jtone_aces(jnp.asarray(n(raw[..., :3])), jnp.asarray(1.0)))
    np.testing.assert_allclose(n(aces[..., :3]), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(n(aces[..., 3]), n(raw[..., 3]))
    assert bool(torch.isfinite(aces).all()) and 0.0 <= float(aces.min()) <= float(aces.max()) <= 1.0
    assert float(aces[..., 3].max()) > 0.5
    torch.testing.assert_close(tone_aces(raw[..., :3], torch.tensor(1.0)), aces[..., :3],
                               atol=0, rtol=0)


# --- ops/mesh_raster: antialias ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def aa_scene():
    """An octahedron and a triangle in front of it, viewed a little off the
    grid axis; per-face colours; the port's raster feeds both packages'
    antialias (the raster itself is held by test_torch_mesh_raster.py)."""
    verts = np.array([[0.5, 0, 0], [-0.5, 0, 0], [0, 0.5, 0], [0, -0.5, 0], [0, 0, 0.5],
                      [0, 0, -0.5], [-0.3, 0.6, -0.2], [0.25, 0.55, 0.3], [0.0, 0.7, 0.05]],
                     np.float32)
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5],
                      [3, 1, 5], [0, 3, 5], [6, 7, 8]], np.int32)
    cam = JCameras.from_lookat(jnp.array([0.31, 2.2, 0.17]), jnp.zeros(3),
                               up=jnp.array([0.0, 0.0, 1.0]), width=32, height=32,
                               fov_degrees=45.0)
    colors = rng(4).uniform(0.1, 0.9, (faces.shape[0], 3)).astype(np.float32)
    rast_t, _ = rasterize_mesh(TriangleMesh(vertices=t(verts), indices=t(faces, torch.int64)),
                               cameras_from_jax(cam), tile_capacity=16)
    rast_j = jmr.RasterOut(tri_id=jnp.asarray(n(rast_t.tri_id), jnp.int32),
                           bary=jnp.asarray(n(rast_t.bary)), depth=jnp.asarray(n(rast_t.depth)))
    bg = np.array([0.05, 0.1, 0.2], np.float32)
    tri = n(rast_t.tri_id)
    color = np.where(tri[..., None] >= 0, colors[np.maximum(tri, 0)], bg).astype(np.float32)
    return verts, faces, cam, rast_j, rast_t, color


def case_antialias_value():
    """Values atol 1e-5 (XLA fuses the jitted JAX blend: ~1e-6 apart);
    some silhouette pixels blended."""
    verts, faces, cam, rast_j, rast_t, color = aa_scene()
    out_j = jax.jit(lambda c: jmr.antialias(c, JMesh(vertices=jnp.asarray(verts),
                                                     indices=jnp.asarray(faces)), cam, rast_j)
                    )(jnp.asarray(color))
    out_t = antialias(t(color), TriangleMesh(vertices=t(verts), indices=t(faces, torch.int64)),
                      cameras_from_jax(cam), rast_t)
    np.testing.assert_allclose(n(out_t), np.asarray(out_j), atol=1e-5)
    assert (np.abs(n(out_t) - color).max(-1) > 1e-3).sum() > 10


def case_antialias_vertex_gradient():
    """The gradient in the vertex positions (through the projected edges
    only): rtol 1e-4 of the largest entry, non-zero."""
    verts, faces, cam, rast_j, rast_t, color = aa_scene()
    w = rng(5).normal(size=color.shape).astype(np.float32)

    def loss_j(v):
        m = JMesh(vertices=v, indices=jnp.asarray(faces))
        return jnp.sum(jmr.antialias(jnp.asarray(color), m, cam, rast_j) * w)

    gj = np.asarray(jax.jit(jax.grad(loss_j))(jnp.asarray(verts)))
    v = t(verts).requires_grad_()
    out = antialias(t(color), TriangleMesh(vertices=v, indices=t(faces, torch.int64)),
                    cameras_from_jax(cam), rast_t)
    (out * t(w)).sum().backward()
    assert np.abs(gj).max() > 0.1
    np.testing.assert_allclose(n(v.grad), gj, atol=1e-4 * np.abs(gj).max())


# --- graphics/images ---------------------------------------------------------------


def rgba_batch():
    r = rng(6)
    rgb = r.uniform(0, 1, (2, 8, 12, 3)).astype(np.float32)
    a = r.uniform(0, 1, (2, 8, 12, 1)).astype(np.float32)
    return np.concatenate((rgb * a, a), -1)


def case_blend():
    """Per-batch and shared backgrounds: exact."""
    rgba = rgba_batch()
    for bg in (np.array([0.2, 0.5, 0.9], np.float32), rng(7).uniform(size=(2, 3))):
        bg = bg.astype(np.float32)
        np.testing.assert_allclose(n(images.blend(t(rgba), t(bg))),
                                   np.asarray(jimages.blend(jnp.asarray(rgba), jnp.asarray(bg))),
                                   rtol=1e-7, atol=0)


def case_blend_random():
    """The JAX key's background injected: exact; drawn: in [0, 1)."""
    rgba = rgba_batch()
    rgb_j, bg_j = jimages.blend_random(jax.random.key(3), jnp.asarray(rgba))
    rgb_t, bg_t = images.blend_random(t(rgba), background=t(bg_j))
    np.testing.assert_allclose(n(rgb_t), np.asarray(rgb_j), rtol=1e-7, atol=0)
    _, drawn = images.blend_random(t(rgba), torch.Generator().manual_seed(0))
    assert drawn.shape == (2, 3) and 0.0 <= float(drawn.min()) <= float(drawn.max()) < 1.0


def case_tonemap_aces():
    x = rng(8).uniform(0, 4, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(n(images.tonemap_aces(t(x))),
                               np.asarray(jimages.tonemap_aces(jnp.asarray(x))), rtol=1e-6)


def case_tonemap_naive():
    x = rng(9).uniform(-1, 2, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(n(images.tonemap_naive(t(x))),
                                  np.asarray(jimages.tonemap_naive(jnp.asarray(x))))


def case_resize_linear():
    """Up and down (antialiased), atol 1e-5."""
    img = rng(10).uniform(0, 1, (2, 24, 20, 3)).astype(np.float32)
    for h, w in ((40, 36), (9, 7)):
        np.testing.assert_allclose(n(images.resize(t(img), h, w)),
                                   np.asarray(jimages.resize(jnp.asarray(img), h, w)), atol=1e-5)


def case_resize_nearest():
    img = rng(11).uniform(0, 1, (24, 20, 3)).astype(np.float32)
    for h, w in ((48, 40), (12, 10)):
        np.testing.assert_array_equal(
            n(images.resize(t(img), h, w, "nearest")),
            np.asarray(jimages.resize(jnp.asarray(img), h, w, "nearest")))


def case_depth_to_normals():
    y, x = np.meshgrid(np.arange(12), np.arange(16), indexing="ij")
    depth = (2.0 + 0.05 * x + 0.02 * y + 0.01 * np.sin(x * y)).astype(np.float32)
    np.testing.assert_allclose(
        n(images.depth_to_normals(t(depth), 20.0, 24.0)),
        np.asarray(jimages.depth_to_normals(jnp.asarray(depth), 20.0, 24.0)), rtol=1e-6, atol=1e-7)


# --- train/optim: the cosine schedule ----------------------------------------------


def case_cos_schedule():
    """With and without the warm-up, past ``lr_decay`` too: rtol 1e-6; the
    floor 5 % of lr at the end of the decay."""
    steps = [0, 1, 5, 9, 10, 11, 50, 90, 109, 110, 111, 200]
    for kw in (dict(lr_decay=100, warm_up=10), dict(lr_decay=100), dict(warm_up=10)):
        got = [make_schedule(0.01, mode="cos", **kw)(s) for s in steps]
        want = [float(jmake_schedule(0.01, mode="cos", **kw)(s)) for s in steps]
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert math.isclose(make_schedule(0.01, mode="cos", lr_decay=100)(100), 5e-4, rel_tol=1e-5)


# --- models/mlp ---------------------------------------------------------------------

INIT_STD = {   # the weight's standard deviation each scheme draws, for din / dout
    "default": lambda din, dout: 1.0 / math.sqrt(din) / math.sqrt(3.0),
    "kaiming-uniform": lambda din, dout: math.sqrt(6.0 / din) / math.sqrt(3.0),
    "kaiming-normal": lambda din, dout: math.sqrt(2.0 / din),
    "normal": lambda din, dout: 0.02,
    "xavier-uniform": lambda din, dout: math.sqrt(6.0 / (din + dout)) / math.sqrt(3.0),
}


def mlp_init_case(scheme):
    """Each layer's weights [out, in] within the scheme's bound (uniform
    ones) with the JAX init's standard deviation (both within 4 % of the
    analytic one, mean within 0.06 of it), biases zero."""
    layers = (48, 160, 96)
    m = MLP(layers, bias=True, initialization=scheme, skip_connections=(1,),
            generator=torch.Generator().manual_seed(0))
    jp = MLPConfig(layers=layers, bias=True, initialization=scheme,
                   skip_connections=(1,)).init(jax.random.key(0))
    for i, dout in enumerate(layers[1:]):
        din = layers[i] + (layers[0] if i == 1 else 0)
        w, wj = n(getattr(m, f"w{i}")), np.asarray(jp[f"w{i}"])
        assert w.shape == wj.shape == (dout, din)
        std = INIT_STD[scheme](din, dout)
        for x in (w, wj):
            assert abs(x.std() / std - 1) < 0.04 and abs(x.mean()) < 0.06 * std
            if "uniform" in scheme or scheme == "default":
                assert np.abs(x).max() <= std * math.sqrt(3.0) * (1 + 1e-6)
        assert (n(getattr(m, f"b{i}")) == 0).all()


def mlp_forward_case(activation):
    """Weights and biases carried from the JAX tree by ``convert`` (and
    back, exact), a skip connection and the lazy first width: outputs and
    gradients rtol 1e-5."""
    cfg = MLPConfig(layers=(-1, 16, 16, 4), skip_connections=(1,), activation=activation,
                    bias=True, initialization="xavier-uniform")
    params = jax.device_get(cfg.init(jax.random.key(1), input_dim=5))
    params = {k: (np.asarray(v) + rng(12).normal(size=v.shape) * 0.1).astype(np.float32)
              if k.startswith("b") else np.asarray(v) for k, v in params.items()}
    x = rng(13).uniform(-1, 1, (32, 5)).astype(np.float32)
    m = MLP((-1, 16, 16, 4), skip_connections=(1,), activation=activation, bias=True,
            input_dim=5)
    m.load_state_dict(mlp_from_numpy(params))
    back = mlp_to_numpy(m.state_dict())
    assert back.keys() == params.keys() and all((back[k] == params[k]).all() for k in back)

    def loss_j(p, x_):
        return jnp.sum(cfg.apply(p, x_) ** 2)

    gj, gxj = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    xt = t(x).requires_grad_()
    out = m(xt)
    np.testing.assert_allclose(n(out), np.asarray(jax.jit(cfg.apply)(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(n(xt.grad), np.asarray(gxj), rtol=1e-5, atol=1e-6)
    for name, p in m.named_parameters():
        np.testing.assert_allclose(n(p.grad), np.asarray(gj[name]), rtol=1e-5, atol=1e-6)


# --- models/encodings ----------------------------------------------------------------


def case_pos_encoding():
    x = rng(14).uniform(-1, 1, (10, 3)).astype(np.float32)
    for kw in (dict(), dict(num_frequencies=4, min_freq_exp=1.0, max_freq_exp=3.0,
                            include_input=False)):
        got = enc.PosEncoding(**kw)(t(x))
        assert got.shape[-1] == enc.PosEncoding(**kw).output_dim(3)
        np.testing.assert_allclose(n(got), np.asarray(jenc.PosEncoding(**kw).apply(jnp.asarray(x))),
                                   atol=2e-5)


def case_sh_encoding():
    d = rng(15).normal(size=(10, 3)).astype(np.float32)
    for degree in (1, 2, 4):
        want = jax.jit(jenc.SHEncoding(degree).apply)(jnp.asarray(d))
        np.testing.assert_allclose(n(enc.SHEncoding(degree)(t(d))), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def case_triplane_product():
    """The product reduction and its gradient in the planes: rtol 1e-5."""
    r = rng(16)
    planes = r.normal(size=(3, 8, 8, 4)).astype(np.float32)
    x = r.uniform(-1, 1, (20, 3)).astype(np.float32)
    te = jenc.TriplaneEncoding(resolution=8, num_components=4, reduce="product")
    out_j, gj = jax.jit(lambda p, x_: (te.apply(p, x_), jax.grad(
        lambda q: jnp.sum(te.apply(q, x_) ** 2))(p)))(jnp.asarray(planes), jnp.asarray(x))
    m = enc.TriplaneEncoding(8, 4, reduce="product")
    with torch.no_grad():
        m.planes.copy_(t(planes))
    out = m(t(x))
    np.testing.assert_allclose(n(out), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(n(m.planes.grad), np.asarray(gj), rtol=1e-5, atol=1e-5)


# --- graphics/flexicubes: extract without weights, weight_scale, sdf_eps -------------


def case_flexicubes_optional_weights():
    """No deform, beta or gamma, alpha with ``weight_scale`` 0.5, and
    ``sdf_eps`` 0.1: topology exact, positions and l_dev 1e-5."""
    grid = fc.make_grid(8, scale=1.0)
    jgrid = jfc.make_grid(8, scale=1.0)
    sdf = (np.linalg.norm(n(grid.base_vertices()) - 0.05, axis=-1) - 0.5).astype(np.float32)
    alpha = (rng(17).normal(size=(grid.num_cubes, 8)) * 0.3).astype(np.float32)
    oj = jax.jit(lambda s_, a: jfc.extract(jgrid, s_, alpha=a, weight_scale=0.5, sdf_eps=0.1))(
        jnp.asarray(sdf), jnp.asarray(alpha))
    ot = fc.extract(grid, t(sdf), alpha=t(alpha), weight_scale=0.5, sdf_eps=0.1)
    np.testing.assert_array_equal(n(ot.mesh.indices), np.asarray(oj.mesh.indices))
    np.testing.assert_array_equal(n(ot.mesh.face_mask), np.asarray(oj.mesh.face_mask))
    np.testing.assert_allclose(n(ot.mesh.vertices), np.asarray(oj.mesh.vertices),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(ot.l_dev), float(oj.l_dev), rtol=1e-5, atol=1e-7)
    assert int(ot.num_surf_cubes) > 0


# --- graphics/gmath ---------------------------------------------------------------------


def case_gmath_dot():
    a, b = rng(18).normal(size=(2, 10, 3)).astype(np.float32)
    for keep in (True, False):
        np.testing.assert_allclose(n(gmath.dot(t(a), t(b), keep)),
                                   np.asarray(jgmath.dot(jnp.asarray(a), jnp.asarray(b), keep)),
                                   rtol=1e-6, atol=1e-7)


def case_gmath_reflect():
    x, nrm = rng(19).normal(size=(2, 10, 3)).astype(np.float32)
    nrm = unit(nrm)
    np.testing.assert_allclose(n(gmath.reflect(t(x), t(nrm))),
                               np.asarray(jgmath.reflect(jnp.asarray(x), jnp.asarray(nrm))),
                               rtol=1e-6, atol=1e-6)


def case_gmath_quat_multiply():
    a, b = rng(20).normal(size=(2, 10, 4)).astype(np.float32)
    np.testing.assert_allclose(n(gmath.quat_multiply(t(a), t(b))),
                               np.asarray(jgmath.quat_multiply(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-6)


def case_gmath_slerp_quat():
    """Both hemispheres of qa . qb and the end points: atol 1e-6."""
    r = rng(21)
    qa, qb = unit(r.normal(size=(2, 12, 4)))
    w = np.concatenate((r.uniform(0, 1, 10), [0.0, 1.0])).astype(np.float32)
    assert ((qa * qb).sum(-1) < 0).any() and ((qa * qb).sum(-1) > 0).any()
    got = n(gmath.slerp_quat(t(qa), t(qb), t(w)))
    np.testing.assert_allclose(got, np.asarray(jgmath.slerp_quat(jnp.asarray(qa), jnp.asarray(qb),
                                                                 jnp.asarray(w))), atol=1e-6)


def case_gmath_latlng_dir():
    """Against JAX (atol 1e-6) and the inverse of ``dir_to_latlng_uv``."""
    r = rng(22)
    theta = r.uniform(0.05, np.pi - 0.05, 16).astype(np.float32)
    phi = r.uniform(-np.pi + 0.05, np.pi - 0.05, 16).astype(np.float32)
    d = gmath.latlng_dir(t(theta), t(phi))
    np.testing.assert_allclose(n(d), np.asarray(jgmath.latlng_dir(jnp.asarray(theta),
                                                                  jnp.asarray(phi))), atol=1e-6)
    uv = n(gmath.dir_to_latlng_uv(d))
    np.testing.assert_allclose(uv, np.stack((phi / (2 * np.pi) + 0.5, theta / np.pi), -1),
                               atol=1e-5)


# --- graphics/splats: as_points ----------------------------------------------------------


def case_as_points():
    """The JAX key's categorical indices and normals injected: positions
    atol 1e-6, colours exact; drawn from a generator: volume-weighted."""
    r = rng(23)
    num = 50
    fields = dict(means=r.uniform(-1, 1, (num, 3)), scales=r.uniform(-4, -1, (num, 3)),
                  quats=r.normal(size=(num, 4)), colors=r.uniform(0, 1, (num, 3)),
                  opacities=r.normal(size=(num, 1)))
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    sj = JSplats(**{k: jnp.asarray(v) for k, v in fields.items()},
                 shs=jnp.zeros((num, 0, 3)))
    @jax.jit
    def points_j(s_, key):
        k1, k2 = jax.random.split(key)
        idx = jax.random.categorical(k1, jnp.log(jnp.exp(s_.scales.sum(-1)) + 1e-20),
                                     shape=(200,))
        return jas_points(s_, key, 200), idx, jax.random.normal(k2, (200, 3))

    (pos_j, col_j), idx, randn = points_j(sj, jax.random.key(4))
    st = Splats(**{k: t(v) for k, v in fields.items()})
    pos_t, col_t = as_points(st, 200, idx=t(idx, torch.int64), randn=t(randn))
    np.testing.assert_allclose(n(pos_t), np.asarray(pos_j), atol=1e-6)
    np.testing.assert_array_equal(n(col_t), np.asarray(col_j))
    pos_g, _ = as_points(st, 4000, generator=torch.Generator().manual_seed(0))
    assert pos_g.shape == (4000, 3) and bool(torch.isfinite(pos_g).all())


CASES = {
    "radius_clip": case_radius_clip,
    "env_shade_diffuse": lambda: env_shade_case("diffuse"),
    "env_shade_white": lambda: env_shade_case("white"),
    "stage2_tone_aces": case_stage2_tone_aces,
    "antialias_value": case_antialias_value,
    "antialias_vertex_gradient": case_antialias_vertex_gradient,
    "blend": case_blend,
    "blend_random": case_blend_random,
    "tonemap_aces": case_tonemap_aces,
    "tonemap_naive": case_tonemap_naive,
    "resize_linear": case_resize_linear,
    "resize_nearest": case_resize_nearest,
    "depth_to_normals": case_depth_to_normals,
    "cos_schedule": case_cos_schedule,
    **{f"mlp_init_{s}": (lambda s=s: mlp_init_case(s)) for s in INIT_STD},
    **{f"mlp_{a}": (lambda a=a: mlp_forward_case(a))
       for a in ("none", "relu", "sigmoid", "tanh", "softplus", "exp")},
    "pos_encoding": case_pos_encoding,
    "sh_encoding": case_sh_encoding,
    "triplane_product": case_triplane_product,
    "flexicubes_optional_weights": case_flexicubes_optional_weights,
    "gmath_dot": case_gmath_dot,
    "gmath_reflect": case_gmath_reflect,
    "gmath_quat_multiply": case_gmath_quat_multiply,
    "gmath_slerp_quat": case_gmath_slerp_quat,
    "gmath_latlng_dir": case_gmath_latlng_dir,
    "as_points": case_as_points,
}


@pytest.mark.parametrize("name", list(CASES))
def test_option_matches_jax(name):
    CASES[name]()
