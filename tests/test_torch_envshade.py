"""Port parity: the stage-2 shading ops against the JAX package on the CPU.

Light pdf tables, light and BSDF sampling, the BSDF, ``env_shade`` (with and
without SDF shadows), the SDF sphere trace, the bilateral denoiser and the
cubemap to lat-long resampling. The random draws come from jax.random and
are handed to both packages (tests/torch_parity.py replays env_shade's key
splits). Inputs stay off the discontinuities (texel edges, the front-face
test, lobe choices): a nearest-texel lookup flipped by one ulp moves a
sample's radiance by a whole texel.

Tolerances: elementwise results rtol 1e-5 (atol 1e-6 or 1e-5 where a trig
function or a sqrt near 0 enters); sums over the samples and their
gradients rtol 1e-4 (the two packages sum in other orders); gradient
groups close_grads' 1 % in L2 and 2 % of the largest entry, the stage-1
rule of tests/test_torch_geosplat.py, where a gradient sums over many
points."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.models.geosplat_mc import cubemap_to_latlng as jcubemap_to_latlng
from geosplatting_tpu.ops import envshade as jes
from geosplatting_tpu.ops.denoise import bilateral_denoise as jdenoise
from geosplatting_tpu.ops.sdf_visibility import make_sdf_visibility as jvis
from geosplatting_tpu.ops.sdf_visibility import sample_sdf_grid as jsample_sdf
from geosplatting_tpu_torch.models.geosplat_mc import cubemap_to_latlng
from geosplatting_tpu_torch.ops import envshade as es
from geosplatting_tpu_torch.ops.denoise import bilateral_denoise
from geosplatting_tpu_torch.ops.sdf_visibility import make_sdf_visibility, sample_sdf_grid

from .test_torch_geosplat import close_grads
from .torch_parity import jax_shade_draws, n, one_torch_thread, shade_draws, t  # noqa: F401

H, W = 16, 32
NPTS = 64
GRID = (16, 16, 16)


def light_table() -> np.ndarray:
    """A smooth lat-long radiance table with a bright lobe, no texel at a tie."""
    i, j, c = np.meshgrid(np.arange(H), np.arange(W), np.arange(3), indexing="ij")
    th, ph = (i + 0.5) / H * np.pi, (j + 0.5) / W * 2 * np.pi
    lobe = np.exp(-((th - 0.8) ** 2 + (ph - 2.0) ** 2) * 2.0)
    return (0.3 + 0.15 * np.sin(th) * (1 + np.cos(ph)) + 2.0 * lobe + 0.07 * c
            + 0.01 * np.sin(3.1 * i + 1.7 * j)).astype(np.float32)


def sphere_sdf() -> np.ndarray:
    rx, ry, rz = GRID
    z, y, x = np.meshgrid(*(np.arange(r + 1) for r in (rz, ry, rx)), indexing="ij")
    v = np.stack((x / rx, y / ry, z / rz), -1) * 2 - 1
    return (np.linalg.norm(v - 0.013, axis=-1) - 0.31).astype(np.float32).reshape(-1)


@pytest.fixture(scope="module")
def points():
    """Shading points on a shell around the SDF sphere, normals toward the
    viewer (so the sphere shadows the far side's samples), materials off
    the clamps."""
    rng = np.random.default_rng(0)
    view = np.array([0.3, 0.6, 2.8], np.float32)
    d = rng.normal(size=(NPTS, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = (d * rng.uniform(0.36, 0.55, (NPTS, 1))).astype(np.float32)
    nrm = 0.3 * d + (view - pos) / np.linalg.norm(view - pos, axis=-1, keepdims=True)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    kd = rng.uniform(0.2, 0.8, (NPTS, 3)).astype(np.float32)
    arm = np.stack((np.zeros(NPTS), rng.uniform(0.3, 0.9, NPTS), rng.uniform(0.05, 0.8, NPTS)),
                   -1).astype(np.float32)
    return {"pos": pos, "nrm": nrm, "view": view, "kd": kd, "arm": arm}


def test_light_tables_sampling_and_lookup_match_jax():
    data = light_table()
    lj = jax.jit(jes.compute_light_pdf)(data)
    lt = es.compute_light_pdf(t(data))
    for f in ("pdf", "rows", "cols"):
        np.testing.assert_allclose(n(getattr(lt, f)), np.asarray(getattr(lj, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    rng = np.random.default_rng(1)
    u, v = rng.uniform(size=(2, 500)).astype(np.float32)
    dj = jax.jit(jes.sample_light)(lj, u, v)
    dt = es.sample_light(lt, t(u), t(v))
    np.testing.assert_allclose(n(dt), np.asarray(dj), atol=1e-5)
    np.testing.assert_allclose(n(es.light_pdf_at(lt, dt)), np.asarray(jes.light_pdf_at(lj, dj)),
                               rtol=1e-4)
    # the lookups and their gradient into the table, at the JAX directions
    wts = rng.normal(size=(500, 3)).astype(np.float32)
    gj = jax.jit(jax.grad(lambda x: jnp.sum(
        jes.eval_light_and_pdf(jes.compute_light_pdf(x), dj)[0] * wts)))(jnp.asarray(data))
    x = t(data).requires_grad_()
    rad, pdf = es.eval_light_and_pdf(es.compute_light_pdf(x), t(dj))
    (rad * t(wts)).sum().backward()
    np.testing.assert_array_equal(n(rad), np.asarray(jes.eval_light(lj, dj)))
    np.testing.assert_allclose(n(pdf), np.asarray(jes.eval_light_and_pdf(lj, dj)[1]), rtol=1e-5)
    np.testing.assert_allclose(n(x.grad), np.asarray(gj), rtol=1e-4, atol=1e-6)


def test_bsdf_and_its_sampling_match_jax(points):
    p = points
    rng = np.random.default_rng(2)
    wo = p["view"] - p["pos"]
    wo = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(np.float32)
    wi = (p["nrm"] + rng.normal(size=(NPTS, 3)) * 0.5).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    u = rng.uniform(size=(3, NPTS)).astype(np.float32)
    alpha = p["arm"][:, 1] ** 2
    wts = rng.normal(size=(2, NPTS, 3)).astype(np.float32)

    def loss_j(kd, arm, nrm, wo_):
        dif, spec = jes.eval_bsdf(kd, arm, nrm, wo_, jnp.asarray(wi))
        return jnp.sum(dif * wts[0] + spec * wts[1]), (dif, spec)

    args = [jnp.asarray(p[k]) for k in ("kd", "arm", "nrm")] + [jnp.asarray(wo)]
    gj, (dj, sj) = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    leaves = [t(x).requires_grad_() for x in (p["kd"], p["arm"], p["nrm"], wo)]
    dt, st = es.eval_bsdf(*leaves, t(wi))
    ((dt * t(wts[0])).sum() + (st * t(wts[1])).sum()).backward()
    np.testing.assert_allclose(n(dt), np.asarray(dj), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(n(st), np.asarray(sj), rtol=1e-5, atol=1e-7)
    for name, a, b in zip(("kd", "arm", "nrm", "wo"), leaves, gj):
        np.testing.assert_allclose(n(a.grad), np.asarray(b), rtol=1e-4, atol=1e-6, err_msg=name)

    @jax.jit
    def samplers_j(nj, wj, wi_, u_, alpha_):
        return (*jes._cosine_sample(nj, u_[0], u_[1]),
                *jes._ggx_vndf_sample(nj, wj, u_[0], u_[1], alpha_),
                jes._ggx_vndf_pdf(nj, wj, wi_, alpha_), jes._bsdf_pdf(u_[2], nj, wj, wi_, alpha_))

    nt, wt = t(p["nrm"]), t(wo)
    got = (*es._cosine_sample(nt, t(u[0]), t(u[1])),
           *es._ggx_vndf_sample(nt, wt, t(u[0]), t(u[1]), t(alpha)),
           es._ggx_vndf_pdf(nt, wt, t(wi), t(alpha)),
           es._bsdf_pdf(t(u[2]), nt, wt, t(wi), t(alpha)))
    want = samplers_j(*(jnp.asarray(x) for x in (p["nrm"], wo, wi, u, alpha)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shadows", [False, True], ids=["unshadowed", "sdf_shadows"])
def test_env_shade_matches_jax(points, shadows):
    p = points
    key = jax.random.key(7)
    draws = jax_shade_draws(key, NPTS, 2)
    data = light_table()
    sdf = sphere_sdf()
    rng = np.random.default_rng(3)
    wts = [rng.normal(size=s).astype(np.float32) for s in ((NPTS, 3), (NPTS, 3), (NPTS, 2))]

    def loss_j(pos, nrm, kd, arm, x):
        vis = jvis(jnp.asarray(sdf), GRID, 1.0, num_steps=8) if shadows else None
        out = jes.env_shade(key, pos, nrm, jnp.asarray(p["view"]), kd, arm,
                            jes.compute_light_pdf(x), num_samples_x=2, visibility_fn=vis)
        return sum(jnp.sum(o * w) for o, w in zip(out, wts)), out

    names = ("pos", "nrm", "kd", "arm")
    args = [jnp.asarray(p[k]) for k in names] + [jnp.asarray(data)]
    gj, out_j = jax.jit(jax.grad(loss_j, argnums=tuple(range(5)), has_aux=True))(*args)

    leaves = [t(p[k]).requires_grad_() for k in names] + [t(data).requires_grad_()]
    vis = make_sdf_visibility(t(sdf), GRID, 1.0, num_steps=8) if shadows else None
    out_t = es.env_shade(leaves[0], leaves[1], t(p["view"]), leaves[2], leaves[3],
                         es.compute_light_pdf(leaves[4]), shade_draws(draws), visibility_fn=vis)
    sum((o * t(w)).sum() for o, w in zip(out_t, wts)).backward()

    for name, a, b in zip(("diffuse", "specular", "residual"), out_t, out_j):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-4, atol=1e-6, err_msg=name)
    resi = n(out_t[2])
    assert (resi.max() > 1e-3) == shadows  # the sphere shadows some samples
    for name, leaf, g in zip(names + ("latlng",), leaves, gj):
        close_grads(name, n(leaf.grad), np.asarray(g))


def test_sdf_visibility_matches_jax():
    sdf = sphere_sdf()
    rng = np.random.default_rng(4)
    m = 400
    d = rng.normal(size=(m, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    origins = (d * rng.uniform(0.35, 0.8, (m, 1))).astype(np.float32)
    dirs = rng.normal(size=(m, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    vj = jax.jit(lambda s, o, d: jvis(s, GRID, 1.0, num_steps=24)(o, d))(sdf, origins, dirs)
    vt = make_sdf_visibility(t(sdf), GRID, 1.0, num_steps=24)(t(origins), t(dirs))
    np.testing.assert_allclose(n(vt), np.asarray(vj), rtol=1e-5, atol=1e-5)
    assert (n(vt) < 0.5).any() and (n(vt) > 0.99).any()  # some rays hit, some escape
    # the trilinear lookup inside and outside the grid's box
    pts = rng.uniform(-1.4, 1.4, (m, 3)).astype(np.float32)
    np.testing.assert_allclose(n(sample_sdf_grid(t(sdf), GRID, 1.0, t(pts))),
                               np.asarray(jsample_sdf(jnp.asarray(sdf), GRID, 1.0,
                                                      jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,sigma", [((1, 300, 8), 2.0), ((4, 5, 3), 0.5)],
                         ids=["gaussian_axis", "image"])
def test_bilateral_denoise_matches_jax(shape, sigma):
    rng = np.random.default_rng(5)
    col = rng.uniform(size=shape).astype(np.float32)
    nrm = rng.normal(size=shape[:2] + (3,)) * 0.2 + np.array([0.0, 0.0, 1.0])
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    depth = (2.0 + 0.05 * rng.normal(size=shape[:2] + (1,))).astype(np.float32)
    wts = rng.normal(size=shape).astype(np.float32)
    def loss_j(c):
        out = jdenoise(c, nrm, depth, sigma=sigma)
        return jnp.sum(out * wts), out

    gj, out_j = jax.jit(jax.grad(loss_j, has_aux=True))(jnp.asarray(col))
    leaves = [t(x).requires_grad_() for x in (col, nrm, depth)]
    out_t = bilateral_denoise(*leaves, sigma=sigma)
    (out_t * t(wts)).sum().backward()
    np.testing.assert_allclose(n(out_t), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(leaves[0].grad), np.asarray(gj), rtol=1e-4, atol=1e-5)
    assert leaves[1].grad is None and leaves[2].grad is None  # the guides are constants


def test_cubemap_to_latlng_matches_jax():
    rng = np.random.default_rng(6)
    cube = rng.uniform(0.1, 1.0, (6, 8, 8, 3)).astype(np.float32)
    wts = rng.normal(size=(32, 64, 3)).astype(np.float32)
    def loss_j(c):
        out = jcubemap_to_latlng(c, 32, 64)
        return jnp.sum(out * wts), out

    gj, out_j = jax.jit(jax.grad(loss_j, has_aux=True))(jnp.asarray(cube))
    x = t(cube).requires_grad_()
    out_t = cubemap_to_latlng(x, 32, 64)
    (out_t * t(wts)).sum().backward()
    np.testing.assert_allclose(n(out_t), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(x.grad), np.asarray(gj), rtol=1e-4, atol=1e-5)
    assert tuple(cubemap_to_latlng(x.detach()).shape) == (256, 512, 3)
