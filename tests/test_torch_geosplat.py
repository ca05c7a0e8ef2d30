"""Port parity: GeoSplatter weights carried over with params_from_numpy, then
render in face and vertex sampling against the JAX package.

JAX renders through its pairs backend with the Pallas kernels in interpret
mode (as tests/test_geosplat_stage1.py runs them on the CPU); the port
through the plain versions of its kernels. The
jitter noise is drawn with jax.random exactly as geosplat.py:860,498 draws
it and handed to both. Images: atol 1e-3 (transmittance-cutoff flips,
tests/test_rasterize_pallas.py:53). Gradients: each parameter group sums
the rasterizer's per-Gaussian gradients of thousands of Gaussians, so the
cutoff flips and the two rasterizers' summation orders add up; a group must
agree to 1% in L2 norm and to 2% of its largest entry everywhere."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.models.encodings import TriplaneEncoding as JTriplane
from geosplatting_tpu.models.geosplat import GeoSplatter as JGeoSplatter
from geosplatting_tpu.models.geosplat import SharedField as JSharedField
from geosplatting_tpu.ops import rasterize_pairs as jrp
from geosplatting_tpu_torch.convert import params_from_numpy, params_to_numpy
from geosplatting_tpu_torch.models.geosplat import GeoSplatter

from .torch_parity import cameras_from_jax, jax_orbit, n, one_torch_thread, t  # noqa: F401


@pytest.fixture(autouse=True)
def jax_pairs_interpret():
    old = jrp._INTERPRET
    jrp._INTERPRET = True
    yield
    jrp._INTERPRET = old

W = H = 48
CONFIG = dict(resolution=12, light_resolution=32, scale=1.0, max_render_faces=2048,
              pairs_per_gaussian=4)


def jax_model():
    field = JSharedField(trunk=JTriplane(resolution=32, num_components=32, init_scale=0.03))
    return JGeoSplatter(field=field, backend="pairs", **CONFIG)


def torch_model(params_np):
    m = GeoSplatter(triplane_resolution=32, device="cpu", **CONFIG)
    m.load_state_dict(params_from_numpy(params_np))
    return m


def setup():
    mj = jax_model()
    params = mj.init(jax.random.key(0))
    grid = mj.make_grid()
    # off-grid sphere: an SDF within ulps of 0 at grid vertices makes the
    # crossing positions (and JAX's own eager vs jit gradients) ill-conditioned
    params["sdf"] = jnp.linalg.norm(grid.base_vertices() - 0.03, axis=-1) - 0.47
    rng = np.random.default_rng(0)
    params["deform"] = jnp.asarray(rng.normal(size=params["deform"].shape) * 0.1, jnp.float32)
    params["weights"] = jnp.asarray(rng.normal(size=params["weights"].shape) * 0.1, jnp.float32)
    # a smooth environment: split-sum lookups pick the NEAREST texel, and an
    # ulp-level direction difference that flips the texel must not swing
    # the shading of a Gaussian by more than a fraction of a percent. The
    # channel term is not affine, so no channel equals the texel's channel
    # mean: there the white-balance |x| would be at its kink, and its
    # gradient the sign of a rounding residual
    f, i, j, c = np.meshgrid(*(np.arange(k) for k in params["cubemap"].shape), indexing="ij")
    r = params["cubemap"].shape[1]
    params["cubemap"] = jnp.asarray(0.3 + 0.3 * (i + j) / (2 * r) + 0.05 * f + 0.1 * c * c,
                                    jnp.float32)
    cams = jax_orbit(radius=2.0, elevation_degrees=10.0, num_samples=2, width=W, height=H)
    return mj, params, cams


def face_noise(key, mt):
    """The jitter draw of geosplat.py:860 (k_field) and :498."""
    k_field, _ = jax.random.split(key)
    mesh, _, _ = mt.get_geometry()
    return jax.random.normal(k_field, (mt.num_field_points(mesh), 3))


def close_grads(name, got, want, l2=1e-2, worst=2e-2):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), name
    rel = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30)
    assert rel < l2, f"{name}: relative L2 error {rel}"
    top = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
    assert top < worst, f"{name}: largest error {top} of the largest entry"


def test_params_round_trip():
    mj, params, _ = setup()
    tree = jax.tree.map(np.asarray, params)
    mt = torch_model(tree)
    back = params_to_numpy(mt.state_dict())
    flat_a, _ = jax.tree_util.tree_flatten(tree)
    flat_b, _ = jax.tree_util.tree_flatten(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sampling", ["face", "vertex"])
def test_render_matches_jax(sampling):
    mj, params, cams = setup()
    mt = torch_model(jax.tree.map(np.asarray, params))
    key = jax.random.key(1)
    rw = {"sdf": 0.2, "light": 2e-3, "kd_grad": 0.01, "ks_grad": 0.001}
    noise = t(face_noise(key, mt)) if sampling == "face" else None
    wimg = np.random.default_rng(3).normal(size=(2, H, W, 4)).astype(np.float32)

    def loss_j(p):
        rgba, reg, aux = mj.render(p, cams, key, reg_weights=rw, sampling=sampling)
        return jnp.sum(rgba * wimg) + reg * 100.0, (rgba, reg, aux)

    g_j, (rgba_j, reg_j, aux_j) = jax.jit(jax.grad(loss_j, has_aux=True))(params)
    rgba_t, reg_t, aux_t = mt.render(cameras_from_jax(cams), reg_weights=rw, sampling=sampling,
                                     jitter_noise=noise)
    ((rgba_t * t(wimg)).sum() + reg_t * 100.0).backward()

    np.testing.assert_allclose(n(rgba_t), np.asarray(rgba_j), atol=1e-3)
    np.testing.assert_allclose(float(reg_t.detach()), float(reg_j), rtol=1e-4)
    for k in ("num_gaussians", "num_surf_cubes", "num_surf_edges", "num_faces_valid",
              "total_pairs", "max_pairs"):
        assert int(aux_t[k]) == int(aux_j[k]), k
    assert int(aux_t["num_gaussians"]) > 0
    named = dict(mt.named_parameters())
    tree_t = params_to_numpy({k: v.grad for k, v in named.items()})
    for path, gj in jax.tree_util.tree_flatten_with_path(g_j)[0]:
        gt = tree_t
        for p in path:
            gt = gt[p.key]
        close_grads(jax.tree_util.keystr(path), gt, gj)

