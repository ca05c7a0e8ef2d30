"""Port parity: the exact-quality environment path — the sampled GGX
prefilter, bilinear / trilinear split-sum lookups, the FG LUT and its
lookup — and GeoSplatter's exact-quality render, against the JAX package.

Tolerances: prefilter and lookups 1e-5 (f32 sums in another order); the LUT
is the same float64 numpy integration, so it is equal; the render atol
1e-3 as in tests/test_torch_geosplat.py (transmittance-cutoff flips,
tests/test_rasterize_pallas.py:53), its regularization rtol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geosplatting_tpu.graphics.cameras import Cameras as JCameras
from geosplatting_tpu.models.encodings import TriplaneEncoding as JTriplane
from geosplatting_tpu.models.geosplat import GeoSplatter as JGeoSplatter
from geosplatting_tpu.models.geosplat import SharedField as JSharedField
from geosplatting_tpu.ops import cubemap as jcm
from geosplatting_tpu.ops import rasterize_pairs as jrp
from geosplatting_tpu_torch.convert import params_from_numpy
from geosplatting_tpu_torch.models.geosplat import GeoSplatter
from geosplatting_tpu_torch.ops import cubemap as cm

from .torch_parity import cameras_from_jax, n, one_torch_thread, t  # noqa: F401


def env(res, seed=0):
    return np.random.default_rng(seed).uniform(0.05, 1.0, (6, res, res, 3)).astype(np.float32)


def test_sampled_prefilter_matches_jax():
    cube = env(32, seed=32)   # two mips: 32 (roughness 0.08) and 16 (1.0)
    base_j, mips_j = jax.jit(lambda c: jcm.prefilter_splitsum(c, method="sampled"))(
        jnp.asarray(cube))
    base_t, mips_t = cm.prefilter_splitsum(t(cube), method="sampled")
    np.testing.assert_allclose(n(base_t), np.asarray(base_j), rtol=1e-5, atol=1e-5)
    assert len(mips_t) == len(mips_j)
    for mj, mt in zip(mips_j, mips_t):
        np.testing.assert_allclose(n(mt), np.asarray(mj), rtol=1e-5, atol=1e-5)


def test_sampled_prefilter_in_chunks_matches_one_pass(monkeypatch):
    """The sample chunking that bounds memory at full resolution changes
    only the order of the sums."""
    chain = cm.build_mip_chain(t(env(32, seed=7)))
    whole = cm.specular_prefilter(chain, 0.3)
    monkeypatch.setattr(cm, "_PREFILTER_CHUNK_ELEMS", 6 * 32 * 32 * 5)
    np.testing.assert_allclose(n(cm.specular_prefilter(chain, 0.3)), n(whole),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("filter_mode,mip_filter", [
    ("bilinear", "trilinear"), ("bilinear", "nearest"), ("nearest", "trilinear"),
])
def test_sample_splitsum_filters_match_jax(filter_mode, mip_filter):
    base, mips = cm.prefilter_splitsum(t(env(32)), method="sampled")
    rng = np.random.default_rng(1)
    normals = rng.normal(size=(500, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    dirs = rng.normal(size=(500, 3)).astype(np.float32)
    rough = rng.uniform(0.0, 1.0, (500, 1)).astype(np.float32)
    diff_j, spec_j = jax.jit(lambda *a: jcm.sample_splitsum(
        *a, filter_mode=filter_mode, mip_filter=mip_filter))(
        n(base), [n(m) for m in mips], normals, dirs, rough)
    diff_t, spec_t = cm.sample_splitsum(base, mips, t(normals), t(dirs), t(rough),
                                        filter_mode=filter_mode, mip_filter=mip_filter)
    np.testing.assert_allclose(n(spec_t), np.asarray(spec_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(diff_t), np.asarray(diff_j), rtol=1e-5, atol=1e-5)


def test_fg_lut_and_lookup_match_jax():
    (lut_t,) = cm.fg_lut(256)
    (lut_j,) = jcm.fg_lut(256)
    np.testing.assert_array_equal(lut_t, lut_j)
    rng = np.random.default_rng(2)
    # n.v and roughness past both ends of the table, and inside it
    nv = rng.uniform(-0.1, 1.1, (1000, 1)).astype(np.float32)
    rough = rng.uniform(-0.1, 1.1, (1000, 1)).astype(np.float32)
    np.testing.assert_allclose(n(cm.sample_fg_lut(t(nv), t(rough))),
                               np.asarray(jcm.sample_fg_lut(jnp.asarray(nv), jnp.asarray(rough))),
                               rtol=1e-6, atol=1e-6)


# --- GeoSplatter.render(quality="exact") -------------------------------------

W = H = 48
CONFIG = dict(resolution=12, light_resolution=32, scale=1.0, max_render_faces=2048,
              pairs_per_gaussian=4)


@pytest.fixture
def jax_pairs_interpret():
    old = jrp._INTERPRET
    jrp._INTERPRET = True
    yield
    jrp._INTERPRET = old


def test_exact_render_matches_jax(jax_pairs_interpret):
    field = JSharedField(trunk=JTriplane(resolution=32, num_components=32, init_scale=0.03))
    mj = JGeoSplatter(field=field, backend="pairs", **CONFIG)
    params = mj.init(jax.random.key(0))
    # an off-grid sphere (see tests/test_torch_geosplat.py) under a smooth,
    # non-constant environment
    params["sdf"] = jnp.linalg.norm(mj.make_grid().base_vertices() - 0.03, axis=-1) - 0.47
    f, i, j, c = np.meshgrid(*(np.arange(k) for k in params["cubemap"].shape), indexing="ij")
    r = params["cubemap"].shape[1]
    params["cubemap"] = jnp.asarray(0.3 + 0.3 * (i + j) / (2 * r) + 0.05 * f + 0.1 * c * c,
                                    jnp.float32)
    cams = JCameras.from_orbit(center=jnp.zeros(3), radius=2.0, elevation_degrees=10.0,
                               num_samples=2, width=W, height=H)
    key = jax.random.key(1)
    rgba_j, reg_j, aux_j = jax.jit(lambda p: mj.render(p, cams, key, quality="exact"))(params)
    rgba_f, _, _ = jax.jit(lambda p: mj.render(p, cams, key))(params)

    mt = GeoSplatter(triplane_resolution=32, device="cpu", **CONFIG)
    mt.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    # the jitter feeds only the smoothness terms: the JAX draw, for the reg
    k_field, _ = jax.random.split(key)
    mesh, _, _ = mt.get_geometry()
    noise = t(jax.random.normal(k_field, (mt.num_field_points(mesh), 3)))
    rgba_t, reg_t, aux_t = mt.render(cameras_from_jax(cams), jitter_noise=noise,
                                     quality="exact")
    np.testing.assert_allclose(n(rgba_t), np.asarray(rgba_j), atol=1e-3)
    np.testing.assert_allclose(float(reg_t.detach()), float(reg_j), rtol=1e-4)
    assert int(aux_t["num_gaussians"]) == int(aux_j["num_gaussians"]) > 0
    # the exact environment path changes the image, so the test sees it
    assert float(jnp.abs(rgba_j - rgba_f).max()) > 1e-2
