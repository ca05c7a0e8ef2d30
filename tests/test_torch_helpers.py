"""Port parity: the graphics helpers against their JAX functions on the CPU.

``images.resize`` for every method ``jax.image.resize`` takes (shrinking,
enlarging, odd sizes, one axis unchanged, a batch dimension), ``images.psnr``,
``Cameras.projection_matrix`` and ``Cameras.resize``, and
``Splats.from_points`` (the quaternions' normal draws injected from
jax.random), ``Splats.cov3d_half`` / ``cov3d``.

Tolerances: ``resize`` 1e-5 absolute on [0, 1] images ("nearest" exactly:
it copies pixels); the PSNR rtol 1e-6; the matrices rtol 1e-6 (atol 1e-6
for the entries that are sums of cancelling terms); ``from_points`` equal
but for the knn log-scales (rtol 1e-5 as tests/test_torch_gsplat.py holds
``Splats.random``'s, with atol 1e-6 for the logs near 0) and the
normalised quaternions (1e-7); the covariances rtol 1e-5 (atol 1e-6 for
the isotropic ones' cancelling off-diagonal entries)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics import images as jimages
from geosplatting_tpu.graphics import splats as jsplats
from geosplatting_tpu.graphics.cameras import Cameras as JCameras
from geosplatting_tpu_torch.graphics import images
from geosplatting_tpu_torch.graphics.splats import Splats

from .torch_parity import cameras_from_jax, n, one_torch_thread, t  # noqa: F401

METHODS = ("nearest", "linear", "bilinear", "trilinear", "triangle", "cubic", "bicubic",
           "tricubic", "lanczos3", "lanczos5")
# (lead, h, w, height, width): shrink, enlarge, both at once with odd
# sizes, one axis unchanged, down to a single pixel, a batch dimension
SHAPES = (((), 17, 23, 8, 11), ((), 8, 11, 17, 23), ((2,), 40, 32, 31, 47),
          ((), 13, 9, 13, 20), ((), 7, 5, 1, 3), ((2, 3), 5, 3, 16, 9))


@pytest.mark.parametrize("method", METHODS)
def test_resize_matches_jax(method):
    rng = np.random.default_rng(len(method))
    for lead, h, w, height, width in SHAPES:
        img = rng.uniform(0.0, 1.0, lead + (h, w, 3)).astype(np.float32)
        want = np.asarray(jax.jit(jimages.resize, static_argnums=(1, 2, 3))(
            img, height, width, method))
        got = n(images.resize(t(img), height, width, method))
        assert got.shape == want.shape == lead + (height, width, 3)
        if method == "nearest":
            np.testing.assert_array_equal(got, want, err_msg=str((h, w, height, width)))
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                       err_msg=str((h, w, height, width)))


def test_resize_names_its_methods():
    with pytest.raises(ValueError, match="lanczos3"):
        images.resize(torch.zeros((4, 4, 3)), 2, 2, "area")


def test_psnr_matches_jax():
    rng = np.random.default_rng(1)
    a, b = rng.uniform(0, 1, (2, 9, 7, 3)).astype(np.float32)
    for max_val in (1.0, 2.0):
        np.testing.assert_allclose(float(images.psnr(t(a), t(b), max_val)),
                                   float(jimages.psnr(jnp.asarray(a), jnp.asarray(b), max_val)),
                                   rtol=1e-6)
    assert float(images.psnr(t(a), t(a))) == pytest.approx(120.0)


def jax_cameras():
    """Orbit cameras with an off-centre principal point and fx != fy."""
    c = JCameras.from_orbit(center=jnp.zeros(3), radius=2.5, elevation_degrees=20.0,
                            num_samples=3, width=48, height=36, near=0.05, far=40.0)
    return c.replace(fx=c.fx * 1.1, cx=c.cx + 2.5, cy=c.cy - 1.5)


def test_projection_matrix_and_resize_match_jax():
    cj = jax_cameras()
    ct = cameras_from_jax(cj)
    np.testing.assert_allclose(n(ct.projection_matrix), np.asarray(cj.projection_matrix),
                               rtol=1e-6, atol=1e-6)
    # a point in front of the camera lands inside the clip volume's depth range
    p = n(ct.projection_matrix)[0] @ np.array([0.1, -0.2, 3.0, 1.0])
    assert -1.0 < p[2] / p[3] < 1.0
    for w, h in ((24, 18), (100, 50)):
        rj, rt = cj.resize(w, h), ct.resize(w, h)
        assert (rt.width, rt.height) == (rj.width, rj.height) == (w, h)
        for k in ("fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(n(getattr(rt, k)), np.asarray(getattr(rj, k)), rtol=1e-7,
                                       err_msg=k)
        np.testing.assert_allclose(n(rt.intrinsic_matrix), np.asarray(rj.intrinsic_matrix),
                                   rtol=1e-7)
        np.testing.assert_allclose(n(rt.projection_matrix), np.asarray(rj.projection_matrix),
                                   rtol=1e-6, atol=1e-6)


def test_from_points_and_covariances_match_jax():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    key = jax.random.key(3)
    sj = jsplats.Splats.from_points(key, jnp.asarray(pts), jnp.asarray(cols), sh_degree=2)
    st = Splats.from_points(t(pts), t(cols), sh_degree=2,
                            quat_normal=t(jax.random.normal(key, (200, 4))))
    assert st.shape == tuple(sj.shape) == (200,)
    assert st.sh_degree == sj.sh_degree == 2
    for k in ("means", "colors", "shs", "opacities"):
        np.testing.assert_array_equal(n(getattr(st, k)), np.asarray(getattr(sj, k)), err_msg=k)
    np.testing.assert_allclose(n(st.scales), np.asarray(sj.scales), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(st.quats), np.asarray(sj.quats), atol=1e-7)
    np.testing.assert_allclose(n(st.cov3d_half()), np.asarray(sj.cov3d_half()), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(n(st.cov3d()), np.asarray(sj.cov3d()), rtol=1e-5, atol=1e-6)
    # drawn from a generator: unit quaternions, the same knn scales
    g = Splats.from_points(t(pts), t(cols), sh_degree=0,
                           generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(np.linalg.norm(n(g.quats), axis=-1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(n(g.scales), n(st.scales))
