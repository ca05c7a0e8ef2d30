"""Port parity: ops/projection.project forward and autograd gradients, and
the graphics/gmath rotations, against the JAX package (f32; tolerances from
the ulp-level differences of two f32 implementations)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics import gmath as jgmath
from geosplatting_tpu.graphics.cameras import Cameras as JCameras
from geosplatting_tpu.ops.projection import project as jproject
from geosplatting_tpu_torch.graphics import gmath
from geosplatting_tpu_torch.ops.projection import project

from .torch_parity import n, one_torch_thread, t  # noqa: F401

W, H = 64, 48


def inputs(seed=0, num=200):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (num, 3)).astype(np.float32)
    quats = rng.normal(size=(num, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-4.5, -1.5, (num, 3))).astype(np.float32)
    opac = rng.uniform(0.01, 0.95, (num,)).astype(np.float32)
    c = JCameras.from_lookat(jnp.array([2.0, 1.0, 1.5]), jnp.zeros(3), width=W, height=H)
    return means, quats, scales, opac, np.asarray(c.view_matrix), np.asarray(c.intrinsic_matrix)


@pytest.mark.parametrize("mode", ["antialiased", "classic"])
def test_projection_forward_matches_jax(mode):
    arrays = inputs()
    pj = jproject(*(jnp.asarray(a) for a in arrays), W, H, rasterize_mode=mode)
    pt = project(*(t(a) for a in arrays), W, H, rasterize_mode=mode)
    for name in ("means2d", "depths", "conics", "opacities", "extents", "prune_r"):
        np.testing.assert_allclose(n(getattr(pt, name)), np.asarray(getattr(pj, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(n(pt.radii), np.asarray(pj.radii))


def test_projection_gradients_match_jax():
    arrays = inputs(1)
    rng = np.random.default_rng(2)
    w2, w3, w1 = (rng.normal(size=s).astype(np.float32) for s in ((200, 2), (200, 3), (200,)))

    def loss_j(m, q, s, o):
        p = jproject(m, q, s, o, *(jnp.asarray(a) for a in arrays[4:]), W, H,
                     rasterize_mode="antialiased")
        keep = (p.radii > 0).astype(jnp.float32)
        return (jnp.sum(keep[:, None] * p.means2d * w2)
                + jnp.sum(keep[:, None] * p.conics * w3) * 1e-3
                + jnp.sum(keep * (p.opacities * w1 + p.depths * w1)))

    g_j = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrays[:4]))
    leaves = [t(a).requires_grad_() for a in arrays[:4]]
    p = project(*leaves, *(t(a) for a in arrays[4:]), W, H, rasterize_mode="antialiased")
    keep = (p.radii > 0).float()
    (torch.sum(keep[:, None] * p.means2d * t(w2))
     + torch.sum(keep[:, None] * p.conics * t(w3)) * 1e-3
     + torch.sum(keep * (p.opacities * t(w1) + p.depths * t(w1)))).backward()
    for name, gj, lt in zip(("means", "quats", "scales", "opacities"), g_j, leaves):
        scale = np.abs(np.asarray(gj)).max()
        np.testing.assert_allclose(n(lt.grad), np.asarray(gj), rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=name)


def test_gmath_rotations_match_jax():
    rng = np.random.default_rng(3)
    quats = rng.normal(size=(50, 4)).astype(np.float32)
    src = rng.normal(size=(50, 3)).astype(np.float32)
    dst = rng.normal(size=(50, 3)).astype(np.float32)
    rots = np.asarray(jgmath.quat2rot(jnp.asarray(quats)))
    # f32 rotation entries and unit quaternions: 1e-5 absolute
    np.testing.assert_allclose(n(gmath.quat2rot(t(quats))), rots, atol=1e-5)
    np.testing.assert_allclose(n(gmath.rot2quat(t(rots))),
                               np.asarray(jgmath.rot2quat(jnp.asarray(rots))), atol=1e-5)
    np.testing.assert_allclose(
        n(gmath.rotation_from_relative_vectors(t(src), t(dst))),
        np.asarray(jgmath.rotation_from_relative_vectors(jnp.asarray(src), jnp.asarray(dst))),
        atol=1e-5)
