"""Port parity: the stage-1 cubemap path — prefilter_splitsum(conv), the
nearest split-sum lookup over the mip atlas, fg_analytic, and gradients into
the cubemap — against the JAX package. Tolerances: 1e-5 (f32 reassociation;
the diffuse prefilter is a dense matmul)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.ops import cubemap as jcm
from geosplatting_tpu_torch.ops import cubemap as cm

from .torch_parity import n, one_torch_thread, t  # noqa: F401


def env(res, seed=0):
    return np.random.default_rng(seed).uniform(0.05, 1.0, (6, res, res, 3)).astype(np.float32)


def lookups(num=500, seed=1):
    rng = np.random.default_rng(seed)
    normals = rng.normal(size=(num, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    dirs = rng.normal(size=(num, 3)).astype(np.float32)
    rough = rng.uniform(0.0, 1.0, (num, 1)).astype(np.float32)
    return normals, dirs, rough


@pytest.mark.parametrize("res", [32, 64])
def test_prefilter_conv_matches_jax(res):
    cube = env(res)
    base_j, mips_j = jax.jit(lambda c: jcm.prefilter_splitsum(c, method="conv"))(cube)
    base_t, mips_t = cm.prefilter_splitsum(t(cube))
    np.testing.assert_allclose(n(base_t), np.asarray(base_j), rtol=1e-5, atol=1e-5)
    assert len(mips_t) == len(mips_j)
    for mj, mt in zip(mips_j, mips_t):
        np.testing.assert_allclose(n(mt), np.asarray(mj), rtol=1e-5, atol=1e-5)


def test_sample_splitsum_nearest_and_fg_match_jax():
    base, mips = cm.prefilter_splitsum(t(env(64)))
    normals, dirs, rough = lookups()
    _, spec_j = jcm.sample_splitsum(
        jnp.asarray(n(base)), [jnp.asarray(n(m)) for m in mips], jnp.asarray(normals),
        jnp.asarray(dirs), jnp.asarray(rough), with_diffuse=False,
        filter_mode="nearest", mip_filter="nearest")
    _, spec_t = cm.sample_splitsum(base, mips, t(normals), t(dirs), t(rough),
                                   with_diffuse=False)
    np.testing.assert_allclose(n(spec_t), np.asarray(spec_j), rtol=1e-6, atol=1e-6)
    nv = np.abs(normals[:, :1])
    np.testing.assert_allclose(n(cm.fg_analytic(t(nv), t(rough))),
                               np.asarray(jcm.fg_analytic(jnp.asarray(nv), jnp.asarray(rough))),
                               rtol=1e-6, atol=1e-6)
    diff_j = jcm.sample_cubemap(jnp.asarray(n(base)), jnp.asarray(normals))
    np.testing.assert_allclose(n(cm.sample_cubemap(base, t(normals))), np.asarray(diff_j),
                               rtol=1e-5, atol=1e-5)


def test_cubemap_gradients_match_jax():
    cube = env(64, seed=3)
    normals, dirs, rough = lookups(seed=4)
    w = np.random.default_rng(5).normal(size=(500, 3)).astype(np.float32)

    def loss_j(c):
        base, mips = jcm.prefilter_splitsum(c, method="conv")
        _, spec = jcm.sample_splitsum(base, mips, jnp.asarray(normals), jnp.asarray(dirs),
                                      jnp.asarray(rough), with_diffuse=False,
                                      filter_mode="nearest", mip_filter="nearest")
        diff = jcm.sample_cubemap(base, jnp.asarray(normals))
        return jnp.sum(spec * w) + jnp.sum(diff * w)

    g_j = jax.jit(jax.grad(loss_j))(jnp.asarray(cube))
    c = t(cube).requires_grad_()
    base, mips = cm.prefilter_splitsum(c)
    _, spec = cm.sample_splitsum(base, mips, t(normals), t(dirs), t(rough), with_diffuse=False)
    ((spec * t(w)).sum() + (cm.sample_cubemap(base, t(normals)) * t(w)).sum()).backward()
    np.testing.assert_allclose(n(c.grad), np.asarray(g_j), rtol=1e-4, atol=1e-6)
