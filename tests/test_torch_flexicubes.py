"""Port parity: FlexiCubes extraction under the padded static layout — the
same buffers index for index, l_dev, sdf_entropy and gradients — against
the JAX package. Tolerances: 1e-5 on positions (f32 lerps), exact on
topology."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics import flexicubes as jfc
from geosplatting_tpu_torch.graphics import flexicubes as fc

from .torch_parity import n, one_torch_thread, t  # noqa: F401

RES = 12


def sphere_inputs(seed=0):
    grid = fc.make_grid(RES, scale=1.0, surf_cube_budget=8.0, surf_edge_budget=8.0)
    rng = np.random.default_rng(seed)
    v = n(grid.base_vertices())
    sdf = (np.linalg.norm(v - 0.05, axis=-1) - 0.5).astype(np.float32)
    deform = (rng.normal(size=(grid.num_vertices, 3)) * 0.3).astype(np.float32)
    weights = (rng.normal(size=(grid.num_cubes, 21)) * 0.3).astype(np.float32)
    return grid, sdf, deform, weights


def jgrid():
    return jfc.make_grid(RES, scale=1.0, surf_cube_budget=8.0, surf_edge_budget=8.0)


def test_dmc_tables_match():
    for a, b in zip(jfc._build_dmc_tables(), fc._build_dmc_tables()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(jfc._build_local_edge_slot(), fc._build_local_edge_slot())


def test_extract_buffers_match_jax():
    grid, sdf, deform, weights = sphere_inputs()
    np.testing.assert_array_equal(n(grid.base_vertices()), np.asarray(jgrid().base_vertices()))
    oj = jfc.extract(jgrid(), jnp.asarray(sdf), jnp.asarray(deform),
                     alpha=jnp.asarray(weights[:, :8]), beta=jnp.asarray(weights[:, 8:20]),
                     gamma=jnp.asarray(weights[:, 20:]))
    ot = fc.extract(grid, t(sdf), t(deform), alpha=t(weights[:, :8]),
                    beta=t(weights[:, 8:20]), gamma=t(weights[:, 20:]))
    assert int(oj.num_surf_cubes) == int(ot.num_surf_cubes) > 0
    assert int(oj.num_surf_edges) == int(ot.num_surf_edges) > 0
    np.testing.assert_array_equal(n(ot.mesh.face_mask), np.asarray(oj.mesh.face_mask))
    np.testing.assert_array_equal(n(ot.mesh.indices), np.asarray(oj.mesh.indices))
    np.testing.assert_allclose(n(ot.mesh.vertices), np.asarray(oj.mesh.vertices),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(ot.l_dev), float(oj.l_dev), rtol=1e-5)


def test_sdf_entropy_matches_jax():
    grid, sdf, _, _ = sphere_inputs()
    noisy = sdf + np.random.default_rng(3).normal(size=sdf.shape).astype(np.float32) * 0.2
    np.testing.assert_allclose(float(fc.sdf_entropy(grid, t(noisy))),
                               float(jfc.sdf_entropy(jgrid(), jnp.asarray(noisy))), rtol=1e-5)


def test_extract_gradients_match_jax():
    grid, sdf, deform, weights = sphere_inputs(1)
    rng = np.random.default_rng(2)
    nv = grid.max_surf_cubes * fc._build_dmc_tables()[2] + grid.max_surf_edges
    w = rng.normal(size=(nv, 3)).astype(np.float32)

    def loss_j(s, d, wt):
        o = jfc.extract(jgrid(), s, d, alpha=wt[:, :8], beta=wt[:, 8:20], gamma=wt[:, 20:])
        used = jnp.zeros(nv).at[o.mesh.indices.reshape(-1)].add(
            jnp.repeat(o.mesh.face_mask.astype(jnp.float32), 3)) > 0
        return (jnp.sum(jnp.where(used[:, None], o.mesh.vertices, 0.0) * w)
                + o.l_dev + jfc.sdf_entropy(jgrid(), s))

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (sdf, deform, weights)))
    leaves = [t(a).requires_grad_() for a in (sdf, deform, weights)]
    o = fc.extract(grid, leaves[0], leaves[1], alpha=leaves[2][:, :8],
                   beta=leaves[2][:, 8:20], gamma=leaves[2][:, 20:])
    used = torch.zeros(nv).index_add(0, o.mesh.indices.reshape(-1),
                                     o.mesh.face_mask.float().repeat_interleave(3)) > 0
    ((torch.where(used[:, None], o.mesh.vertices, 0.0) * t(w)).sum() + o.l_dev
     + fc.sdf_entropy(grid, leaves[0])).backward()
    for name, gj, lt in zip(("sdf", "deform", "weights"), g_j, leaves):
        gj = np.asarray(gj)
        assert np.abs(gj).sum() > 0, name
        np.testing.assert_allclose(n(lt.grad), gj, rtol=1e-4, atol=1e-5 * np.abs(gj).max(),
                                   err_msg=name)


@pytest.mark.parametrize("size", [5, 40])
def test_nonzero_padded_matches_jnp(size):
    mask = np.random.default_rng(size).uniform(size=30) > 0.5
    want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=size, fill_value=30)[0])
    np.testing.assert_array_equal(n(fc.nonzero_padded(torch.as_tensor(mask), size, 30)), want)
