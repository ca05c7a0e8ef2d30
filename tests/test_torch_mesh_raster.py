"""Port parity: ops/mesh_raster (``rasterize_mesh``, ``interpolate``)
against the JAX package on the CPU, on the cases of tests/test_mesh_raster.py
(a single triangle, a sphere's silhouette, occlusion, interpolation
gradients) and the budget observables.

Tolerances: triangle ids equal except at exact depth ties (there the two
packages' depths agree to 1e-6 relative and their orders of equal keys
may differ), barycentrics and depths 1e-5, interpolated positions 1e-5 and
their vertex gradients 1e-4 relative to the largest entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics import flexicubes as jfc
from geosplatting_tpu.graphics.cameras import Cameras as JCameras
from geosplatting_tpu.graphics.mesh import TriangleMesh as JMesh
from geosplatting_tpu.ops import mesh_raster as jmr
from geosplatting_tpu_torch.graphics.mesh import TriangleMesh
from geosplatting_tpu_torch.ops.mesh_raster import interpolate, rasterize_mesh

from .torch_parity import cameras_from_jax, n, one_torch_thread, t  # noqa: F401

W = H = 32


def camera(eye=(0.0, 2.2, 0.0)):
    return JCameras.from_lookat(jnp.array(eye), jnp.zeros(3), up=jnp.array([0.0, 0.0, 1.0]),
                                width=W, height=H, fov_degrees=45.0)


@pytest.fixture(scope="module")
def sphere():
    grid = jfc.make_grid(12, scale=1.0)
    sdf = jnp.linalg.norm(grid.base_vertices() - 0.013, axis=-1) - 0.5
    return jax.jit(lambda s: jfc.extract(grid, s).mesh)(sdf)


def to_torch(mesh: JMesh) -> TriangleMesh:
    mask = None if mesh.face_mask is None else t(mesh.face_mask, torch.bool)
    return TriangleMesh(vertices=t(mesh.vertices), indices=t(mesh.indices, torch.int64),
                        face_mask=mask)


@jax.jit
def jax_interpolate(mesh, out):
    return jmr.interpolate(mesh.vertices, mesh, out)


def compare(mesh_j, cam_j, capacity):
    # jitted: the eager JAX raster compiles each of its operations on its own
    out_j = jax.jit(lambda m, c: jmr.rasterize_mesh(m, c, tile_capacity=capacity))(mesh_j, cam_j)
    out_t, info = rasterize_mesh(to_torch(mesh_j), cameras_from_jax(cam_j),
                                 tile_capacity=capacity)
    tri_j, tri_t = np.asarray(out_j.tri_id), n(out_t.tri_id)
    same = tri_t == tri_j
    # a different winner only where both depths tie
    np.testing.assert_allclose(n(out_t.depth)[~same], np.asarray(out_j.depth)[~same],
                               rtol=1e-6)
    assert same.mean() > 0.99
    np.testing.assert_allclose(n(out_t.bary)[same], np.asarray(out_j.bary)[same], atol=1e-5)
    np.testing.assert_allclose(n(out_t.depth), np.asarray(out_j.depth), rtol=1e-5, atol=1e-5)
    pos_j = jax_interpolate(mesh_j, out_j)
    pos_t = interpolate(t(mesh_j.vertices), to_torch(mesh_j), out_t)
    np.testing.assert_allclose(n(pos_t)[same], np.asarray(pos_j)[same], atol=1e-5)
    return out_t, info, tri_j


def test_single_triangle():
    mesh = JMesh(vertices=jnp.array([[-0.5, 0.0, -0.5], [0.5, 0.0, -0.5], [0.0, 0.0, 0.5]]),
                 indices=jnp.array([[0, 1, 2]], jnp.int32))
    out, info, _ = compare(mesh, camera(), 16)
    hit = n(out.tri_id) >= 0
    assert hit.sum() > 50
    np.testing.assert_allclose(n(out.depth)[hit], 2.2, atol=1e-3)
    assert (info.max_tile_triangles, info.total_pairs) == (1, int(info.total_pairs))
    assert 0 < info.tile_fill <= 1 and 0 < info.pair_fill <= 1


def test_sphere_silhouette(sphere):
    # a little off the axis: seen along it, the sphere's grid edges run
    # exactly through pixel centres, where the inside test is a rounding tie
    cam_j = camera((0.031, 2.2, -0.017))
    out, info, tri_j = compare(sphere, cam_j, 256)
    cam = cameras_from_jax(cam_j)
    origins, dirs = cam.generate_rays()
    b = (origins * dirs).sum(-1)
    analytic = n((b * b - ((origins * origins).sum(-1) - 0.25)) > 0)
    assert (analytic == (n(out.tri_id) >= 0)).mean() > 0.95
    # both windings are accepted (no culling), and the budgets held
    assert info.tile_fill <= 1 and info.pair_fill <= 1 and info.max_tile_triangles > 1


def test_occlusion_and_tile_capacity():
    mesh = JMesh(
        vertices=jnp.array([[-1.0, 0.0, -1.0], [1.0, 0.0, -1.0], [0.0, 0.0, 1.0],
                            [-1.0, 1.0, -1.0], [1.0, 1.0, -1.0], [0.0, 1.0, 1.0]]),
        indices=jnp.array([[0, 1, 2], [3, 4, 5]], jnp.int32))
    out, info, _ = compare(mesh, camera(), 16)
    hit = n(out.tri_id)
    assert (hit[hit >= 0] == 1).all()
    # a capacity of one keeps each tile's nearest triangle only, as JAX does
    out1, info1, _ = compare(mesh, camera(), 1)
    assert info1.tile_fill == 2.0 and (n(out1.tri_id) == n(out.tri_id)).all()


def test_interpolate_gradients(sphere):
    cam_j = camera((0.3, 2.0, 0.4))

    def loss_j(verts):
        m = sphere.replace(vertices=verts)
        return jnp.sum(jmr.interpolate(m.vertices, m, jmr.rasterize_mesh(m, cam_j,
                                                                         tile_capacity=128)) ** 2)

    g_j = np.asarray(jax.jit(jax.grad(loss_j))(sphere.vertices))
    mesh_t = to_torch(sphere)
    verts = mesh_t.vertices.clone().requires_grad_(True)
    m = TriangleMesh(vertices=verts, indices=mesh_t.indices, face_mask=mesh_t.face_mask)
    out, _ = rasterize_mesh(m, cameras_from_jax(cam_j), tile_capacity=128)
    (interpolate(verts, m, out) ** 2).sum().backward()
    g_t = n(verts.grad)
    assert np.isfinite(g_t).all() and np.abs(g_t).sum() > 0
    np.testing.assert_allclose(g_t, g_j, atol=1e-4 * np.abs(g_j).max())
