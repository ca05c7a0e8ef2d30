"""Port parity: the mesh prior's geometry pieces against the JAX package on
the CPU: the three mesh regularizers (values and vertex gradients) on a
FlexiCubes sphere with its padded, masked faces, area-weighted surface
sampling with injected draws, the occupancy grid and the mesh visibility
marched through it, and the OBJ / PLY reader and writer.

The draws are jax.random's (the face ids of ``jax.random.categorical`` over
the log areas and the barycentric uniforms, graphics/mesh.py:75-84) handed
to the port. Tolerances: regularizer values rtol 1e-5, vertex gradients 1e-4
of the largest entry (sums over a few faces, rounded in another order);
surface samples atol 1e-6; the occupancy grid exactly (whole-sample counts);
visibility atol 1e-5; mesh files exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics import flexicubes as jfc
from geosplatting_tpu.graphics import mesh as jmesh
from geosplatting_tpu.graphics import mesh_io as jio
from geosplatting_tpu.ops import sdf_visibility as jvis
from geosplatting_tpu_torch.graphics import mesh as tmesh
from geosplatting_tpu_torch.graphics import mesh_io as tio
from geosplatting_tpu_torch.ops import sdf_visibility as tvis

from .torch_parity import n, one_torch_thread, t  # noqa: F401

RES = 8


@pytest.fixture(scope="module")
def sphere():
    """A FlexiCubes sphere (padded buffers, face_mask) with jittered
    vertices: (vertices, indices, face_mask) as numpy."""
    grid = jfc.make_grid(RES, scale=1.0, surf_cube_budget=8.0, surf_edge_budget=8.0)
    v = np.asarray(grid.base_vertices())
    sdf = jnp.asarray((np.linalg.norm(v - 0.05, axis=-1) - 0.55).astype(np.float32))
    out = jax.jit(lambda s: jfc.extract(grid, s, jnp.zeros((grid.num_vertices, 3))))(sdf)
    mesh = out.mesh
    rng = np.random.default_rng(0)
    verts = np.asarray(mesh.vertices)
    verts = (verts + rng.normal(size=verts.shape) * 0.01).astype(np.float32)
    mask = np.asarray(mesh.face_mask)
    assert 0 < mask.sum() < len(mask)   # padded: masked faces present
    return verts, np.asarray(mesh.indices), mask


def meshes(sphere, verts=None):
    v, f, mask = sphere
    v = v if verts is None else verts
    return (jmesh.TriangleMesh(vertices=jnp.asarray(v), indices=jnp.asarray(f),
                               face_mask=jnp.asarray(mask)),
            tmesh.TriangleMesh(vertices=t(v), indices=t(f, torch.long),
                               face_mask=t(mask, torch.bool)))


def surface_draws(mesh_j, key, num):
    """sample_surface's draws from ``key`` (graphics/mesh.py:77-79)."""
    _, areas = mesh_j.face_normals_and_areas()
    k1, k2 = jax.random.split(key)
    fid = jax.random.categorical(k1, jnp.log(areas + 1e-20), shape=(num,))
    uv = jax.random.uniform(k2, (num, 2))
    return t(fid, torch.long), t(uv)


@pytest.mark.parametrize("name", ["mesh_edge_loss", "uniform_laplacian_smoothing",
                                  "mesh_normal_consistency"])
def test_regularizers_match_jax(sphere, name):
    v, f, mask = sphere
    fn_j, fn_t = getattr(jmesh, name), getattr(tmesh, name)

    def loss_j(verts):
        return fn_j(jmesh.TriangleMesh(vertices=verts, indices=jnp.asarray(f),
                                       face_mask=jnp.asarray(mask)))

    val_j, grad_j = jax.jit(jax.value_and_grad(loss_j))(jnp.asarray(v))
    verts = t(v).requires_grad_()
    val_t = fn_t(tmesh.TriangleMesh(vertices=verts, indices=t(f, torch.long),
                                    face_mask=t(mask, torch.bool)))
    val_t.backward()
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    assert np.abs(n(verts.grad) - grad_j).max() <= 1e-4 * np.abs(grad_j).max()
    assert float(val_t.detach()) > 0


def test_normal_consistency_counts_each_edge_once(sphere):
    """The FlexiCubes sphere is manifold: every valid edge key appears twice,
    so the pairing does not depend on the sort's tie order."""
    _, f, mask = sphere
    e = np.stack((f, f[:, [1, 2, 0]]), -1)[mask].reshape(-1, 2)
    _, counts = np.unique(np.sort(e, -1), axis=0, return_counts=True)
    assert (counts == 2).all()


def test_face_areas_and_surface_samples_match_jax(sphere):
    mesh_j, mesh_t = meshes(sphere)
    nj, aj = mesh_j.face_normals_and_areas()
    nt, at = mesh_t.face_normals_and_areas()
    np.testing.assert_allclose(n(nt), np.asarray(nj), atol=1e-6)
    np.testing.assert_allclose(n(at), np.asarray(aj), rtol=1e-5, atol=1e-9)
    key = jax.random.key(1)
    pts_j, fid_j = jax.jit(lambda k: mesh_j.sample_surface(k, 2048))(key)
    draws = surface_draws(mesh_j, key, 2048)
    pts_t, fid_t = mesh_t.sample_surface(2048, draws=draws)
    np.testing.assert_array_equal(n(fid_t), np.asarray(fid_j))
    np.testing.assert_allclose(n(pts_t), np.asarray(pts_j), atol=1e-6)
    # the port's own draws: area-weighted, never a masked face
    fid, uv = mesh_t.draw_surface(20000, torch.Generator().manual_seed(0))
    mask = sphere[2]
    assert mask[n(fid)].all() and uv.shape == (20000, 2) and float(uv.max()) < 1
    share = np.bincount(n(fid), minlength=len(mask)) / 20000
    area = n(at) / n(at).sum()
    assert np.abs(share - area).sum() < 0.1


def test_occupancy_grid_and_mesh_visibility_match_jax(sphere):
    mesh_j, mesh_t = meshes(sphere)
    key = jax.random.key(2)
    occ_j = jax.jit(lambda k: jvis.mesh_occupancy_grid(mesh_j, k, resolution=16, scale=1.05,
                                                       num_samples=4096))(key)
    occ_t = tvis.mesh_occupancy_grid(mesh_t, resolution=16, scale=1.05, num_samples=4096,
                                     draws=surface_draws(mesh_j, key, 4096))
    np.testing.assert_array_equal(n(occ_t), np.asarray(occ_j))
    assert 0 < float(occ_t.mean()) < 1

    rng = np.random.default_rng(3)
    origins = np.concatenate([rng.uniform(-1.2, 1.2, (300, 3)),
                              np.asarray(sphere[0][:200]) * 1.02]).astype(np.float32)
    dirs = rng.normal(size=origins.shape).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    vis_j = jax.jit(lambda k, o, d: jvis.make_mesh_visibility(
        mesh_j, k, resolution=16, scale=1.05)(o, d))(key, origins, dirs)
    vis_fn = tvis.make_mesh_visibility(mesh_t, resolution=16, scale=1.05,
                                       draws=surface_draws(mesh_j, key, 1 << 17))
    vis_t = vis_fn(t(origins), t(dirs))
    np.testing.assert_allclose(n(vis_t), np.asarray(vis_j), atol=1e-5)
    assert float(vis_t.min()) < 0.5 < float(vis_t.max())


def test_mesh_io_reads_and_writes_like_jax(tmp_path):
    rng = np.random.default_rng(4)
    v = rng.normal(size=(9, 3)).astype(np.float32)
    f = rng.integers(0, 9, (7, 3)).astype(np.int32)
    colors = rng.uniform(size=(9, 3)).astype(np.float32)
    cases = {}
    # what the JAX writer writes: OBJ (with vertex colours) and binary PLY
    jio.save_mesh(tmp_path / "a.obj", v, f, colors)
    jio.save_mesh(tmp_path / "b.ply", v, f)
    jio.save_mesh(tmp_path / "c.ply", v, f, colors)
    cases.update(a="a.obj", b="b.ply", c="c.ply")
    # an ascii PLY with a quad and normals, and a quad OBJ with v/vt/vn
    # corners and a negative index
    (tmp_path / "d.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\nproperty float y\n"
        "property float z\nproperty float nx\nproperty float ny\nproperty float nz\n"
        "element face 2\nproperty list uchar int vertex_indices\nend_header\n"
        "0 0 0 0 0 1\n1 0 0 0 0 1\n1 1 0 0 0 1\n0 1 0 0 0 1\n4 0 1 2 3\n3 0 2 3\n")
    (tmp_path / "e.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\nvt 0 0\nvn 0 0 1\n"
        "f 1/1/1 2/1/1 3/1/1 4/1/1\nf 1 2 -1\n")
    cases.update(d="d.ply", e="e.obj")
    for name, fname in cases.items():
        want, got = jio.load_mesh(tmp_path / fname), tio.load_mesh(tmp_path / fname)
        assert sorted(got) == sorted(want), name
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{name}/{k}")
            assert got[k].dtype == np.asarray(want[k]).dtype, f"{name}/{k}"
    assert tio.load_mesh(tmp_path / "e.obj")["indices"].shape == (3, 3)   # fan of the quad
    # and the port's writer, read by the JAX reader
    for fname, c in (("p.obj", colors), ("q.ply", None), ("r.ply", colors)):
        tio.save_mesh(tmp_path / fname, v, f, c)
        a, b = jio.load_mesh(tmp_path / fname), tio.load_mesh(tmp_path / fname)
        np.testing.assert_array_equal(np.asarray(a["vertices"]), v)
        np.testing.assert_array_equal(np.asarray(a["indices"]), f)
        for k in a:
            np.testing.assert_array_equal(b[k], np.asarray(a[k]))
    with pytest.raises(ValueError, match="unsupported"):
        tio.load_mesh(tmp_path / "x.stl")
