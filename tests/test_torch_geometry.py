"""Port parity: the geometry tools against the JAX package on the CPU:
the Kuhn tet grid, marching tetrahedra and marching cubes with their
gradient, DPSR (the splat, the spectral solve, the mesh, a gradient
through all three), Loop subdivision, TSDF fusion, ambient occlusion (the
JAX draws injected) and ``Points`` / ``Rays`` / ``volume_rendering_weights``.

Tolerances: grids and tables exact; marching vertices 1e-6, the face masks
equal, gradients 1e-5 relative to the largest entry; DPSR's splat 1e-5 and
its field 1e-4 (complex64 FFTs in both), its mesh's masks equal and
vertices 1e-4, its gradient 1e-3 relative to the largest entry;
subdivision 1e-6; TSDF masks equal and vertices 1e-5; occlusion 1e-5;
k-nearest distances 1e-5 with equal indices, farthest-point picks equal,
PLY files byte-equal; rays and weights 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import uv_sphere
from geosplatting_tpu.graphics import dpsr as jdpsr
from geosplatting_tpu.graphics import gmath as jgmath
from geosplatting_tpu.graphics import marching as jmarch
from geosplatting_tpu.graphics import mesh_ops as jops
from geosplatting_tpu.graphics import points as jpoints
from geosplatting_tpu.graphics.cameras import Cameras as JCameras
from geosplatting_tpu.graphics.mesh import TriangleMesh as JMesh
from geosplatting_tpu_torch.graphics import dpsr, marching, mesh_ops, points
from geosplatting_tpu_torch.graphics.mesh import TriangleMesh

from .torch_parity import cameras_from_jax, n, one_torch_thread, t  # noqa: F401


def rel_close(got, want, rtol, name=""):
    got, want = n(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0, err_msg=name)


def jmesh(m: TriangleMesh) -> JMesh:
    return JMesh(vertices=jnp.asarray(n(m.vertices)), indices=jnp.asarray(n(m.indices)))


def test_marching_and_its_gradient_match_jax():
    r = 10
    gj, gt = jmarch.kuhn_tet_grid(r, 1.0), marching.kuhn_tet_grid(r, 1.0)
    np.testing.assert_array_equal(n(gt.vertices), np.asarray(gj.vertices))
    np.testing.assert_array_equal(n(gt.tets), np.asarray(gj.tets))
    rng = np.random.default_rng(0)
    verts = (np.asarray(gj.vertices) + rng.uniform(-0.02, 0.02, gj.vertices.shape)
             ).astype(np.float32)
    sdf = (np.linalg.norm(verts, axis=-1) - 0.55 + rng.uniform(-0.03, 0.03, len(verts))
           ).astype(np.float32)
    w = rng.normal(size=(gj.tets.shape[0] * 6, 3)).astype(np.float32)

    def loss_j(v, s):
        m = jmarch.marching_tets(v, s, gj.tets)
        return jnp.sum(jnp.where(jnp.repeat(m.face_mask, 3)[:, None], m.vertices, 0.0) * w), m

    (_, mj), (gv_j, gs_j) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
        jnp.asarray(verts), jnp.asarray(sdf))
    vt, st = t(verts).requires_grad_(), t(sdf).requires_grad_()
    mt = marching.marching_tets(vt, st, gt.tets)
    (torch.where(mt.face_mask.repeat_interleave(3)[:, None], mt.vertices, 0.0) * t(w)
     ).sum().backward()
    np.testing.assert_array_equal(n(mt.face_mask), np.asarray(mj.face_mask))
    assert int(mt.face_mask.sum()) > 300
    np.testing.assert_allclose(n(mt.vertices), np.asarray(mj.vertices), atol=1e-6)
    np.testing.assert_array_equal(n(mt.indices), np.asarray(mj.indices))
    rel_close(vt.grad, gv_j, 1e-5, "vertices")
    rel_close(st.grad, gs_j, 1e-5, "sdf")
    assert float(st.grad.abs().sum()) > 0
    # marching cubes is the same core over the grid
    grid = np.linalg.norm(np.asarray(gj.vertices), axis=-1).reshape(r + 1, r + 1, r + 1) - 0.6
    cj = jmarch.marching_cubes(jnp.asarray(grid, jnp.float32), r)
    ct = marching.marching_cubes(t(grid), r)
    np.testing.assert_array_equal(n(ct.face_mask), np.asarray(cj.face_mask))
    np.testing.assert_allclose(n(ct.vertices), np.asarray(cj.vertices), atol=1e-6)


def test_dpsr_matches_jax():
    d = np.asarray(jgmath.safe_normalize(jax.random.normal(jax.random.key(1), (1500, 3))))
    pts = (d * 0.3 + 0.5).astype(np.float32)
    res = 16
    np.testing.assert_allclose(n(dpsr.point_rasterize(t(pts), t(d), res)),
                               np.asarray(jdpsr.point_rasterize(pts, d, res)), atol=1e-5)
    w = np.random.default_rng(2).normal(size=(res, res, res)).astype(np.float32)

    def loss_j(p, nrm):
        chi = jdpsr.dpsr_solve(p, nrm, resolution=res)
        return jnp.sum(chi * w), chi

    (_, chi_j), (gp_j, gn_j) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1),
                                                          has_aux=True))(pts, d)
    pt_, nt_ = t(pts).requires_grad_(), t(d).requires_grad_()
    chi_t = dpsr.dpsr_solve(pt_, nt_, resolution=res)
    (chi_t * t(w)).sum().backward()
    np.testing.assert_allclose(n(chi_t), np.asarray(chi_j), atol=1e-4)
    assert float(chi_t[8, 8, 8].detach()) * float(chi_t[1, 1, 1].detach()) < 0   # inside and outside differ
    rel_close(pt_.grad, gp_j, 1e-3, "points")
    rel_close(nt_.grad, gn_j, 1e-3, "normals")
    mj = jdpsr.psr_to_mesh(pts, d, resolution=res)
    mt = dpsr.psr_to_mesh(t(pts), t(d), resolution=res)
    np.testing.assert_array_equal(n(mt.face_mask), np.asarray(mj.face_mask))
    assert int(mt.face_mask.sum()) > 50
    np.testing.assert_allclose(n(mt.vertices), np.asarray(mj.vertices), atol=1e-4)


def test_subdivide_matches_jax():
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                 np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5], [3, 1, 5],
                  [0, 3, 5]], np.int64)
    octa = TriangleMesh(vertices=t(v), indices=torch.as_tensor(f))
    sphere = uv_sphere(5, 6, 0.7)    # open at the poles: boundary edges take midpoints
    for m in (octa, sphere):
        st = mesh_ops.subdivide(mesh_ops.subdivide(m))
        sj = jops.subdivide(jops.subdivide(jmesh(m)))
        np.testing.assert_array_equal(n(st.indices), np.asarray(sj.indices))
        np.testing.assert_allclose(n(st.vertices), np.asarray(sj.vertices), atol=1e-6)
        assert st.num_faces == 16 * m.num_faces


def test_tsdf_fusion_matches_jax():
    cams_j = JCameras.from_orbit(center=jnp.zeros(3), radius=2.0, elevation_degrees=20.0,
                                 num_samples=6, width=40, height=32)
    origins, dirs = cams_j.generate_rays()
    b = jnp.sum(origins * dirs, -1)
    disc = b * b - (jnp.sum(origins * origins, -1) - 0.25)
    hit = disc > 0
    tt = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
    zdepth = tt * jnp.sum(dirs * -cams_j.c2w[:, None, None, :, 2], -1)
    dmap = np.asarray(jnp.stack((jnp.where(hit, zdepth, 0.0), hit.astype(jnp.float32)), -1))
    mj = jax.jit(lambda d, c: jops.tsdf_fusion(d, c, resolution=24, scale=0.8))(dmap, cams_j)
    mt = mesh_ops.tsdf_fusion(t(dmap), cameras_from_jax(cams_j), resolution=24, scale=0.8)
    np.testing.assert_array_equal(n(mt.face_mask), np.asarray(mj.face_mask))
    np.testing.assert_allclose(n(mt.vertices), np.asarray(mj.vertices), atol=1e-5)
    used = n(mt.indices)[n(mt.face_mask)].reshape(-1)
    assert abs(np.linalg.norm(n(mt.vertices)[used], axis=-1).mean() - 0.5) < 0.05


def test_ambient_occlusion_matches_jax():
    """Two spheres touching: the JAX draws (the occupancy grid's surface
    samples, the hemisphere directions) replayed from its key."""
    s = uv_sphere(8, 10, 0.5)
    v, f = n(s.vertices), n(s.indices)
    normals, _ = s.face_normals_and_areas()
    if float((normals * s.face_vertices().mean(-2)).sum()) < 0:
        f = f[:, ::-1].copy()   # outward faces: the occlusion rays leave the surface
    off = np.array([0.0, 0.0, 0.5], np.float32)
    pair = TriangleMesh(vertices=t(np.concatenate([v - off, v + off])),
                        indices=torch.as_tensor(np.concatenate([f, f + len(v)])))
    pj = jmesh(pair)
    key, num, res = jax.random.key(0), 8, 96
    ao_j = jax.jit(lambda m, k: jops.ambient_occlusion(m, k, num_samples=num, resolution=res,
                                                      scale=1.5))(pj, key)
    k_vox, k_dirs = jax.random.split(key)
    _, areas = pj.face_normals_and_areas()
    k1, k2 = jax.random.split(k_vox)
    surface = (torch.as_tensor(np.array(jax.random.categorical(
        k1, jnp.log(areas + 1e-20), shape=(1 << 17,)))), t(jax.random.uniform(k2, (1 << 17, 2))))
    hemi = np.stack([np.asarray(jgmath.sample_hemisphere_cosine(k, (pair.num_faces,)))
                     for k in jax.random.split(k_dirs, num)])
    ao_t = mesh_ops.ambient_occlusion(pair, surface_draws=surface, hemisphere=t(hemi),
                                      num_samples=num, resolution=res, scale=1.5)
    np.testing.assert_allclose(n(ao_t), np.asarray(ao_j), atol=1e-5)
    centers = n(pair.face_vertices().mean(-2))
    gap = np.abs(centers[:, 2]) < 0.3
    assert n(ao_t)[gap].mean() < n(ao_t)[~gap].mean() - 0.1


def test_points_and_rays_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    pos = rng.uniform(size=(300, 3)).astype(np.float32)
    col = rng.uniform(size=(300, 3)).astype(np.float32)
    nrm = rng.normal(size=(300, 3)).astype(np.float32)
    pt = points.Points(positions=t(pos), colors=t(col), normals=t(nrm))
    pj = jpoints.Points(positions=jnp.asarray(pos), colors=jnp.asarray(col),
                        normals=jnp.asarray(nrm))
    dt, it = pt.k_nearest(4, chunk=128)
    dj, ij = jax.jit(lambda p: p.k_nearest(4, chunk=128))(pj)
    np.testing.assert_array_equal(n(it), np.asarray(ij))
    np.testing.assert_allclose(n(dt), np.asarray(dj), atol=1e-5)
    np.testing.assert_array_equal(n(pt.farthest_point_sample(12)),
                                  np.asarray(jax.jit(lambda p: p.farthest_point_sample(12))(pj)))
    pt.export_ply(tmp_path / "t.ply")
    pj.export_ply(tmp_path / "j.ply")
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back_t = points.Points.from_ply(tmp_path / "j.ply")
    back_j = jpoints.Points.from_ply(tmp_path / "t.ply")
    for k in ("positions", "colors", "normals"):
        np.testing.assert_array_equal(n(getattr(back_t, k)), np.asarray(getattr(back_j, k)))
    only = points.Points(positions=t(pos[:5]))
    only.export_ply(tmp_path / "p.ply")
    assert points.Points.from_ply(tmp_path / "p.ply").colors is None
    (tmp_path / "a.ply").write_bytes(
        b"ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\nproperty float y\n"
        b"property float z\nproperty uchar red\nproperty uchar green\nproperty uchar blue\n"
        b"end_header\n0 1 2 255 0 10\n3 4 5 0 128 255\n")
    at, aj = points.Points.from_ply(tmp_path / "a.ply"), jpoints.Points.from_ply(tmp_path / "a.ply")
    np.testing.assert_array_equal(n(at.colors), np.asarray(aj.colors))
    np.testing.assert_array_equal(n(at.positions), np.asarray(aj.positions))

    o = rng.normal(size=(5, 3)).astype(np.float32)
    d = rng.normal(size=(5, 3)).astype(np.float32)
    rt, rj = points.Rays(t(o), t(d)), jpoints.Rays(origins=jnp.asarray(o),
                                                   directions=jnp.asarray(d))
    tv = rng.uniform(size=(5,)).astype(np.float32)
    np.testing.assert_allclose(n(rt.at(t(tv))), np.asarray(rj.at(tv)), atol=1e-6)
    key = jax.random.key(4)
    sj = rj.stratified_samples(key, 8, 0.1, 1.0)
    st = rt.stratified_samples(8, 0.1, 1.0, uniforms=t(jax.random.uniform(key, (5, 8))))
    np.testing.assert_allclose(n(st), np.asarray(sj), atol=1e-6)
    assert (np.diff(n(rt.stratified_samples(8, 0.1, 1.0)), axis=-1) > 0).all()
    dens = rng.uniform(0, 5, size=(4, 16)).astype(np.float32)
    dens[0, 0] = 1e9
    deltas = rng.uniform(0.01, 0.2, size=(4, 16)).astype(np.float32)
    np.testing.assert_allclose(n(points.volume_rendering_weights(t(dens), t(deltas))),
                               np.asarray(jpoints.volume_rendering_weights(dens, deltas)),
                               atol=1e-6)
