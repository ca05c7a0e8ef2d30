"""Port parity: graphics/textures, every shader of graphics/shaders and the
four rendered layouts (MeshViewSynthesis, MeshDR, MeshPBR, ShapeNet)
against the JAX package on the CPU. The mesh is a UV sphere
(``chip_smoke.uv_sphere``), the cameras JAX's: the rendered layouts' random
view directions are replaced by the JAX package's draws, and ssao's
hemisphere samples by JAX's.

Tolerances: textures 1e-5 (the sampled prefilter 1e-4); shaded images
1e-4 absolute, except at the pixels whose winning triangle differs between
the packages (exact depth ties on shared edges, at most 1% of the covered
pixels), and coverage equal to that count; the rendered layouts' cameras
1e-6 and their images as the shaders'."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import uv_sphere
from geosplatting_tpu.data.dataparsers import synthetic_meshes as jsm
from geosplatting_tpu.graphics import gmath as jgmath
from geosplatting_tpu.graphics import shaders as jshaders
from geosplatting_tpu.graphics import textures as jtex
from geosplatting_tpu.graphics.cameras import Cameras as JCameras
from geosplatting_tpu.graphics.mesh import TriangleMesh as JMesh
from geosplatting_tpu.graphics.mesh_io import save_mesh
from geosplatting_tpu.ops import cubemap as jcm
from geosplatting_tpu_torch.data.dataparsers import synthetic_meshes as tsm
from geosplatting_tpu_torch.data.io import dump_float32_image
from geosplatting_tpu_torch.graphics import shaders, textures

from .torch_parity import cameras_from_jax, n, one_torch_thread, t  # noqa: F401

W, H = 56, 40


@pytest.fixture(scope="module")
def sphere():
    m = uv_sphere(14, 16, 0.6)
    return m, JMesh(vertices=jnp.asarray(n(m.vertices)), indices=jnp.asarray(n(m.indices)))


def camera():
    return JCameras.from_lookat(jnp.array([0.3, 1.9, 0.8]), jnp.zeros(3), width=W, height=H,
                                fov_degrees=50.0)


def assert_images_close(got, want, atol=1e-4, name=""):
    """Equal to ``atol`` except where the coverage differs or a pixel's
    value differs by more (the winner flips at shared-edge depth ties):
    those pixels stay under 1% of the covered ones."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    bad = (np.abs(got - want) > atol).any(-1)
    covered = max(int((want[..., -1] > 0).sum()), 1)
    assert bad.sum() <= 0.01 * covered, f"{name}: {int(bad.sum())} of {covered} pixels differ"


def test_textures_match_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(12, 20, 3)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, size=(50, 2)).astype(np.float32)
    dirs = rng.normal(size=(60, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    normals = np.roll(dirs, 1, axis=0)
    rough = rng.uniform(0.05, 1.0, size=(60, 1)).astype(np.float32)
    cam = camera()

    @jax.jit
    def jax_side(img, uv, dirs, normals, rough):
        """Every JAX texture function of the test in one compiled program."""
        lat = jtex.TextureLatLng(data=img)
        pdf = lat.compute_pdf()
        cube = lat.as_cubemap(16)
        return {"tex2d": jtex.Texture2D(data=img).sample(uv), "latlng": lat.sample(dirs),
                "pdf": pdf.pdf, "rows": pdf.rows, "cols": pdf.cols, "cube": cube.data,
                "cube_sample": cube.sample(dirs), "down": cube.downsample().data,
                "as_latlng": cube.as_latlng(24, 12).data, "render": cube.render(cam)}

    want = jax_side(img, uv, dirs, normals, rough)
    # the split-sum texture, eagerly (the JAX defaults: sampled GGX,
    # bilinear, trilinear): compiled whole, XLA moves a few texel lookups
    ss = jtex.TextureLatLng(data=jnp.asarray(img)).as_cubemap(16).as_splitsum(num_samples=16)
    want.update(ss_base=ss.base, ss_mips=ss.mips, ss_sample=ss.sample(normals, dirs, rough))
    np.testing.assert_allclose(n(textures.Texture2D(t(img)).sample(t(uv))), want["tex2d"],
                               atol=1e-5)
    lat_t = textures.TextureLatLng(t(img))
    np.testing.assert_allclose(n(lat_t.sample(t(dirs))), want["latlng"], atol=1e-5)
    pdf_t = lat_t.compute_pdf()
    for k in ("pdf", "rows", "cols"):
        np.testing.assert_allclose(n(getattr(pdf_t, k)), np.asarray(want[k]), atol=1e-6,
                                   err_msg=k)
    cube_t = lat_t.as_cubemap(16)
    np.testing.assert_allclose(n(cube_t.data), want["cube"], atol=1e-5)
    np.testing.assert_allclose(n(cube_t.sample(t(dirs))), want["cube_sample"], atol=1e-5)
    np.testing.assert_allclose(n(cube_t.downsample().data), want["down"], atol=1e-5)
    np.testing.assert_allclose(n(cube_t.as_latlng(24, 12).data), want["as_latlng"], atol=1e-5)
    np.testing.assert_allclose(n(cube_t.render(cameras_from_jax(cam))), want["render"],
                               atol=1e-5)
    ss_t = cube_t.as_splitsum(num_samples=16)
    np.testing.assert_allclose(n(ss_t.base), want["ss_base"], atol=1e-4)
    for mt, mj in zip(ss_t.mips, want["ss_mips"], strict=True):
        np.testing.assert_allclose(n(mt), np.asarray(mj), atol=1e-4)
    for a, b in zip(ss_t.sample(t(normals), t(dirs), t(rough)), want["ss_sample"],
                    strict=True):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-4)


def test_shaders_match_jax(sphere):
    mesh_t, mesh_j = sphere
    cam_j = camera()
    cam_t = cameras_from_jax(cam_j)
    v = mesh_t.num_vertices
    rng = np.random.default_rng(1)
    kd = rng.uniform(0.1, 0.9, size=(v, 3)).astype(np.float32)
    ks = np.stack([rng.uniform(0.1, 0.9, v), rng.uniform(0.0, 1.0, v)], -1).astype(np.float32)
    cube = rng.uniform(0.2, 2.0, size=(6, 16, 16, 3)).astype(np.float32)
    base_j, mips_j = jcm.prefilter_splitsum(jnp.asarray(cube), num_samples=8)
    res = (8, 8, 8)
    xs = np.linspace(-1.0, 1.0, 9, dtype=np.float32)
    gz, gy, gx = np.meshgrid(xs, xs, xs, indexing="ij")
    sdf = (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6).reshape(-1).astype(np.float32)
    ssao_samples = jgmath.sample_hemisphere_cosine(jax.random.key(3), (8,))

    @jax.jit
    def render_all(mesh, cam):
        return {
            "normal": jshaders.render_normal(mesh, cam),
            "depth": jshaders.render_depth(mesh, cam),
            "flat": jshaders.render_flat(mesh, cam),
            "pure": jshaders.render_pure(mesh, cam),
            "pretty": jshaders.render_pretty(mesh, cam),
            "wireframe": jshaders.render_wireframe(mesh, cam),
            "pbr": jshaders.render_pbr(mesh, cam, kd=jnp.asarray(kd), ks=jnp.asarray(ks),
                                       env_base=base_j, env_mips=mips_j),
            "shadow": jshaders.render_shadow(mesh, cam, sdf=jnp.asarray(sdf), resolution=res,
                                             scale=1.0),
            "ssao": jshaders.render_ssao(mesh, cam, key=jax.random.key(3), num_samples=8),
        }

    want = render_all(mesh_j, cam_j)
    got = {
        "normal": shaders.render_normal(mesh_t, cam_t),
        "depth": shaders.render_depth(mesh_t, cam_t),
        "flat": shaders.render_flat(mesh_t, cam_t),
        "pure": shaders.render_pure(mesh_t, cam_t),
        "pretty": shaders.render_pretty(mesh_t, cam_t),
        "wireframe": shaders.render_wireframe(mesh_t, cam_t),
        "pbr": shaders.render_pbr(mesh_t, cam_t, kd=t(kd), ks=t(ks), env_base=t(base_j),
                                  env_mips=[t(m) for m in mips_j]),
        "shadow": shaders.render_shadow(mesh_t, cam_t, sdf=t(sdf), resolution=res, scale=1.0),
        "ssao": shaders.render_ssao(mesh_t, cam_t, samples=t(ssao_samples), num_samples=8),
    }
    for name, img in got.items():
        assert float(img[..., -1].mean()) > 0.1, name
        assert_images_close(n(img), want[name], name=name)
    # the depth lies on the sphere: between its near and far points
    hit = n(got["depth"][..., 1]) > 0
    eye = float(np.linalg.norm(np.asarray(cam_j.c2w[:3, 3])))
    assert (n(got["depth"][..., 0])[hit] > eye - 0.61).all()


def test_shaders_raise_where_a_tile_overflows(sphere):
    """Past the tile capacity the JAX shaders drop triangles; these raise
    naming the fill, and render with a capacity that holds the tile."""
    mesh_t, _ = sphere
    cam_t = cameras_from_jax(camera())
    with pytest.raises(ValueError, match="tile_fill"):
        shaders.render_normal(mesh_t, cam_t, tile_capacity=2)
    assert torch.isfinite(shaders.render_normal(mesh_t, cam_t, tile_capacity=1024)).all()


@pytest.fixture(scope="module")
def mesh_layouts(tmp_path_factory, sphere):
    base = tmp_path_factory.mktemp("mesh_layouts")
    m, _ = sphere
    v, f = n(m.vertices), n(m.indices).astype(np.int32)
    colors = (v - v.min(0)) / (v.max(0) - v.min(0))
    for folder, name in (("spot", "spot.obj"), ("cube", "cube.obj")):
        (base / folder).mkdir()
        save_mesh(base / folder / name, v, f, colors=colors)
    (base / "shapenet" / "models").mkdir(parents=True)
    save_mesh(base / "shapenet" / "models" / "model_normalized.obj", v * 1.3 + 0.1, f)
    (base / "shapenet" / "models" / "model_normalized.mtl").write_text("newmtl m\n")
    rng = np.random.default_rng(2)
    env = rng.uniform(0.1, 3.0, size=(16, 32, 3)).astype(np.float32)
    dump_float32_image(base / "env.hdr", env)
    return base


LAYOUTS = [("cube", "MeshViewSynthesisDataparser", {}),
           ("spot", "MeshDRDataparser", {}),
           ("spot", "MeshPBRDataparser", {"envmap_path": "ENV"}),
           ("shapenet", "ShapeNetDataparser", {})]


@pytest.mark.parametrize("folder, parser, extra", LAYOUTS)
def test_rendered_layouts_match_jax(mesh_layouts, monkeypatch, folder, parser, extra):
    kw = dict(resolution=24, num_train_views=2, num_val_views=2, num_test_views=2,
              **{k: str(mesh_layouts / "env.hdr") if v == "ENV" else v for k, v in extra.items()})
    # the port's views at the JAX package's directions
    monkeypatch.setattr(tsm, "_view_directions", lambda seed, num: t(jgmath.sample_sphere(
        jax.random.key(seed), (num,))))
    # the JAX parsers run eagerly: the same functions jitted whole compile
    # once instead of op by op
    for name in ("render_pretty", "render_depth", "render_pbr", "render_pure"):
        monkeypatch.setattr(jshaders, name, jax.jit(getattr(jshaders, name)))
    monkeypatch.setattr(jcm, "prefilter_splitsum", jax.jit(jcm.prefilter_splitsum))
    path = mesh_layouts / folder
    pj, pt = getattr(jsm, parser)(**kw), getattr(tsm, parser)(device="cpu", **kw)
    for split in ("train", "val", "test"):
        sj, st = pj.parse(path, split), pt.parse(path, split)
        np.testing.assert_allclose(st.c2w, np.asarray(sj.c2w), atol=1e-6)
        for k in ("fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(getattr(st, k), np.asarray(getattr(sj, k)), rtol=1e-6)
        assert (st.width, st.height, st.near, st.far) == (sj.width, sj.height, sj.near, sj.far)
        np.testing.assert_allclose(st.focal, sj.focal, rtol=1e-6)
        assert st.images.shape == sj.images.shape == (2, 24, 24, 4)
        assert float(st.images[..., 3].mean()) > 0.05
        assert_images_close(st.load_images(), sj.load_images(), name=f"{parser} {split}")
        np.testing.assert_allclose(n(st.meta["mesh"].vertices),
                                   np.asarray(sj.meta["mesh"].vertices), atol=1e-6)
