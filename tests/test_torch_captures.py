"""Port parity: the real-capture dataparsers (COLMAP, DPKU, LLFF and masked
LLFF, IDR and masked IDR, Stanford-ORB, RF masked-real) and the camera
selectors against the JAX package on the CPU, on fixture layouts written
here (the shapes of tests/test_points_colmap.py and
tests/test_dataparsers_extended.py, plus a masked-IDR capture whose
principal point lies off the image centre); the recognition order over
one fixture of each layout; ``cameras_of`` with per-camera intrinsics; and
a render and its gradients through the pairs path (the plain K1-K3) at a
72x52 image from that off-centre camera, against the JAX pairs backend in
interpret mode.

Tolerances: c2w and intrinsics to 1e-6 relative; images bit-equal (both
decode the same files through Pillow); split indices and paths equal. The
render holds the rasterizer tolerances of tests/test_rasterize_pallas.py
(forward atol 1e-3; gradients atol and rtol 2e-3)."""
import json
import shutil
import struct
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.data import dataset as jdataset
from geosplatting_tpu.data import selector as jselector
from geosplatting_tpu.data.io import dump_float32_image
from geosplatting_tpu.graphics.mesh_io import save_mesh
from geosplatting_tpu.ops import rasterize_pairs as jrp
from geosplatting_tpu.ops.rasterize import rasterize as jrasterize
from geosplatting_tpu_torch.data import dataset as tdataset
from geosplatting_tpu_torch.data import selector as tselector
from geosplatting_tpu_torch.ops.rasterize import rasterize

from .test_dataparsers_extended import _cube_mesh, _write_idr, _write_llff, _write_orb
from .test_points_colmap import write_colmap_fixture
from .torch_parity import n, one_torch_thread, t  # noqa: F401
from .torch_scenes import write_sphere_scene

# the off-centre capture: 180 x 130 images at the IDR scale 0.4 -> 72 x 52
OFF_W, OFF_H = 180, 130
OFF_K = np.array([[150.0, 0.0, 100.0], [0.0, 140.0, 55.0], [0.0, 0.0, 1.0]])


def write_offcentre_idr(root: Path, n_views=4):
    """A masked-IDR capture on a ring looking at the origin, every view's
    principal point (100, 55) away from the centre (90, 65)."""
    rng = np.random.default_rng(5)
    (root / "image").mkdir(parents=True)
    (root / "mask").mkdir()
    cams = {}
    for i in range(n_views):
        th = 2 * np.pi * i / n_views
        eye = np.array([2.5 * np.cos(th), 2.5 * np.sin(th), 0.8])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        r = np.stack((right, down, fwd))           # world to OpenCV camera
        p = np.eye(4)
        p[:3, :3] = OFF_K @ r
        p[:3, 3] = OFF_K @ (-r @ eye)
        cams[f"world_mat_{i}"] = p
        cams[f"scale_mat_{i}"] = np.eye(4)
        dump_float32_image(root / "image" / f"{i:06d}.png",
                           rng.uniform(size=(OFF_H, OFF_W, 3)).astype(np.float32))
        mask = np.zeros((OFF_H, OFF_W, 1), np.float32)
        mask[20:110, 30:160] = 1.0
        dump_float32_image(root / "mask" / f"{i:03d}.png", mask)
    np.savez(root / "cameras_large.npz", **cams)


def write_rf(root: Path, n_views=10):
    rng = np.random.default_rng(3)
    (root / "images").mkdir(parents=True)
    for i in range(n_views):
        dump_float32_image(root / "images" / f"{i:04d}.png",
                           rng.uniform(size=(8, 8, 4)).astype(np.float32))
    c2w = torch.eye(4)[:3].repeat(n_views, 1, 1)
    c2w[:, :, 3] = torch.from_numpy(rng.normal(size=(n_views, 3)).astype(np.float32))
    torch.save({"c2w": c2w, "fx": torch.full((n_views,), 10.0),
                "fy": torch.full((n_views,), 11.0), "cx": torch.full((n_views,), 4.5),
                "cy": torch.full((n_views,), 3.5),
                "width": torch.full((n_views,), 8, dtype=torch.long),
                "height": torch.full((n_views,), 8, dtype=torch.long),
                "near": torch.full((n_views,), 0.1), "far": torch.full((n_views,), 10.0)},
               root / "cameras.pkl")


def write_colmap_orbit(root: Path, n_views=10):
    """The COLMAP fixture's layout with ten posed views (two in the test
    split) and a SIMPLE_PINHOLE camera."""
    write_colmap_fixture(root)
    with open(root / "sparse" / "0" / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 0, 64, 48))
        f.write(struct.pack("<3d", 55.0, 32.0, 24.0))
    rng = np.random.default_rng(4)
    with open(root / "sparse" / "0" / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n_views))
        for i in range(n_views):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            f.write(struct.pack("<I", i + 1))
            f.write(struct.pack("<4d", *q))
            f.write(struct.pack("<3d", *rng.normal(size=3)))
            f.write(struct.pack("<I", 1))
            f.write(f"im{(7 * i) % n_views}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ddq", 1.0, 2.0, -1))
    for i in range(n_views):
        dump_float32_image(root / "images" / f"im{i}.png",
                           rng.uniform(size=(48, 64, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    base = tmp_path_factory.mktemp("captures")
    out = {}
    write_colmap_orbit(base / "colmap")
    out["colmap"] = base / "colmap"
    shutil.copytree(base / "colmap", base / "dpku")
    (base / "dpku" / "database.db").write_bytes(b"")
    out["dpku"] = base / "dpku"
    _write_llff(base / "llff")
    out["llff"] = base / "llff"
    _write_llff(base / "masked_llff", masked=True)
    out["masked_llff"] = base / "masked_llff"
    _write_idr(base / "idr")
    out["idr"] = base / "idr"
    write_offcentre_idr(base / "masked_idr")
    out["masked_idr"] = base / "masked_idr"
    out["orb"] = _write_orb(base / "orb")
    write_rf(base / "rf")
    out["rf"] = base / "rf"
    return out


PARSERS = {"colmap": "ColmapDataparser", "dpku": "DPKUDataparser", "llff": "LLFFDataparser",
           "masked_llff": "MaskedLLFFDataparser", "idr": "IDRDataparser",
           "masked_idr": "MaskedIDRDataparser", "orb": "StanfordORBDataparser",
           "rf": "RFMaskedRealDataparser"}


def assert_same_split(st, sj, scale_factor=None):
    np.testing.assert_allclose(st.c2w, sj.c2w, rtol=1e-6, atol=0)
    assert st.c2w.dtype == sj.c2w.dtype
    assert (st.width, st.height) == (sj.width, sj.height)
    np.testing.assert_allclose([st.focal, st.near, st.far], [sj.focal, sj.near, sj.far],
                               rtol=1e-6)
    for k in ("fx", "fy", "cx", "cy"):
        a, b = getattr(st, k), getattr(sj, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=k)
    assert st.image_scale == sj.image_scale
    assert [str(p) for p in st.image_paths] == [str(p) for p in sj.image_paths]
    assert st.mask_paths == sj.mask_paths
    assert st.alpha_color == sj.alpha_color
    if isinstance(sj.meta, dict):
        assert sorted(st.meta) == sorted(sj.meta)
        for k, v in sj.meta.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(st.meta[k], v)
            else:
                assert st.meta[k] == v, k
    else:
        assert st.meta == sj.meta
    np.testing.assert_array_equal(st.load_images(scale_factor), sj.load_images(scale_factor))


@pytest.fixture
def no_colmap_binary(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)


@pytest.mark.parametrize("layout", sorted(PARSERS))
def test_parser_matches_jax(layouts, layout, no_colmap_binary):
    path = layouts[layout]
    pj, pt = jdataset.recognize_dataparser(path), tdataset.recognize_dataparser(path)
    assert type(pj).__name__ == type(pt).__name__ == PARSERS[layout]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # DPKU's fallback warning (its own test)
        for split in ("train", "val", "test"):
            assert_same_split(pt.parse(path, split), pj.parse(path, split))
        # a second resize on top of the parser's own
        assert_same_split(pt.parse(path, "train"), pj.parse(path, "train"), scale_factor=0.5)


def test_dpku_warns_and_reads_the_sparse_model(layouts, no_colmap_binary):
    """Without a dense model and without the colmap binary, DPKU warns and
    reads the distorted sparse model as COLMAP does (the branch that runs
    the binary is not exercised: no machine here has it)."""
    path = layouts["dpku"]
    pt = tdataset.recognize_dataparser(path)
    with pytest.warns(UserWarning, match="no dense model and no colmap binary"):
        st = pt.parse(path, "train")
    with pytest.warns(UserWarning, match="no dense model"):
        sj = jdataset.recognize_dataparser(path).parse(path, "train")
    assert_same_split(st, sj)
    assert not (path / "dense").exists()
    # a dense model, once there, is read instead
    shutil.copytree(layouts["colmap"], path / "dense")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            dense = pt.parse(path, "test")
        assert dense.image_paths[0].parent == path / "dense" / "images"
    finally:
        shutil.rmtree(path / "dense")


def test_recognition_order_matches_jax(layouts, tmp_path):
    """One fixture of every layout, and a directory of none, recognised as
    the JAX package recognises them."""
    paths = dict(layouts)
    write_sphere_scene(tmp_path / "blender", {"train": 1, "val": 1, "test": 1}, 8, "cpu")
    paths["blender"] = tmp_path / "blender"
    shutil.copytree(tmp_path / "blender", tmp_path / "shiny")
    (tmp_path / "shiny" / "transforms_val.json").unlink()
    paths["shiny"] = tmp_path / "shiny"
    v, f = _cube_mesh()
    for folder, name in (("spot", "spot.obj"), ("cube", "cube.obj"),
                         ("inputmodels", "block.obj")):
        (tmp_path / folder).mkdir()
        save_mesh(tmp_path / folder / name, v, f)
        paths[folder] = tmp_path / folder
    (tmp_path / "shapenet" / "models").mkdir(parents=True)
    save_mesh(tmp_path / "shapenet" / "models" / "model_normalized.obj", v, f)
    (tmp_path / "shapenet" / "models" / "model_normalized.mtl").write_text("newmtl m\n")
    paths["shapenet"] = tmp_path / "shapenet"
    names = {}
    for layout, path in paths.items():
        pj, pt = jdataset.recognize_dataparser(path), tdataset.recognize_dataparser(path)
        assert type(pt).__name__ == type(pj).__name__, layout
        names[layout] = type(pt).__name__
    assert names["spot"] == "MeshPBRDataparser" and names["cube"] == "MeshViewSynthesisDataparser"
    assert names["inputmodels"] == "MeshDRDataparser" and names["blender"] == "BlenderDataparser"
    assert [c.__name__ for c in tdataset.DATAPARSERS] == [
        c.__name__ for c in jdataset.DATAPARSERS]
    (tmp_path / "empty").mkdir()
    for module in (jdataset, tdataset):
        with pytest.raises(ValueError, match="no dataparser recognizes"):
            module.recognize_dataparser(tmp_path / "empty")


@pytest.mark.parametrize("layout, scale", [("masked_idr", None), ("masked_idr", 0.5),
                                           ("llff", None), ("rf", 0.5)])
def test_cameras_of_per_camera_intrinsics(layouts, layout, scale):
    """The datasets' cameras: per-camera fx, fy, cx, cy through the
    dataset's own scale, width and height, images and meta, as JAX's."""
    dj = jdataset.Dataset(layouts[layout], scale_factor=scale)
    dt = tdataset.Dataset(layouts[layout], scale_factor=scale, device="cpu")
    for split in ("train", "test"):
        cj, ij, _ = dj.get_split(split)
        ct, it, _ = dt.get_split(split)
        for k in ("c2w", "fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(n(getattr(ct, k)), np.asarray(getattr(cj, k)),
                                       rtol=1e-6, atol=0, err_msg=k)
        assert (ct.width, ct.height, ct.near, ct.far) == (cj.width, cj.height, cj.near, cj.far)
        np.testing.assert_array_equal(it, ij)
    if layout == "masked_idr":
        cams, images, _ = dt.get_split("train")
        sf = 0.4 * (scale or 1.0)
        assert images.shape[1:3] == (int(OFF_H * sf), int(OFF_W * sf))
        # the principal point is off the centre, as the projection put it
        np.testing.assert_allclose(n(cams.cx), 100.0 * sf, rtol=1e-4)
        np.testing.assert_allclose(n(cams.cy), 55.0 * sf, rtol=1e-4)


def test_selectors_match_jax():
    rng = np.random.default_rng(0)
    c2w = rng.normal(size=(12, 3, 4)).astype(np.float32)
    for kw in ({"center_degrees": 0.0, "half_angle_degrees": 50.0},
               {"center_degrees": 170.0, "half_angle_degrees": 30.0}):
        np.testing.assert_array_equal(tselector.FanSelector(**kw).select(12, c2w),
                                      jselector.FanSelector(**kw).select(12, c2w))
    for kw in ({}, {"start": 2, "stop": 9, "step": 3}, {"start": -4}):
        np.testing.assert_array_equal(tselector.SliceSelector(**kw).select(12),
                                      jselector.SliceSelector(**kw).select(12))


@pytest.fixture
def jax_pairs_interpret():
    old = jrp._INTERPRET
    jrp._INTERPRET = True
    yield
    jrp._INTERPRET = old


def test_offcentre_render_and_gradients_match_jax(layouts, jax_pairs_interpret):
    """72x52 (neither axis a multiple of 16) from the off-centre masked-IDR
    camera as the port's dataset builds it: the pairs path's render and its
    gradients against JAX's."""
    cams, _, _ = tdataset.Dataset(layouts["masked_idr"], device="cpu").get_split("train")
    cam = cams[1]
    assert (cam.width, cam.height) == (72, 52)
    assert abs(float(cam.cx) - 36.0) > 3.0 and abs(float(cam.cy) - 26.0) > 3.0
    vm, K = n(cam.view_matrix), n(cam.intrinsic_matrix)
    rng = np.random.default_rng(11)
    num = 200
    means = rng.uniform(-0.8, 0.8, (num, 3)).astype(np.float32)
    q = rng.normal(size=(num, 4)).astype(np.float32)
    quats = q / np.linalg.norm(q, axis=-1, keepdims=True)
    scales = np.exp(rng.uniform(-4.0, -2.0, (num, 3))).astype(np.float32)
    opacities = rng.uniform(0.3, 0.95, (num,)).astype(np.float32)
    colors = rng.uniform(size=(num, 3)).astype(np.float32)
    off = np.zeros((num, 2), np.float32)
    tgt = rng.uniform(size=(52, 72, 3)).astype(np.float32)

    def loss_j(m, s, o, c, d):
        r, a, _ = jrasterize(m, jnp.asarray(quats), s, o, c, jnp.asarray(vm), jnp.asarray(K),
                             72, 52, means2d_offset=d, backend="pairs")
        return jnp.sum((r - tgt) ** 2) + jnp.sum(a * 0.3), (r, a)

    (_, (r_j, a_j)), g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3, 4),
                                                      has_aux=True))(
        *(jnp.asarray(a) for a in (means, scales, opacities, colors, off)))
    args = [t(a).requires_grad_() for a in (means, scales, opacities, colors, off)]
    r, a, _ = rasterize(args[0], t(quats), args[1], args[2], args[3], t(vm), t(K), 72, 52,
                        means2d_offset=args[4])
    (((r - t(tgt)) ** 2).sum() + (a * 0.3).sum()).backward()
    assert float(a.detach().max()) > 0.5 and r.shape == (52, 72, 3)
    np.testing.assert_allclose(n(r), np.asarray(r_j), atol=1e-3)
    np.testing.assert_allclose(n(a), np.asarray(a_j), atol=1e-3)
    for name, gj, at in zip(["means", "scales", "opacities", "colors", "means2d"], g_j, args):
        assert float(at.grad.abs().max()) > 0, name
        np.testing.assert_allclose(n(at.grad), np.asarray(gj), atol=2e-3, rtol=2e-3,
                                   err_msg=f"grad mismatch: {name}")


def test_orb_layout_reads_at_half_size(layouts):
    """Stanford-ORB's frames are read through the masks at the parser's
    half size, and its meta names the ground-truth mesh."""
    scene = layouts["orb"]
    ds = tdataset.Dataset(scene, device="cpu")
    cams, images, meta = ds.get_split("train")
    assert images.shape == (2, 4, 4, 4) and (cams.width, cams.height) == (1024, 1024)
    assert meta["gt_mesh"].exists() and meta["mesh_scale"] == 2 / 3
    np.testing.assert_array_equal(images[..., 3], 1.0)
    with open(scene / "transforms_train.json") as f:
        assert len(json.load(f)["frames"]) == len(cams)
