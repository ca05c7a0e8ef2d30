"""Port parity: the root entry scripts (``geosplatting_tpu_torch/scripts/``
``make_synthetic_scene``, ``premask``, ``run_pipeline``) on the CPU.

- ``make_synthetic_scene``: its stored orbits and transforms JSON equal the
  JAX script's functions (``scripts/make_synthetic_scene.py``, loaded by
  path; its ``main`` is not run). The scene it writes parses through the
  port's ``Dataset`` as Syn4Relight, and its frames are the files that
  ``bench/quality.render_gt_views`` gives at each view's seed, byte for byte.
- ``premask``: on that scene at 64 x 64, with the two spheres as a mesh
  stored in a scan frame (rotated, moved, scaled), its masks equal the JAX
  ``rasterize_mesh`` coverage of the aligned mesh on 2 views, and overlap
  the scene's alpha with an IoU >= 0.97 on every view; ``cameras.pkl`` has
  the JAX script's keys, dtypes and shapes, with the JAX parser's cameras
  (within 1e-6: the two packages parse the same JSON); the port's
  ``RFMaskedRealDataparser`` reads the layout back; a tile past
  ``--tile_capacity`` raises (the JAX script's default 256 does here).
- ``run_pipeline --device cpu`` at a few steps on the S4R fixture of the
  stage-3 task tests (``torch_scenes.write_s4r_scene``): finite losses, no
  non-finite gradient, a finite ``reliteval``; each stage's export has the
  keys, shapes and dtypes of the export the port's stage task writes (the
  next stage's task builds from it), and the JAX ``load_export`` reads the
  stage-3 export with the same keys.

Tolerances: none but the cameras' 1e-6; files and masks are compared for
equality.
"""
import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.data.dataset import Dataset as JDataset
from geosplatting_tpu.engine import stage_io as jio
from geosplatting_tpu.graphics.cameras import Cameras as JCameras
from geosplatting_tpu.graphics.mesh import TriangleMesh as JTriangleMesh
from geosplatting_tpu.ops.mesh_raster import rasterize_mesh as jax_rasterize_mesh
from geosplatting_tpu_torch.bench import quality as q
from geosplatting_tpu_torch.data.dataset import Dataset
from geosplatting_tpu_torch.data.io import dump_float32_image
from geosplatting_tpu_torch.engine import train_task as tt
from geosplatting_tpu_torch.engine.stage_io import load_export
from geosplatting_tpu_torch.graphics.mesh_io import load_mesh, save_mesh
from geosplatting_tpu_torch.scripts import make_synthetic_scene as mss
from geosplatting_tpu_torch.scripts import premask
from geosplatting_tpu_torch.scripts import run_pipeline

from .torch_parity import one_torch_thread  # noqa: F401
from .torch_scenes import uv_sphere, write_s4r_scene

REPO = Path(__file__).resolve().parents[1]
N_TRAIN, N_TEST, RES, SPP, SEED = 3, 2, 160, 2, 11
MASK_RES = 64


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("synthetic") / "twosphere"
    mss.main(["--scene_dir", str(out), "--n_train", str(N_TRAIN), "--n_test", str(N_TEST),
              "--res", str(RES), "--gt_spp_x", str(SPP), "--seed", str(SEED), "--device", "cpu"])
    return out


def _jax_script(monkeypatch):
    """scripts/make_synthetic_scene.py as a module (it sets an environment
    default and a path entry when imported: both are restored)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "unused")
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        "jax_make_synthetic_scene", REPO / "scripts" / "make_synthetic_scene.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_scene_cameras_match_jax_script(scene, monkeypatch, tmp_path):
    jmod = _jax_script(monkeypatch)
    for args in ((5, 3.3, 22.0, 0.0), (3, 3.3, 32.0, 0.37)):
        np.testing.assert_array_equal(mss.stored_orbit_c2w(*args), jmod.stored_orbit_c2w(*args))
    monkeypatch.setattr(jmod, "OUT", tmp_path)
    jmod.write_transforms("train", N_TRAIN, elev_deg=22.0, phase=0.0)
    jmod.write_transforms("test", N_TEST, elev_deg=32.0, phase=0.37)
    assert mss.CAMERA_ANGLE_X == jmod.CAMERA_ANGLE_X
    for split in ("train", "test"):
        name = f"transforms_{split}.json"
        assert json.loads((scene / name).read_text()) == json.loads((tmp_path / name).read_text())


def test_synthetic_scene_frames_are_the_ground_truth(scene, tmp_path):
    ds = Dataset(scene, scale_factor=RES / 800, device="cpu")
    assert type(ds.dataparser).__name__ == "Syn4RelightDataparser"
    cams, imgs, _ = ds.get_split("train")
    assert imgs.shape == (N_TRAIN, RES, RES, 4)
    test_cams, _, _ = ds.get_split("test")
    up = 800 // RES
    env = q.make_envmap(kind="train", device="cpu")
    relight = q.make_envmap(kind="relight", device="cpu")
    relight2 = torch.roll(relight, relight.shape[1] // 2, dims=1)

    def gt(cams_, i, env_, seed):
        return q.render_gt_views(cams_[i:i + 1], env_, torch.Generator().manual_seed(seed),
                                 SPP)[0].numpy()

    def same_file(rel: str, img: np.ndarray) -> None:
        want = tmp_path / ("want" + Path(rel).suffix)
        dump_float32_image(want, mss.upsample(img, up))
        assert (scene / rel).read_bytes() == want.read_bytes(), rel

    for i in range(N_TRAIN):
        linear, a = mss.train_frame(gt(cams, i, env, SEED + i))
        same_file(f"train/r_{i}_rgb.hdr", linear)
        same_file(f"train/r_{i}_mask.png", a)
    albedo, _ = q.gt_material_maps(test_cams)
    same_file("test/r_1_rgba.png", gt(test_cams, 1, env, SEED + 7000 + 1))
    same_file("test/r_1_albedo.png", albedo[1].numpy())
    same_file("test_rli/envmap12_r_1.png", gt(test_cams, 1, relight2, SEED + 9000 + 1))
    for name in ("envmap6.hdr", "envmap12.hdr"):
        assert (scene.parent / name).exists()


# the scan frame of the premask test's mesh: v_scan = v / S @ R + T, so the
# script's alignment (v_scan - T) R^T S gives back v
ANGLE = 0.7
R = np.array([[np.cos(ANGLE), -np.sin(ANGLE), 0.0], [np.sin(ANGLE), np.cos(ANGLE), 0.0],
              [0.0, 0.0, 1.0]], np.float32)
T = np.array([0.3, -0.2, 0.1], np.float32)
S = 0.5
# the fullest 16 x 16 tile of a 64 x 64 view holds ~1,500 of the mesh's 3,072
# triangles: the JAX script's default 256 would drop most of them
CAPACITY = 2048


def two_spheres() -> tuple[np.ndarray, np.ndarray]:
    """The quality scene's spheres as one UV-sphere mesh (vertices, faces)."""
    verts, faces = [], []
    for centre, radius in zip(q.SPHERE_CENTERS, q.SPHERE_RADII):
        m = uv_sphere(24, 32, float(radius))
        faces.append(m.indices.numpy() + sum(len(v) for v in verts))
        verts.append(m.vertices.numpy() + centre)
    return np.concatenate(verts).astype(np.float32), np.concatenate(faces).astype(np.int32)


@pytest.fixture(scope="module")
def premasked(scene, tmp_path_factory):
    root = tmp_path_factory.mktemp("premask")
    verts, faces = two_spheres()
    save_mesh(root / "scan.ply", (verts / S) @ R + T, faces)
    args = ["--mesh", str(root / "scan.ply"), "--dataset_path", str(scene),
            "--output", str(root / "masked"), "--scale_factor", str(MASK_RES / 800),
            "--translation", *map(str, T), "--rotation", *map(str, R.ravel()),
            "--scale", str(S), "--tile_capacity", str(CAPACITY), "--device", "cpu"]
    info = premask.main(args)
    return root, args, info


def test_premask_matches_jax_coverage(scene, premasked):
    root, _, info = premasked
    aligned = load_mesh(root / "scan_adjusted.ply")
    np.testing.assert_allclose(aligned["vertices"], two_spheres()[0], atol=1e-5)
    jcams = [JDataset(scene, scale_factor=MASK_RES / 800).get_split(s)[0]
             for s in ("train", "val", "test")]
    jcams = JCameras.cat(jcams)
    assert info["views"] == jcams.shape[0] == 2 * N_TRAIN + N_TEST
    assert info["max_tile_triangles"] <= info["tile_capacity"] == CAPACITY

    @jax.jit
    def coverage(c2w, fx, fy, cx, cy):
        cam = JCameras(c2w=c2w, fx=fx, fy=fy, cx=cx, cy=cy, width=MASK_RES, height=MASK_RES,
                       near=jcams.near, far=jcams.far)
        mesh = JTriangleMesh(vertices=jnp.asarray(aligned["vertices"]),
                             indices=jnp.asarray(aligned["indices"], jnp.int32))
        return jax_rasterize_mesh(mesh, cam, tile_capacity=CAPACITY).tri_id >= 0

    ds = Dataset(root / "masked", device="cpu")
    assert type(ds.dataparser).__name__ == "RFMaskedRealDataparser"
    _, masked, _ = ds.get_split("train")
    _, scene_imgs, _ = Dataset(scene, scale_factor=MASK_RES / 800, device="cpu").get_split("train")
    for i in range(2):
        want = np.asarray(coverage(jcams.c2w[i], jcams.fx[i], jcams.fy[i], jcams.cx[i],
                                   jcams.cy[i]))
        from PIL import Image

        alpha = np.asarray(Image.open(root / "masked" / "images" / f"{i:04d}.png"))[..., 3]
        np.testing.assert_array_equal(alpha > 127, want, err_msg=f"view {i}")
    for i in range(N_TRAIN):   # the mesh's silhouette against the scene's alpha
        got, gt_a = masked[i][..., 3] > 0.5, scene_imgs[i][..., 3] > 0.5
        assert (got & gt_a).sum() / (got | gt_a).sum() >= 0.97, i


def test_premask_cameras_have_the_jax_layout(scene, premasked):
    root, _, info = premasked
    got = torch.load(root / "masked" / "cameras.pkl")
    cams = JCameras.cat([JDataset(scene, scale_factor=MASK_RES / 800).get_split(s)[0]
                         for s in ("train", "val", "test")])
    n = cams.shape[0]
    # the JAX script's dictionary (scripts/premask.py:88-101)
    want = {
        "c2w": torch.from_numpy(np.array(cams.c2w)),
        "fx": torch.from_numpy(np.array(cams.fx)), "fy": torch.from_numpy(np.array(cams.fy)),
        "cx": torch.from_numpy(np.array(cams.cx)), "cy": torch.from_numpy(np.array(cams.cy)),
        "width": torch.full((n,), cams.width, dtype=torch.long),
        "height": torch.full((n,), cams.height, dtype=torch.long),
        "near": torch.full((n,), float(cams.near)), "far": torch.full((n,), float(cams.far)),
    }
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6, err_msg=k)


def test_premask_raises_past_the_tile_capacity(premasked, tmp_path):
    _, args, _ = premasked
    args = [a if a != str(premasked[0] / "masked") else str(tmp_path / "out") for a in args]
    with pytest.raises(ValueError, match="--tile_capacity"):
        premask.main(args + ["--tile_capacity", "256"])   # the JAX script's default


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """run_pipeline at 2 / 1 / 1 steps of one camera on the stage-3 task
    tests' fixture."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("pipeline")
    scene = root / "s4r" / "scene"
    write_s4r_scene(scene, {"train": 4, "test": 2}, 32, "cpu")
    cwd = os.getcwd()
    os.chdir(root)   # outputs/ under the temporary directory
    try:
        out = run_pipeline.main([
            "--scene", "tiny", "--dataset_path", str(scene), "--resolution", "8",
            "--scene_scale", "1.0", "--light_resolution", "16", "--s1-steps", "2",
            "--s2-steps", "1", "--s3-steps", "1", "--batch", "1",
            "--scale_factor", str(32 / 800), "--triplane_resolution", "32",
            "--max_render_faces", "1024", "--num_samples_x", "2", "--eval", "reliteval",
            "--device", "cpu"])
    finally:
        os.chdir(cwd)
    return scene, root / out["output_dir"], out


def test_pipeline_runs_and_evaluates(pipeline):
    _, run, out = pipeline
    for f in ("log.txt", "stage1/export.npz", "stage2/export.npz", "stage3/export.npz",
              "ckpts/1.pt"):
        assert (run / f).exists(), f
    for s in ("s1", "s2", "s3"):
        assert out[f"{s}_nonfinite_grads"] == 0 and np.isfinite(out[f"{s}_loss"])
    assert out["s3_mesh_tile_fill"] <= 1 and out["s3_mesh_pair_fill"] <= 1
    assert np.isfinite(out["eval"]["nvs"]["psnr"]) and np.isfinite(out["eval"]["albedo"]["psnr"])
    assert "eval:" in (run / "log.txt").read_text()


def _layout(tree, prefix=""):
    """{key path: (shape, dtype)} of an export's arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_layout(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (np.shape(v), np.asarray(v).dtype)
    return out


def test_pipeline_exports_are_the_stage_tasks(pipeline):
    """Each stage task built from the previous stage's pipeline export writes
    an export of the pipeline's layout (and the stage-1 task one of the
    pipeline's stage 1)."""
    scene, run, _ = pipeline
    kw = dict(dataset_path=scene, scene_scale=1.0, resolution=8, device="cpu")
    dataset = Dataset(scene, scale_factor=32 / 800, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tasks = {
        "stage1": tt.GeoSplatTrainTask(light_resolution=16, triplane_resolution=32,
                                       max_render_faces=1024, **kw),
        "stage2": tt.GeoSplatMCTrainTask(load=run / "stage1", max_render_faces=1024,
                                         num_samples_x=2, **kw),
        "stage3": tt.GeoSplatDeferTrainTask(load=run / "stage2", num_samples_x=2, **kw),
    }
    for stage, task in tasks.items():
        model, _ = task.build(dataset, gen)
        assert _layout(load_export(run / stage)) == _layout(task.export(model)), stage
    jax_side = jio.load_export(run / "stage3" / "export.npz")
    assert _layout(jax_side).keys() == _layout(load_export(run / "stage3")).keys()
