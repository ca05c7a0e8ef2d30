"""Port parity: the mesh-prior task and CLI against the JAX package on the
CPU, with the model of tests/test_torch_prior.py (the jittered 60-face UV
sphere as the prior, a 16-texel shared field) on a Blender-layout sphere
scene at 32x32: the task's resume and its export against the checkpoint are
held to equality, the export against the JAX ``export_model`` to atol 1e-5
(op by op: it reads the field's planes on the host); the CLI's presets equal
the JAX script's."""
import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.engine import stage_io as jstage_io
from geosplatting_tpu.graphics.mesh import TriangleMesh as JMesh
from geosplatting_tpu_torch.convert import params_to_numpy
from geosplatting_tpu_torch.engine import stage_io as tstage_io
from geosplatting_tpu_torch.engine.train_task import GeoSplatPriorTrainTask
from geosplatting_tpu_torch.graphics.mesh import TriangleMesh
from geosplatting_tpu_torch.graphics.mesh_io import save_mesh
from geosplatting_tpu_torch.models.geosplat_prior import GeoSplatterPrior
from geosplatting_tpu_torch.utils.config import load_dataclass, run_task_group

from .test_torch_prior import TRI, base_mesh, jax_model
from .test_torch_prior import jax_pairs_interpret  # noqa: F401
from .torch_parity import one_torch_thread, t  # noqa: F401
from .torch_scenes import write_sphere_scene

TW = 32                 # the task's images: 800 / TW pixels replicated
SF = TW / 800.0


def prior_task(scene, mesh_path, steps, name="t-prior"):
    return GeoSplatPriorTrainTask(
        dataset_path=scene, mesh_path=mesh_path, experiment_name=name, seed=0,
        num_steps=steps, batch_size=2, num_steps_per_save=1, num_steps_per_val=2,
        num_val_images=1, scale_factor=SF, scene_scale=1.0, num_samples_x=2,
        triplane_resolution=TRI, device="cpu",
    )


@pytest.fixture(scope="module")
def task_runs(tmp_path_factory):
    """The prior task on a Blender-layout sphere scene with the UV-sphere
    prior as a binary PLY: 1 step, a resume to 2, and an uninterrupted
    2-step run."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("prior_task")
    write_sphere_scene(root / "scene", {"train": 4, "val": 1, "test": 1}, TW, "cpu")
    v, f = base_mesh()
    save_mesh(root / "prior.ply", v, f)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        out = prior_task(root / "scene", root / "prior.ply", 1).run()
        run_dir = Path(out["output_dir"]).resolve()
        resumed = dataclasses.replace(load_dataclass(run_dir / "task.py"), num_steps=2)
        out2 = resumed.run(resume_dir=run_dir)
        whole = Path(prior_task(root / "scene", root / "prior.ply", 2, "t-prior-whole")
                     .run()["output_dir"]).resolve()
    finally:
        os.chdir(cwd)
    return {"root": root, "run_dir": run_dir, "out": out, "out2": out2, "whole": whole}


def test_task_resumes_and_exports_like_jax(task_runs):
    run_dir = task_runs["run_dir"]
    for fname in ("task.py", "export.npz", "log.txt", "ckpts/1.pt", "ckpts/2.pt"):
        assert (run_dir / fname).exists(), fname
    out, out2 = task_runs["out"], task_runs["out2"]
    assert np.isfinite(out["val_psnr"]) and np.isfinite(out2["loss"])
    assert out["nonfinite_grads"] == 0 == out2["nonfinite_grads"]
    log = (run_dir / "log.txt").read_text()
    assert "resumed from step 1" in log and "step 2:" in log
    # the resumed run is the uninterrupted run: same batches, draws and state
    resumed, whole = (torch.load(d / "ckpts" / "2.pt") for d in (run_dir, task_runs["whole"]))
    for k, val in whole["model"].items():
        assert torch.equal(resumed["model"][k], val), k
    assert torch.equal(resumed["generator"], whole["generator"])
    # the export against the checkpoint, and against the JAX export_model of
    # the checkpoint's parameters, written and read by the JAX stage_io
    params = params_to_numpy(resumed["model"])
    exported = tstage_io.load_export(run_dir)
    np.testing.assert_array_equal(exported["latlng"], params["latlng"])
    np.testing.assert_array_equal(exported["exposure"], params["exposure"])
    for k, val in params["field"]["ks"].items():
        np.testing.assert_array_equal(exported["ks_enc"]["ks"][k], val)
    np.testing.assert_array_equal(exported["ks_enc"]["planes"], params["field"]["planes"])
    v, f = base_mesh()
    np.testing.assert_array_equal(exported["mc_vertices"], v + params["deform"])
    mj = jax_model()
    bm = JMesh(vertices=jnp.asarray(v), indices=jnp.asarray(f))
    want = mj.export_model(params, bm, jax.random.key(0))
    jstage_io.save_export(run_dir.parent / "jax_export.npz", want)
    fj, ft = np.load(run_dir.parent / "jax_export.npz"), np.load(run_dir / "export.npz")
    assert sorted(ft.files) == sorted(fj.files)
    for k in fj.files:
        assert (ft[k].shape, ft[k].dtype) == (fj[k].shape, fj[k].dtype), k
        if ft[k].dtype.kind == "f":
            np.testing.assert_allclose(ft[k], fj[k], atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    loaded = jstage_io.load_export(run_dir)
    assert loaded["sdf"] is None and loaded["mc_face_mask"] is None
    assert loaded["means"].shape == (360, 3)


def test_cli_presets_match_jax(tmp_path, monkeypatch):
    """The CLI's preset table equals the JAX script's, field by field, and
    --mesh_path reaches the task."""
    from geosplatting_tpu_torch.scripts.train_geosplat_prior import TASKS

    spec = importlib.util.spec_from_file_location(
        "jax_train_geosplat_prior",
        Path(__file__).resolve().parents[1] / "scripts" / "train_geosplat_prior.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    assert sorted(TASKS) == sorted(jmod.TASKS)
    for name, jtask in jmod.TASKS.items():
        ttask = TASKS[name]
        assert type(ttask).__name__ == type(jtask).__name__, name
        for fld in dataclasses.fields(jtask):
            if hasattr(ttask, fld.name):
                assert getattr(ttask, fld.name) == getattr(jtask, fld.name), (name, fld.name)
    shared = {f.name for f in dataclasses.fields(jmod.TASKS["object"])} & {
        f.name for f in dataclasses.fields(TASKS["object"])}
    assert {"mesh_path", "scene_scale", "tile_capacity", "num_samples_x", "backend",
            "num_steps", "batch_size"} <= shared
    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(GeoSplatPriorTrainTask, "run",
                        lambda self, resume_dir=None, resume_step=None: calls.append(self) or {})
    run_task_group(TASKS, ["object", "--dataset_path", "scene", "--mesh_path", "m.ply",
                           "--device", "cpu"])
    assert (calls[-1].mesh_path, calls[-1].batch_size) == (Path("m.ply"), 8)
    with pytest.raises(ValueError, match="pairs path"):
        dataclasses.replace(TASKS["custom"], backend="dense").build(None, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            v, f = base_mesh()
            GeoSplatterPrior(TriangleMesh(vertices=t(v), indices=t(f, torch.long)))
