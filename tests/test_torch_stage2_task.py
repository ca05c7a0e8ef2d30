"""Port parity: the stage-2 train task and the hand-offs around it, on the
CPU: ``GeoSplatMCTrainTask`` from a port stage-1 export (run, checkpoints,
resume, export), the stage-2 export against its checkpoint and against the
JAX package's export of the same parameters, the JAX stage-3 task starting
from the port's export, and the CLI. The configuration is that of
tests/test_torch_stage2.py at 32x32 images.

Tolerances: none but one. The resume, the export against the checkpoint and
the export files' keys, shapes and dtypes are held to equality; the JAX
export's Gaussian centres to 1e-5 (the two packages' FlexiCubes crossings
round differently)."""
import dataclasses
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chip_smoke import write_sphere_scene
from geosplatting_tpu.engine import stage_io as jio
from geosplatting_tpu.engine.train_task import GeoSplatDeferTrainTask
from geosplatting_tpu.models.geosplat_mc import GeoSplatterMC as JGeoSplatterMC
from geosplatting_tpu.models.geosplat_mc import compact_export as jcompact_export
from geosplatting_tpu_torch.convert import params_to_numpy
from geosplatting_tpu_torch.engine import stage_io as tio
from geosplatting_tpu_torch.engine.train_task import GeoSplatMCTrainTask
from geosplatting_tpu_torch.models.geosplat import GeoSplatter
from geosplatting_tpu_torch.models.geosplat_mc import export_stage1
from geosplatting_tpu_torch.utils.config import load_dataclass, run_task_group

from .test_torch_stage2 import CFG, FACES, TRI, W, jax_field
from .torch_parity import one_torch_thread  # noqa: F401

SF = W / 800.0


def s2_task(scene, load, steps, name="t-s2"):
    return GeoSplatMCTrainTask(
        dataset_path=scene, experiment_name=name, load=load, seed=0, num_steps=steps,
        batch_size=2, num_steps_per_save=1, num_steps_per_val=2, num_val_images=1,
        scale_factor=SF, resolution=10, scene_scale=1.0, num_samples_x=2,
        max_render_faces=FACES, device="cpu",
    )


@pytest.fixture(scope="module")
def task_runs(tmp_path_factory):
    """A port stage-1 run directory (a GeoSplatter's export.npz, written by
    the port's stage-1 export), then the stage-2 task: 1 step, a resume to
    2, and an uninterrupted 2-step run."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("stage2_task")
    write_sphere_scene(root / "scene", {"train": 4, "val": 1, "test": 1}, W, "cpu")
    s1 = GeoSplatter(resolution=10, light_resolution=16, scale=1.0, triplane_resolution=TRI,
                     generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        s1.sdf.copy_(torch.linalg.norm(s1.grid.base_vertices() - 0.03, dim=-1) - 0.45)
    tio.save_export(root / "s1" / "export.npz", export_stage1(s1))
    cwd = os.getcwd()
    os.chdir(root)  # outputs/ under the temporary directory
    try:
        out = s2_task(root / "scene", root / "s1", 1).run()
        run_dir = Path(out["output_dir"]).resolve()
        resumed = dataclasses.replace(load_dataclass(run_dir / "task.py"), num_steps=2)
        out2 = resumed.run(resume_dir=run_dir)
        whole = Path(s2_task(root / "scene", root / "s1", 2, "t-s2-whole").run()["output_dir"])
        whole = whole.resolve()
    finally:
        os.chdir(cwd)
    return {"root": root, "run_dir": run_dir, "out": out, "out2": out2, "whole": whole}


def test_task_runs_resumes_and_exports_its_checkpoint(task_runs):
    run_dir, out = task_runs["run_dir"], task_runs["out"]
    for f in ("task.py", "export.npz", "log.txt", "ckpts/1.pt", "ckpts/2.pt"):
        assert (run_dir / f).exists(), f
    assert np.isfinite(out["val_psnr"]) and np.isfinite(out["loss"])
    assert out["nonfinite_grads"] == 0 and task_runs["out2"]["nonfinite_grads"] == 0
    log = (run_dir / "log.txt").read_text()
    assert "resumed from step 1" in log and "step 2:" in log
    assert list((run_dir / "dump" / "val").glob("*.png"))
    # the resumed run is the uninterrupted run: same batches, draws and state
    resumed, whole = (torch.load(d / "ckpts" / "2.pt") for d in (run_dir, task_runs["whole"]))
    for k, v in whole["model"].items():
        assert torch.equal(resumed["model"][k], v), k
    assert torch.equal(resumed["generator"], whole["generator"])
    # the export against the last checkpoint, key by key
    exported = tio.load_export(run_dir)
    state = params_to_numpy(resumed["model"])
    want = {k: state[k] for k in ("sdf", "deform", "latlng", "exposure")}
    want["ks_enc/planes"] = want["occ_enc/planes"] = state["field"]["planes"]
    for head in ("ks", "occ"):
        for k, v in state["field"][head].items():
            want[f"{head}_enc/{head}/{k}"] = v
    for k, v in want.items():
        head, *rest = k.split("/")
        got = exported[head]
        for part in rest:
            got = got[part]
        np.testing.assert_array_equal(got, v, err_msg=k)
    mask = exported["gaussian_mask"]
    live = int(mask.sum())
    assert mask.shape[0] % 4096 == 0 and mask[:live].all() and not mask[live:].any()
    for k in ("means", "scales", "quats", "opacities", "normals", "kd", "ks", "occ",
              "mc_positions"):
        assert exported[k].shape[0] == mask.shape[0], k
    assert (exported["opacities"][live:] == -10).all() and (exported["opacities"][:live] > 0).all()


def test_jax_stage3_starts_from_the_port_export(task_runs):
    """The JAX stage-3 task builds its frozen geometry and initial state from
    the port's stage-2 export, whose file has the keys, shapes and dtypes of
    the JAX compact_export(export_model(...)) for the same parameters."""
    run_dir = task_runs["run_dir"]
    task3 = GeoSplatDeferTrainTask(dataset_path=task_runs["root"] / "scene", load=run_dir,
                                   resolution=10, scene_scale=1.0, scale_factor=SF,
                                   batch_size=2)
    model3, trainer3 = task3.build(None, None)
    state = task3.init_state(model3, trainer3, jax.random.key(0))
    export = tio.load_export(run_dir)
    _, geom = task3._geometry(model3)
    np.testing.assert_array_equal(np.asarray(geom["mesh_i"]), export["mc_indices"])
    np.testing.assert_array_equal(np.asarray(geom["sdf"]), export["sdf"])
    np.testing.assert_array_equal(np.asarray(state["params"]["means"]), export["means"])
    assert np.isfinite(np.asarray(state["params"]["latlng_value"])).all()

    params = params_to_numpy(torch.load(run_dir / "ckpts" / "2.pt")["model"])
    mj = JGeoSplatterMC(field=jax_field(True), backend="pairs", **CFG)
    # as the JAX task exports: one jitted program, compacted on the host
    want = jcompact_export(jax.device_get(
        jax.jit(mj.export_model)(params, jax.random.key(0))))
    jio.save_export(run_dir.parent / "jax_export.npz", want)
    fj, ft = np.load(run_dir.parent / "jax_export.npz"), np.load(run_dir / "export.npz")
    assert sorted(ft.files) == sorted(fj.files)
    for k in fj.files:
        assert (ft[k].shape, ft[k].dtype) == (fj[k].shape, fj[k].dtype), k
    np.testing.assert_array_equal(ft["gaussian_mask"], fj["gaussian_mask"])
    np.testing.assert_allclose(ft["means"], fj["means"], atol=1e-5)


def test_cli_presets_and_load(tmp_path, monkeypatch):
    """The CLI's preset table (scripts/train_geosplat_mc.py), --load, and
    the task's refusal to start without it."""
    from geosplatting_tpu_torch.scripts.train_geosplat_mc import TASKS

    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(GeoSplatMCTrainTask, "run",
                        lambda self, resume_dir=None, resume_step=None: calls.append(self) or {})
    run_task_group(TASKS, ["custom", "--dataset_path", "scene", "--load", "s1",
                           "--num_steps", "4", "--device", "cpu"])
    assert (calls[-1].load, calls[-1].num_steps, calls[-1].device) == (Path("s1"), 4, "cpu")
    s4r = TASKS["s4r-hotdog"]
    assert (s4r.resolution, s4r.scene_scale, s4r.batch_size, s4r.pairs_budget,
            s4r.max_render_faces, s4r.num_samples_x) == (96, 0.8, 8, 1_600_000, 1 << 17, 8)
    assert TASKS["sb-ball"].initial_guess == "specular" and "resume" in TASKS
    with pytest.raises(ValueError, match="--load"):
        GeoSplatMCTrainTask().build(None, None)


def test_stage2_entry_points_default_to_cuda():
    from geosplatting_tpu_torch.models.geosplat_mc import GeoSplatterMC

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GeoSplatterMC(resolution=4, triplane_resolution=4)
