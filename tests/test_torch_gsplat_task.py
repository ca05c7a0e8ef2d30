"""The port's vanilla-3DGS task (``GSplatTrainTask``) on the CPU: it runs on
a Blender-layout scene, resumes from a checkpoint (across densifications
too) to the same state as the uninterrupted run, exports its last
checkpoint's parameters, and the CLI carries the JAX package's preset
table. Also the loop's alarm on every budget fill a trainer reports.

500 Gaussians, SH degree 1, 32x32 images. Tolerances: none; a resumed
run, the export and the presets are compared for equality."""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from geosplatting_tpu_torch.engine.train_task import (
    PAIRS_PER_GAUSSIAN, PAIRS_PER_GAUSSIAN_2DGS, TILE_CAPACITY_2DGS, GeoSplatTrainTask,
    GSplatTrainTask,
)
from geosplatting_tpu_torch.engine.stage_io import load_export
from geosplatting_tpu_torch.scripts import train_gsplat
from geosplatting_tpu_torch.train import gsplat_trainer
from geosplatting_tpu_torch.utils.config import load_dataclass

from .torch_parity import one_torch_thread  # noqa: F401
from .torch_scenes import write_sphere_scene

ROOT = Path(__file__).resolve().parents[1]
RES = 32
SF = RES / 800.0
FIELDS = ("means", "scales", "quats", "colors", "opacities", "shs")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("gsplat_scene")
    write_sphere_scene(root, {"train": 2, "val": 1, "test": 1}, RES, "cpu")
    return root


@pytest.fixture
def quick_densify(monkeypatch):
    """Densify every 2 steps from step 6 (step % 20 > 2 train views + 2), reset
    the opacities at step 2, split or duplicate whatever moved."""
    cfg = functools.partial(gsplat_trainer.GSplatTrainerConfig, warmup_length=1,
                            refine_every=2, reset_alpha_every=10, densify_grad_thresh=1e-7)
    monkeypatch.setattr(gsplat_trainer, "GSplatTrainerConfig", cfg)


def task(scene, steps, name):
    return GSplatTrainTask(
        dataset_path=scene, experiment_name=name, seed=0, num_steps=steps, batch_size=1,
        num_steps_per_save=5, num_steps_per_val=5, num_val_images=1, scale_factor=SF,
        num_init_gaussians=500, sh_degree=1, device="cpu")


def test_task_runs_resumes_across_densification_and_exports(scene, tmp_path, monkeypatch,
                                                            quick_densify):
    monkeypatch.chdir(tmp_path)
    out = task(scene, 5, "gs").run()
    run_dir = Path(out["output_dir"])
    assert np.isfinite(out["loss"]) and np.isfinite(out["val_psnr"])
    assert 0 < out["pair_fill"] <= 1 and out["nonfinite_grads"] == 0
    assert int(out["num_gaussians"]) == 500     # densification starts at step 6
    assert list((run_dir / "dump" / "val").glob("*.png"))
    # resume from the step-5 checkpoint to 10 steps: steps 6 and 8 densify
    again = dataclasses.replace(load_dataclass(run_dir / "task.py"), num_steps=10)
    out2 = again.run(resume_dir=run_dir)
    log = (run_dir / "log.txt").read_text()
    assert "resumed from step 5" in log and "step 10:" in log
    whole = Path(task(scene, 10, "gs-whole").run()["output_dir"])
    resumed, straight = (torch.load(d / "ckpts" / "10.pt") for d in (run_dir, whole))
    n = resumed["params"]["means"].shape[0]
    assert n != 500 and int(out2["num_gaussians"]) != 500
    for k, v in straight["params"].items():
        assert torch.equal(resumed["params"][k], v), k
    for k in ("xys_grad_norm", "vis_counts"):
        assert torch.equal(resumed[k], straight[k]), k
        assert resumed[k].shape == (n,)
    for pid, st in straight["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(resumed["optimizer"]["state"][pid][k], st[k]), k
    assert torch.equal(resumed["generator"], straight["generator"])
    # the export is the last checkpoint's parameters, the JAX task's keys
    exported = load_export(run_dir)
    assert sorted(exported) == sorted(FIELDS)
    for k in FIELDS:
        np.testing.assert_array_equal(exported[k], resumed["params"][k].numpy())
    assert exported["shs"].shape == (n, 3, 3)


def test_cli_presets_match_jax():
    spec = importlib.util.spec_from_file_location("jax_train_gsplat",
                                                  ROOT / "scripts" / "train_gsplat.py")
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    assert list(train_gsplat.TASKS) == list(jcli.TASKS)
    shared = ("experiment_name", "num_steps", "batch_size", "num_steps_per_save",
              "num_steps_per_val", "num_init_gaussians", "sh_degree", "rasterize_mode")
    for name, preset in train_gsplat.TASKS.items():
        if name == "resume":
            continue
        for f in shared:
            assert getattr(preset, f) == getattr(jcli.TASKS[name], f), (name, f)
        is_2dgs = preset.rasterize_mode == "2dgs"
        assert preset.pairs_per_gaussian == (PAIRS_PER_GAUSSIAN_2DGS if is_2dgs
                                             else PAIRS_PER_GAUSSIAN)
        assert preset.tile_capacity == TILE_CAPACITY_2DGS


train_step = gsplat_trainer.GSplatTrainer.train_step


def test_2dgs_preset_raises(scene, tmp_path, monkeypatch):
    """The blender-2dgs preset runs: one CPU step with both regularisers on
    from step 0, a finite loss, fills within budget, the export."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(gsplat_trainer, "GSplatTrainerConfig", functools.partial(
        gsplat_trainer.GSplatTrainerConfig, normal_weight_start=0, distort_weight_start=0))
    preset = dataclasses.replace(train_gsplat.TASKS["blender-2dgs"], dataset_path=scene,
                                 device="cpu", scale_factor=SF, num_init_gaussians=100,
                                 num_steps=1, num_val_images=1)
    seen = []
    monkeypatch.setattr(gsplat_trainer.GSplatTrainer, "train_step", lambda self, *a, **kw: (
        seen.append(kw["reg_weights"]) or train_step(self, *a, **kw)))
    out = preset.run()
    assert seen == [(5e-2, 1e-2)]
    assert preset.tile_capacity == TILE_CAPACITY_2DGS and preset.rasterize_mode == "2dgs"
    assert np.isfinite(out["loss"]) and np.isfinite(out["val_psnr"])
    assert np.isfinite(out["normal_loss"]) and out["normal_loss"] > 0
    assert np.isfinite(out["distort_loss"]) and out["nonfinite_grads"] == 0
    assert 0 < out["pair_fill"] <= 1 and 0 < out["tile_fill"] <= 1
    exported = load_export(Path(out["output_dir"]))
    assert sorted(exported) == sorted(FIELDS) and exported["means"].shape == (100, 3)


def test_entry_points_default_to_cuda(monkeypatch):
    from geosplatting_tpu_torch.graphics.splats import Splats
    from geosplatting_tpu_torch.models.gsplatter import GSplatter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (GSplatter, lambda: Splats.random(8, sh_degree=0, random_scale=1.0),
                 lambda: GSplatTrainTask().run()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


@pytest.mark.parametrize("fill, words", [
    ("pair_fill", "pair budget EXCEEDED, farthest gaussians are being dropped"),
    ("face_fill", "render-face budget EXCEEDED"),
    ("mesh_tile_fill", "mesh tile capacity EXCEEDED"),
    ("mesh_pair_fill", "mesh pair budget EXCEEDED"),
    ("tile_fill", "tile capacity EXCEEDED"),
])
def test_loop_warns_on_every_fill(scene, tmp_path, monkeypatch, capsys, fill, words):
    """A fill past 1 in a step's metrics is logged and printed, whichever
    budget it measures; the other fills stay silent below 0.95."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(GeoSplatTrainTask, "build", lambda self, ds, g: (None, None))
    monkeypatch.setattr(GeoSplatTrainTask, "_validate", lambda *a: {})
    metrics = {"loss": 1.0, "pair_fill": 0.5, "face_fill": 0.5, fill: 1.25}
    monkeypatch.setattr(GeoSplatTrainTask, "step_fn", lambda *a: metrics)
    monkeypatch.setattr("geosplatting_tpu_torch.engine.train_task.save_checkpoint",
                        lambda *a: None)
    monkeypatch.setattr(GeoSplatTrainTask, "export", lambda self, model: None)
    out = GeoSplatTrainTask(dataset_path=scene, num_steps=1, batch_size=1, device="cpu",
                            scale_factor=SF).run()
    printed = capsys.readouterr().out
    assert f"WARNING step 1: {fill}=1.250 — {words}" in printed
    assert printed.count("WARNING") == 1
    assert words in (Path(out["output_dir"]) / "log.txt").read_text()
