"""Port parity: the stage-1 product path — Dataset on a Blender-layout
scene, the stage_io export format in both directions, and the train task's
run, checkpoint, resume and export, which the JAX package's stage-2 task
loads. Everything runs on the CPU at resolution 10, a 32-texel triplane and
32x32 images.

Tolerances: none. The dataset's cameras, images and batch order, the
export files' keys and arrays, and a resumed run against an uninterrupted
one are all compared for equality."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.data.dataset import Dataset as JDataset
from geosplatting_tpu.engine import stage_io as jio
from geosplatting_tpu.engine.train_task import GeoSplatMCTrainTask
from geosplatting_tpu_torch.data.dataset import Dataset, recognize_dataparser
from geosplatting_tpu_torch.engine import stage_io as tio
from geosplatting_tpu_torch.engine.train_task import GeoSplatTrainTask
from geosplatting_tpu_torch.utils.config import (
    dump_dataclass_as_str, load_dataclass, run_task_group,
)

from .torch_parity import n, one_torch_thread  # noqa: F401
from .torch_scenes import write_sphere_scene

RES = 32
SF = RES / 800.0
COUNTS = {"train": 6, "test": 2, "val": 2}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    write_sphere_scene(root, COUNTS, RES, "cpu")
    return root


def test_dataset_matches_jax(scene):
    dj = JDataset(scene, scale_factor=SF)
    dt = Dataset(scene, scale_factor=SF, device="cpu")
    for split in COUNTS:
        cj, ij, _ = dj.get_split(split)
        ct, it, _ = dt.get_split(split)
        for f in ("c2w", "fx", "fy", "cx", "cy"):
            np.testing.assert_array_equal(n(getattr(ct, f)), np.asarray(getattr(cj, f)), f)
        assert (ct.width, ct.height, ct.near, ct.far) == (cj.width, cj.height, cj.near, cj.far)
        np.testing.assert_array_equal(it, ij)
        assert dt.get_size(split) == dj.get_size(split) == COUNTS[split]
    # batches of 4 from 6 views: the iterators draw a new permutation every
    # other batch
    bj = dj.iter_batches("train", 4, seed=3)
    bt = dt.iter_batches("train", 4, seed=3)
    for _ in range(5):
        cams_j, img_j, idx_j = next(bj)
        cams_t, img_t, idx_t = next(bt)
        np.testing.assert_array_equal(idx_t, idx_j)
        np.testing.assert_array_equal(n(img_t), np.asarray(img_j))
        np.testing.assert_array_equal(n(cams_t.c2w), np.asarray(cams_j.c2w))
        assert img_t.dtype == torch.float32


def test_unported_layouts_are_named(tmp_path):
    # StanfordORB (blender_LDR/<scene> beside ground_truth/<scene>) comes
    # before Blender in the recognition order: its own parser reads it
    orb = tmp_path / "blender_LDR" / "scene"
    for d in ("train", "train_mask", "test", "test_mask"):
        (orb / d).mkdir(parents=True)
    for split in ("train", "test", "novel"):
        (orb / f"transforms_{split}.json").write_text('{"frames": [{"file_path": "x"}]}')
    (tmp_path / "ground_truth" / "scene").mkdir(parents=True)
    assert type(recognize_dataparser(orb)).__name__ == "StanfordORBDataparser"
    with pytest.raises(ValueError, match="no dataparser"):
        Dataset(tmp_path, device="cpu")


def test_stage_io_reads_across_packages(tmp_path):
    def export(arr):
        return {"a": arr(np.arange(5.0, dtype=np.float32)),
                "nested": {"w": arr(np.ones((2, 3), np.float32)),
                           "deep": {"b": arr(np.zeros(2, np.float32))}, "empty": {}},
                "none_field": None, "scalar": 1.5, "count": 3}

    tio.save_export(tmp_path / "t.npz", export(torch.from_numpy))
    jio.save_export(tmp_path / "j.npz", export(jnp.asarray))
    ft, fj = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(ft.files) == sorted(fj.files)
    for k in ft.files:
        assert ft[k].dtype == fj[k].dtype, k
        np.testing.assert_array_equal(ft[k], fj[k])
    for back in (jio.load_export(tmp_path / "t.npz"), tio.load_export(tmp_path / "j.npz")):
        assert back["none_field"] is None and back["nested"]["empty"] == {}
        np.testing.assert_array_equal(np.asarray(back["a"]), np.arange(5.0))
        np.testing.assert_array_equal(np.asarray(back["nested"]["deep"]["b"]), np.zeros(2))
        assert float(back["scalar"]) == 1.5 and int(back["count"]) == 3
    assert isinstance(tio.load_export(tmp_path / "j.npz")["a"], np.ndarray)
    assert tio.find_export(tmp_path / "t.npz") == tmp_path / "t.npz"


def s1_task(root, steps):
    return GeoSplatTrainTask(
        dataset_path=root, experiment_name="t-s1", seed=0, num_steps=steps, batch_size=2,
        num_steps_per_save=2, num_steps_per_val=2, num_val_images=1, scale_factor=SF,
        resolution=10, light_resolution=32, scene_scale=1.0, triplane_resolution=32,
        device="cpu",
    )


def test_run_resume_export_and_jax_stage2_loads(scene, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # outputs/ under tmp
    out = s1_task(scene, 2).run()
    run_dir = Path(out["output_dir"])
    for f in ("task.py", "export.npz", "log.txt", "ckpts/2.pt"):
        assert (run_dir / f).exists(), f
    assert np.isfinite(out["val_psnr"]) and np.isfinite(out["loss"])
    assert list((run_dir / "dump" / "val").glob("*.png"))
    assert "geosplatting_tpu_torch.engine.train_task.GeoSplatTrainTask(" in (
        run_dir / "task.py").read_text()

    # resume from the dumped config and the step-2 checkpoint to 4 steps
    task2 = dataclasses.replace(load_dataclass(run_dir / "task.py"), num_steps=4)
    out2 = task2.run(resume_dir=run_dir)
    assert Path(out2["output_dir"]) == run_dir
    log = (run_dir / "log.txt").read_text()
    assert "resumed from step 2" in log and "step 4:" in log
    # the resumed run is the uninterrupted run: same batches, noise and state
    straight = Path(dataclasses.replace(s1_task(scene, 4), experiment_name="t-s1-whole")
                    .run()["output_dir"])
    resumed, whole = (torch.load(d / "ckpts" / "4.pt") for d in (run_dir, straight))
    for k, v in whole["model"].items():
        assert torch.equal(resumed["model"][k], v), k
    assert torch.equal(resumed["generator"], whole["generator"])

    # the JAX stage-2 task initialises from the port's stage-1 export
    export = tio.load_export(run_dir)
    mc = GeoSplatMCTrainTask(dataset_path=scene, load=run_dir, resolution=10, scene_scale=1.0,
                             scale_factor=SF, batch_size=2)
    model, trainer = mc.build(None, None)
    state = mc.init_state(model, trainer, jax.random.key(0))
    p = state["params"]
    for k in ("sdf", "deform", "weights", "exposure"):
        np.testing.assert_array_equal(np.asarray(p[k]), export[k])
    np.testing.assert_array_equal(np.asarray(p["field"]["planes"]), export["ks_enc"]["planes"])
    for k, v in export["ks_enc"]["ks"].items():
        np.testing.assert_array_equal(np.asarray(p["field"]["ks"][k]), v)
    assert np.isfinite(np.asarray(p["latlng"])).all()
    np.testing.assert_array_equal(export["initial_guess"], [-3.0, -3.0])
    assert float(export["geom_scale"]) == 1.0 and int(export["resolution"]) == 10


def test_cli_resume_subcommand(scene, tmp_path, monkeypatch):
    """The CLI's preset table and resume subcommand (scripts/train_geosplat.py)."""
    from geosplatting_tpu_torch.scripts.train_geosplat import TASKS

    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(GeoSplatTrainTask, "run",
                        lambda self, resume_dir=None, resume_step=None:
                        calls.append((self, resume_dir, resume_step)) or {})
    run_task_group(TASKS, ["custom", "--dataset_path", str(scene), "--num_steps", "4",
                           "--scale_factor", "0.04", "--device", "cpu"])
    task, _, _ = calls[-1]
    assert (task.num_steps, task.scale_factor, task.device) == (4, 0.04, "cpu")
    assert task.dataset_path == Path(scene)
    run_dir = tmp_path / "outputs" / "geosplat" / "x"
    run_dir.mkdir(parents=True)
    (run_dir / "task.py").write_text(dump_dataclass_as_str(task))
    run_task_group(TASKS, ["resume", "--dir", str(run_dir), "--step", "2"])
    back, resume_dir, resume_step = calls[-1]
    assert back == task and resume_dir == run_dir and resume_step == 2
    assert TASKS["s4r-twosphere"].pairs_budget == 1_600_000
