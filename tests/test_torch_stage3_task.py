"""Port parity: the eval.sh chain through the port's CLIs on the CPU — stage
1, stage 2 and stage 3 with their s4r-twosphere presets (cut to resolution
10, 32x32 images and 2 steps by flag overrides) and reliteval — on a tiny
Syn4Relight-layout scene written by ``chip_smoke.write_s4r_scene``; the
stage-3 run's resume, its export against its checkpoint, the clamps of its
export, and the hand-offs across packages: the JAX ``load_export`` reads
the port's stage-3 export key by key, and the port's stage 3 starts from a
stage-2 export written by the JAX ``save_export``.

Tolerances: none. Files, exports and checkpoints are compared for
equality; kd and latlng_hue must lie in float32 [0.01, 0.99]."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import write_s4r_scene
from geosplatting_tpu.engine import stage_io as jio
from geosplatting_tpu_torch.convert import params_to_numpy
from geosplatting_tpu_torch.data.dataset import Dataset
from geosplatting_tpu_torch.engine import stage_io as tio
from geosplatting_tpu_torch.engine.train_task import GeoSplatDeferTrainTask
from geosplatting_tpu_torch.scripts import train_geosplat as cli1
from geosplatting_tpu_torch.scripts import train_geosplat_defer as cli3
from geosplatting_tpu_torch.scripts import train_geosplat_mc as cli2
from geosplatting_tpu_torch.utils.config import run_task_group

from .torch_parity import one_torch_thread  # noqa: F401

SF = ["--scale_factor", str(32 / 800)]
TINY = ["--resolution", "10", "--device", "cpu", "--batch_size", "2", "--num_val_images", "1",
        *SF]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """stage 1 -> stage 2 -> stage 3 (2 steps, then a resume to 3) ->
    reliteval, each through its CLI's s4r-twosphere preset or subcommand."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("chain")
    scene = root / "s4r" / "scene"
    write_s4r_scene(scene, {"train": 4, "test": 2}, 32, "cpu")
    cwd = os.getcwd()
    os.chdir(root)  # outputs/ under the temporary directory
    try:
        out1 = run_task_group(cli1.TASKS, [
            "s4r-twosphere", "--dataset_path", str(scene), *TINY, "--num_steps", "1",
            "--light_resolution", "16", "--max_render_faces", "1024",
            "--sdf_sphere_init", "0.45", "--triplane_resolution", "32"])
        out2 = run_task_group(cli2.TASKS, [
            "s4r-twosphere", "--dataset_path", str(scene), *TINY, "--num_steps", "1",
            "--num_samples_x", "2", "--max_render_faces", "1024", "--load", out1["output_dir"]])
        out3 = run_task_group(cli3.TASKS, [
            "s4r-twosphere", "--dataset_path", str(scene), *TINY, "--num_steps", "2",
            "--num_steps_per_save", "1", "--num_samples_x", "2", "--load", out2["output_dir"]])
        run3 = Path(out3["output_dir"]).resolve()
        task_py = (run3 / "task.py").read_text()
        (run3 / "task.py").write_text(task_py.replace("num_steps=2,", "num_steps=3,"))
        out3b = run_task_group(cli3.TASKS, ["resume", "--dir", str(run3)])
        results = run_task_group(cli3.TASKS, [
            "reliteval", "--dataset_path", str(scene), "--load", str(run3), "--device", "cpu",
            *SF])
    finally:
        os.chdir(cwd)
    return {"root": root, "scene": scene, "s2": Path(root / out2["output_dir"]), "run3": run3,
            "out3": out3, "out3b": out3b, "results": results}


def test_chain_runs_resumes_and_evaluates(chain):
    run3, out3 = chain["run3"], chain["out3"]
    for f in ("task.py", "export.npz", "log.txt", "ckpts/1.pt", "ckpts/2.pt", "ckpts/3.pt",
              "eval.json"):
        assert (run3 / f).exists(), f
    for out in (out3, chain["out3b"]):
        assert out["nonfinite_grads"] == 0 and np.isfinite(out["loss"])
        assert out["pair_fill"] <= 1 and out["mesh_tile_fill"] <= 1 and out["mesh_pair_fill"] <= 1
    log = (run3 / "log.txt").read_text()
    assert "resumed from step 2" in log and "step 3:" in log
    assert "GeoSplatDeferTrainTask(" in (run3 / "task.py").read_text()
    results = json.loads((run3 / "eval.json").read_text())
    assert results == chain["results"]
    assert sorted(results) == ["albedo", "albedo_scaling", "nvs", "relight/envmap12",
                               "relight/envmap6", "roughness_mse"]
    numbers = [v for r in results.values()
               for v in (r.values() if isinstance(r, dict) else r if isinstance(r, list) else [r])]
    assert all(np.isfinite(v) for v in numbers)


def test_export_matches_checkpoint_and_keeps_the_clamps(chain):
    run3 = chain["run3"]
    exported = tio.load_export(run3)
    params = params_to_numpy(torch.load(run3 / "ckpts" / "3.pt")["model"])
    assert sorted(exported) == ["geometry", "params"]
    flat = dict(_flatten(exported["params"]))
    assert sorted(flat) == sorted(dict(_flatten(params)))
    for k, v in _flatten(params):
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    s2 = tio.load_export(chain["s2"])
    for k, s2_key in (("mesh_v", "mc_vertices"), ("mesh_i", "mc_indices"),
                      ("mesh_mask", "mc_face_mask"), ("initial_guess", "initial_guess"),
                      ("sdf", "sdf")):
        np.testing.assert_array_equal(exported["geometry"][k], s2[s2_key], err_msg=k)
        assert exported["geometry"][k].dtype == s2[s2_key].dtype, k
    # float32(0.01) is 0.0099999998 < 0.01: the clamp's bound is the f32 one
    for k in ("kd", "latlng_hue"):
        v = exported["params"][k]
        assert v.dtype == np.float32 and v.min() >= np.float32(0.01), k
        assert v.max() <= np.float32(0.99), k
    assert exported["params"]["kd"].min() == np.float32(0.01)   # the padded rows' kd 0, clamped


def _flatten(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_exports_cross_packages(chain, tmp_path):
    """The JAX load_export reads the port's stage-3 export key by key; a
    stage-2 export re-written by the JAX save_export starts the port's
    stage 3 exactly as the port's own file does."""
    run3 = chain["run3"]
    ported = tio.load_export(run3)
    read_j = jio.load_export(run3)
    assert sorted(dict(_flatten(read_j))) == sorted(dict(_flatten(ported)))
    for k, v in _flatten(ported):
        got = dict(_flatten(read_j))[k]
        if v is None:
            assert got is None, k
        else:
            np.testing.assert_array_equal(np.asarray(got), v, err_msg=k)
            assert np.asarray(got).dtype == v.dtype, k

    s2 = tio.load_export(chain["s2"])
    jio.save_export(tmp_path / "jax_s2" / "export.npz", s2)
    models = []
    for load in (chain["s2"], tmp_path / "jax_s2"):
        task = GeoSplatDeferTrainTask(dataset_path=chain["scene"], load=load, resolution=10,
                                      scene_scale=1.0, device="cpu")
        model, _ = task.build(Dataset(chain["scene"], scale_factor=32 / 800, device="cpu"),
                              torch.Generator().manual_seed(0))
        models.append(model)
    for (k, a), (_, b) in zip(models[0].state_dict().items(), models[1].state_dict().items()):
        assert torch.equal(a, b), k
    for k in models[0].geometry:
        a, b = models[0].geometry[k], models[1].geometry[k]
        assert (a is None and b is None) or torch.equal(a, b), k
    with pytest.raises(ValueError, match="--load"):
        GeoSplatDeferTrainTask().build(None, None)


def test_cli_presets():
    s4r = cli3.TASKS["s4r-hotdog"]
    assert (s4r.resolution, s4r.scene_scale, s4r.num_steps, s4r.batch_size,
            s4r.pairs_budget) == (96, 0.8, 100, 8, 1_600_000)
    assert cli3.TASKS["s4r-twosphere"].scene_scale == 1.0
    assert cli3.TASKS["sb-ball"].resolution == 128 and "resume" in cli3.TASKS
    assert cli3.TASKS["nvseval"].skip_rlit and cli3.TASKS["nvseval"].skip_mat
    assert not cli3.TASKS["reliteval"].skip_rlit


def test_other_layouts_are_named(tmp_path):
    """A preset on a directory of no layout the port reads raises naming
    the path (StanfordORB, which once raised here, is read now)."""
    scene = tmp_path / "blender_LDR" / "scene"
    for d in ("train", "train_mask", "test", "test_mask"):
        (scene / d).mkdir(parents=True)
    with pytest.raises(ValueError, match="no dataparser recognizes"):
        run_task_group(cli3.TASKS, ["tsir-lego", "--dataset_path", str(scene), "--load", "x",
                                    "--device", "cpu"])
