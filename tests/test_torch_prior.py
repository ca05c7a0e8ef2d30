"""Port parity: the mesh-prior variant (GeoSplatterPrior, its trainer, task
and CLI) against the JAX package on the CPU.

A jittered UV sphere of 60 faces (360 Gaussians) as the prior mesh, a
16-texel shared field with the occ head, 2 x 2 Monte-Carlo sample steps with
the 16^3 visibility grid and denoising, two cameras at 24x24 (the task:
32x32). JAX renders
through its pairs backend with the Pallas kernels in interpret mode; the port
through its kernels' plain versions. The draws come from jax.random and
are handed to both (tests/torch_parity.py replays the key splits). ONE
compiled JAX per-camera program gives the images and the gradients of the
trainer step (train_step_accum's contract: per-camera gradients summed,
scaled by 1/B).

Tolerances, those of tests/test_torch_stage2.py: images atol 1e-3 (cutoff
flips), loss terms rtol 1e-4, gradient groups close_grads (1 % in L2, 2 %
of the largest entry). The first Adam step moves every entry by the lr
against its gradient's sign: the updated parameters agree exactly where
the JAX gradient is clear of zero (1e-3 of its group's largest entry) and
within 2 lr elsewhere. The task's resume and its export against the
checkpoint are held to equality, the export against the JAX
``export_model`` to atol 1e-5."""
import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_sphere_scene
from geosplatting_tpu.engine import stage_io as jstage_io
from geosplatting_tpu.graphics import images as jimages
from geosplatting_tpu.graphics.cameras import Cameras as JCameras
from geosplatting_tpu.graphics.mesh import TriangleMesh as JMesh
from geosplatting_tpu.models.encodings import TriplaneEncoding as JTriplane
from geosplatting_tpu.models.geosplat import SharedField as JSharedField
from geosplatting_tpu.models.geosplat_prior import GeoSplatterPrior as JPrior
from geosplatting_tpu.models.geosplat_prior import z_up_to_y_up as jz_up_to_y_up
from geosplatting_tpu.ops import rasterize_pairs as jrp
from geosplatting_tpu.ops.ssim import ssim_l1_loss as jssim_l1_loss
from geosplatting_tpu.train.geosplat_prior_trainer import GeoSplatPriorTrainer as JTrainer
from geosplatting_tpu.train.geosplat_prior_trainer import (
    GeoSplatPriorTrainerConfig as JConfig,
)
from geosplatting_tpu_torch.convert import params_from_numpy, params_to_numpy
from geosplatting_tpu_torch.engine import stage_io as tstage_io
from geosplatting_tpu_torch.engine.train_task import GeoSplatPriorTrainTask
from geosplatting_tpu_torch.graphics.mesh import TriangleMesh
from geosplatting_tpu_torch.graphics.mesh_io import save_mesh
from geosplatting_tpu_torch.models.geosplat_prior import GeoSplatterPrior, z_up_to_y_up
from geosplatting_tpu_torch.train.geosplat_prior_trainer import (
    GeoSplatPriorTrainer, GeoSplatPriorTrainerConfig,
)
from geosplatting_tpu_torch.utils.config import load_dataclass, run_task_group

from .test_torch_geosplat import close_grads
from .test_torch_hashgrid import sphere_mesh
from .test_torch_trainer import sphere_gt
from .torch_parity import (  # noqa: F401
    cameras_from_jax, jax_prior_step_draws, jax_shade_draws, n, one_torch_thread, shade_draws, t,
)

W = H = 24
TRI = 16
CFG = dict(scale=1.0, num_samples_x=2, visibility_resolution=16)


@pytest.fixture(scope="module", autouse=True)
def jax_pairs_interpret():
    old = jrp._INTERPRET
    jrp._INTERPRET = True
    yield
    jrp._INTERPRET = old


def base_mesh():
    v, f, _ = sphere_mesh()
    return v, f


def jax_model(**kw):
    field = JSharedField(trunk=JTriplane(resolution=TRI, num_components=32, init_scale=0.03),
                         with_occ=True)
    return JPrior(field=field, backend="pairs", **CFG, **kw)


def torch_model(params, **kw):
    v, f = base_mesh()
    m = GeoSplatterPrior(TriangleMesh(vertices=t(v), indices=t(f, torch.long)),
                         triplane_resolution=TRI, device="cpu", **CFG, **kw)
    m.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return m


def jax_params(mj, seed=11):
    """Initial JAX parameters off their symmetric zeros: a small random
    deform and a smooth, non-grey light."""
    v, f = base_mesh()
    params = jax.tree.map(np.asarray, jax.jit(lambda k: mj.init(
        JMesh(vertices=jnp.asarray(v), indices=jnp.asarray(f)), k))(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    params["deform"] = (rng.normal(size=params["deform"].shape) * 0.01).astype(np.float32)
    i, j, c = np.meshgrid(*(np.arange(k) for k in params["latlng"].shape), indexing="ij")
    params["latlng"] = (0.4 + 0.3 * i / 256 + 0.1 * np.cos(j / 40.0) + 0.1 * c).astype(np.float32)
    if "kdks" in params:
        params["kdks"] = rng.normal(size=params["kdks"].shape).astype(np.float32)
        params["zs"] = rng.normal(size=params["zs"].shape).astype(np.float32)
    return params


def deformed(params):
    v, f = base_mesh()
    return JMesh(vertices=jnp.asarray(v) + jnp.asarray(params["deform"]), indices=jnp.asarray(f))


def jcams():
    return JCameras.from_orbit(center=jnp.zeros(3), radius=2.0, elevation_degrees=20.0,
                               num_samples=2, width=W, height=H)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX trainer's step as train_step_accum computes it, keeping each
    camera's image (the per-camera loss is geosplat_prior_trainer's
    _local_loss, line for line), and the updated parameters."""
    mj = jax_model()
    params = jax_params(mj)
    cams = jcams()
    gt = sphere_gt(cams)
    trainer_j = JTrainer(JConfig(batch_size=2), mj)
    c = trainer_j.config
    d = jax_prior_step_draws(jax.random.key(5), gt.shape, deformed(params), CFG["num_samples_x"])
    rw = trainer_j._rw()
    v, f = base_mesh()
    bm = JMesh(vertices=jnp.asarray(v), indices=jnp.asarray(f))

    def cam_loss(p, cam, gt_i, bg, sk):
        rgba, reg, aux = mj.render(p, bm, cam, d["k_render"], reg_weights=rw,
                                   kd_perturb_std=c.kd_perturb_std,
                                   ks_perturb_std=c.ks_perturb_std, shade_keys=sk)
        mask = gt_i[..., 3:]
        img1 = rgba[..., :3] + (1 - rgba[..., 3:]) * bg
        img2 = jimages.srgb2rgb(gt_i[..., :3]) * mask + (1 - mask) * bg
        loss = jssim_l1_loss(img1, img2) + 5.0 * jnp.mean((mask - rgba[..., 3:]) ** 2)
        return loss + reg, ((loss, reg), aux, rgba)

    grad_fn = jax.jit(jax.grad(cam_loss, has_aux=True))
    grads, sums, rgbas, aux = None, np.zeros(2, np.float32), [], None
    for i in range(2):
        cam_i, gt_i, bg_i, sk_i = trainer_j._slice_cam(
            cams, jnp.asarray(gt), jnp.asarray(d["background"]), d["shade_keys"],
            jnp.asarray(i, jnp.int32))
        g_i, (parts, a_i, rgba_i) = jax.device_get(grad_fn(params, cam_i, gt_i, bg_i, sk_i))
        rgbas.append(rgba_i[0])
        sums += np.asarray(parts, np.float32)
        grads = g_i if grads is None else jax.tree.map(np.add, grads, g_i)
        aux = a_i if aux is None else jax.tree.map(np.maximum, aux, a_i)
    inv = np.float32(0.5)
    grads = jax.tree.map(lambda g: g * inv, grads)
    state, metrics = jax.device_get(jax.jit(lambda p, g, l, r, a: trainer_j._apply_grads(
        trainer_j.init_state(p), g, l, r, a))(params, grads, *(sums * inv), aux))
    return {"params": params, "gt": gt, "draws": d, "rw": {k: float(v) for k, v in rw.items()},
            "groups": trainer_j._groups(grads), "metrics": metrics, "rgba": np.stack(rgbas),
            "aux": aux, "new_params": state["params"], "reg": float(sums[1] * inv)}


def port_draws(d):
    return dict(jitter_noise=t(d["jitter"]),
                surface_draws=(t(d["surface"][0], torch.long), t(d["surface"][1])),
                draws=[shade_draws(x) for x in d["draws"]])


def test_render_matches_jax(jax_ref):
    """Both cameras in one call of the port's render (jitter smoothing, the
    shared field) against the JAX per-camera renders, with the trainer's
    draws."""
    ref = jax_ref
    mt = torch_model(ref["params"])
    with torch.no_grad():
        rgba, reg, aux = mt.render(cameras_from_jax(jcams()), reg_weights=ref["rw"],
                                   **port_draws(ref["draws"]))
    np.testing.assert_allclose(n(rgba), ref["rgba"], atol=1e-3)
    np.testing.assert_allclose(float(reg), ref["reg"], rtol=1e-4)
    for k in ("num_gaussians", "total_pairs", "max_pairs"):
        assert int(aux[k]) == int(ref["aux"][k]), k
    assert float(rgba[..., 3].max()) > 0.5 and int(aux["num_gaussians"]) == 360


def test_direct_render_matches_jax():
    """smooth_type "direct": kd / ks from the kdks parameters, the offsets
    scaled by sigmoid(zs), no jitter terms; one camera, no shadows."""
    kw = dict(smooth_type="direct", shadow_scale=0.0)
    mj = jax_model(**kw)
    params = jax_params(mj, seed=12)
    cams = jcams()[:1]
    v, f = base_mesh()
    bm = JMesh(vertices=jnp.asarray(v), indices=jnp.asarray(f))
    sk = jax.random.split(jax.random.key(13), 1)
    rgba_j, reg_j, _ = jax.jit(lambda p: mj.render(p, bm, cams, jax.random.key(14),
                                                   shade_keys=sk))(params)
    mt = torch_model(params, **kw)
    assert tuple(mt.kdks.shape) == (360, 5)
    with torch.no_grad():
        rgba_t, reg_t, _ = mt.render(cameras_from_jax(cams),
                                     draws=[shade_draws(jax_shade_draws(sk[0], 360, 2))])
    np.testing.assert_allclose(n(rgba_t), np.asarray(rgba_j), atol=1e-3)
    np.testing.assert_allclose(float(reg_t), float(reg_j), rtol=1e-4)
    np.testing.assert_allclose(n(z_up_to_y_up(t(v))), np.asarray(jz_up_to_y_up(v)), atol=1e-7)


def test_train_step_matches_jax(jax_ref):
    """One step: loss, reg, the metrics, every group's gradient before Adam
    and the parameters after it."""
    ref = jax_ref
    mt = torch_model(ref["params"])
    trainer_t = GeoSplatPriorTrainer(GeoSplatPriorTrainerConfig(batch_size=2), mt)
    grads = {}
    orig = trainer_t.optimizers.step

    def keep_then_step():
        grads.update({name: [p.grad.clone() for p in ps]
                      for name, ps in trainer_t.param_groups().items()})
        orig()

    trainer_t.optimizers.step = keep_then_step
    metrics = trainer_t.train_step(cameras_from_jax(jcams()), t(ref["gt"]),
                                   background=t(ref["draws"]["background"]),
                                   **port_draws(ref["draws"]))
    mj = ref["metrics"]
    assert int(metrics["nonfinite_grads"]) == int(mj["nonfinite_grads"]) == 0
    for k in ("loss", "reg"):
        np.testing.assert_allclose(float(metrics[k]), float(mj[k]), rtol=1e-4, err_msg=k)
    assert int(metrics["num_gaussians"]) == int(mj["num_gaussians"])
    np.testing.assert_allclose(float(metrics["pair_fill"]), float(mj["pair_fill"]), rtol=1e-6)
    assert sorted(grads) == sorted(ref["groups"])
    lrs = {g["name"]: g["lr"] for g in trainer_t.optimizers.adam.param_groups}
    new = params_to_numpy(mt.state_dict())
    new_j = params_to_numpy(params_from_numpy(jax.tree.map(np.asarray, ref["new_params"])))
    old = params_to_numpy(params_from_numpy(ref["params"]))
    names = {"deform": ["deform"], "exposure": ["exposure"], "light": ["latlng"]}
    for name, ps in grads.items():
        leaves_j = jax.tree_util.tree_leaves(ref["groups"][name])
        assert len(leaves_j) == len(ps), name
        for gj, g in zip(leaves_j, ps):
            # the light's gradient is taken x64 before Adam in both
            close_grads(name, n(g) / (64.0 if name == "light" else 1.0), np.asarray(gj))
    for name, keys in names.items():
        gj = np.asarray(ref["groups"][name]) * (64.0 if name == "light" else 1.0)
        for k in keys:
            clear = np.abs(gj) > 1e-3 * np.abs(gj).max()
            np.testing.assert_allclose(new[k][clear], new_j[k][clear], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
            assert np.abs(new[k] - new_j[k]).max() <= 2.001 * lrs[name] + 1e-6, k
            assert not np.array_equal(new[k], old[k]), k
    for head in ("kd", "ks", "z", "occ", "planes"):
        a = jax.tree_util.tree_leaves(new["field"][head])
        b = jax.tree_util.tree_leaves(new_j["field"][head])
        for x, y in zip(a, b):
            assert np.abs(x - y).max() <= 2.001 * lrs[head] + 1e-6, head
            assert np.mean(np.abs(x - y) > 1e-6) < 0.02, head


# --- the task and the CLI ------------------------------------------------------------

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
